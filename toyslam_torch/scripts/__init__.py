"""Experiment scripts of the port, run as ``python -m
toyslam_torch.scripts.<name>``: counterparts of the JAX package's
``scripts/`` that run a kernel outside the solver."""
