"""toyslam_torch — the 2D LiDAR SLAM system of ``toyslam_tpu`` in PyTorch,
with its PCG hot loop as hand-written CUDA kernels for Hopper GPUs.

The main path: the seeded host simulation and factor-graph build
(``sim.frontend``), then damped Gauss-Newton (``optimizer.GaussNewton``)
whose every iteration assembles the block-sparse normal equations
(``ops.schur``), eliminates the landmarks and solves the reduced pose system
with the fused PCG kernel (``ops.fused_pcg``, ``csrc/fused_pcg_chunk.cu``).
The scale path: large synthetic graphs (``sim.synthetic``), whose landmark
fill is laid out as a banded tile stack (``ops.band_plan``) and streamed
by the band kernel (``csrc/band_fused_pcg_chunk.cu``).  On CPU tensors each
kernel's plain PyTorch version runs instead.  ``parallel`` runs the solves
sharded over processes on ``torch.distributed`` (edges, or state blocks).

This package imports neither JAX nor ``toyslam_tpu``.
"""

from toyslam_torch.config import (
    LidarConfig,
    NoiseConfig,
    OptimizerConfig,
    SimConfig,
    SlamConfig,
)
from toyslam_torch.models.graph import (
    FactorGraph2D,
    GraphBuilder2D,
    LandmarkEdges,
    OdomEdges,
)

__version__ = "0.1.0"
