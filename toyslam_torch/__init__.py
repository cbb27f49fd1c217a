"""toyslam_torch — the 2D LiDAR SLAM system of ``toyslam_tpu`` in PyTorch,
with its PCG hot loop as a hand-written CUDA kernel for Hopper GPUs.

The main path: the seeded host simulation and factor-graph build
(``sim.frontend``), then damped Gauss-Newton (``optimizer.GaussNewton``)
whose every iteration assembles the block-sparse normal equations
(``ops.schur``), eliminates the landmarks and solves the reduced pose system
with the fused PCG kernel (``ops.fused_pcg``, ``csrc/fused_pcg_chunk.cu``).
On CPU tensors the kernel's plain PyTorch version runs instead.

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
