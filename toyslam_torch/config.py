"""Typed configuration, field for field the same as ``toyslam_tpu.config``.

The two packages share one configuration vocabulary so a run can be
described once and handed to either.  ``tests/test_torch_config.py`` pins
the field names, the defaults and the ``__post_init__`` errors against the
JAX package.  Options this package does not run yet keep their fields and
raise ``NotImplementedError`` where they are used (see ROADMAP.md §A).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class LidarConfig:
    """Simulated 2D LiDAR.  ``fov``/``ray_step`` are radians;
    ``ray_count = int(fov / ray_step)``."""

    fov: float = math.radians(120.0)
    ray_step: float = math.radians(6.0)
    range_std: float = 0.15
    max_range: float = 999999.0

    @property
    def ray_count(self) -> int:
        return int(self.fov / self.ray_step)


@dataclasses.dataclass(frozen=True)
class NoiseConfig:
    """Sensor noise model.

    ``variance_as_std`` reproduces the upstream simulator's quirk of passing
    variances where the sampler expects standard deviations; it is kept on
    by default so the simulated problem is the reference one.
    """

    lidar_std: float = 0.15
    position_std: float = 0.5
    orientation_std: float = math.radians(7.1)
    variance_as_std: bool = True

    def lidar_information_diag(self) -> tuple[float, float]:
        v = self.lidar_std**2
        return (1.0 / v, 1.0 / v)

    def odom_information_diag(self) -> tuple[float, float, float]:
        pv = self.position_std**2
        ov = self.orientation_std**2
        return (1.0 / pv, 1.0 / pv, 1.0 / ov)

    def sample_scales(self) -> tuple[float, float, float]:
        """(lidar, position, orientation) scales actually fed to the sampler."""
        if self.variance_as_std:
            return (
                self.lidar_std**2,
                self.position_std**2,
                self.orientation_std**2,
            )
        return (self.lidar_std, self.position_std, self.orientation_std)


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Scripted robot simulation."""

    robot_steps: int = 150
    start_xy: tuple[float, float] = (5.0, 15.0)
    start_theta: float = 0.0
    seed: int = 0
    lidar: LidarConfig = dataclasses.field(default_factory=LidarConfig)
    noise: NoiseConfig = dataclasses.field(default_factory=NoiseConfig)


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Batch Gauss-Newton with adaptive damping and a Huber robust kernel.

    The semantics of every field are those of
    ``toyslam_tpu.config.OptimizerConfig``.  What this package runs today:
    ``solver="schur"`` with ``pcg_precond`` "jacobi" or "tridiag", with or
    without "+coarse", any ``pcg_precond_refresh`` and either
    ``exact_odom_jacobians``, through the resident or the band fused-PCG
    kernel.  The other values validate here and raise
    ``NotImplementedError`` where the solver is built or run.
    """

    iterations: int = 10
    lr: float = 0.2
    huber_delta: float = 1.5
    lambda_init: float = 1e-3
    lambda_min: float = 1e-6
    lambda_max: float = 1e1
    lambda_factor: float = 1.1
    fixed_prior: float = 1e6
    convergence_eps: float = 1e-3
    penalty_limit: int = 2
    exact_odom_jacobians: bool = False
    solver: str = "dense"
    dense_factorization: str = "cholesky"
    pcg_tol: float = 1e-6
    pcg_max_iters: int = 200
    pcg_restart_every: int = 64
    pcg_precond: str = "tridiag"
    pcg_coarse_group: int = 64
    pcg_coarse_group2: int = 4
    pcg_chunk: int = 64
    pcg_precond_refresh: int = 1
    edge_backend: str = "xla"
    # "auto" / "fused" run the fused-PCG kernel; "xla" names the reference's
    # plain PCG loop, which this package does not have yet.
    pcg_backend: str = "auto"
    pcg_unroll: bool = False
    # PCG iterations per kernel launch; also the true-residual replacement
    # period of the fused loop.
    pcg_fused_chunk: int = 16
    reject_worse_steps: bool = False
    lambda_reject_factor: float = 10.0

    def __post_init__(self):
        local, _, coarse = self.pcg_precond.partition("+")
        if local not in ("jacobi", "tridiag", "chunk") or coarse not in (
            "", "coarse"
        ):
            raise ValueError(
                f"pcg_precond={self.pcg_precond!r}: expected "
                "'jacobi'|'tridiag'|'chunk' optionally suffixed '+coarse'"
            )
        if self.solver not in ("dense", "schur", "schur_grid", "schur3d"):
            raise ValueError(f"unknown solver {self.solver!r}")
        if self.edge_backend != "xla":
            raise ValueError(
                f"edge_backend={self.edge_backend!r}: only 'xla' exists — "
                "the per-edge kernels were retired; the fused PCG kernel "
                "is the kernel path"
            )
        if self.pcg_backend not in ("auto", "fused", "xla"):
            raise ValueError(f"unknown pcg_backend {self.pcg_backend!r}")
        if self.pcg_coarse_group2 < 1:
            raise ValueError(
                f"pcg_coarse_group2={self.pcg_coarse_group2}: must be >= 1"
            )
        if self.pcg_fused_chunk < 1:
            raise ValueError(
                f"pcg_fused_chunk={self.pcg_fused_chunk}: must be >= 1"
            )


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    sim: SimConfig = dataclasses.field(default_factory=SimConfig)
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig
    )
    # Graph arrays are padded up to multiples of these bucket sizes.
    pose_bucket: int = 64
    landmark_bucket: int = 64
    edge_bucket: int = 256
