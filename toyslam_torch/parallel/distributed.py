"""The edge-sharded solve: the port of ``toyslam_tpu.parallel.distributed``.

Pose and landmark *states* are replicated on every rank; odometry and
landmark *edges* are sharded.  Each rank linearizes its edge shard, the
per-vertex sums (diagonal blocks, gradients, chi^2) are summed across the
ranks once per linearization, and PCG runs replicated with two collectives
per matvec (``schur.plan_matvec``).  Everything runs through the same
``ops/schur.py`` code with ``group`` set: the sharded solve is the
single-device solve plus collectives, so tests diff the two directly.

Under a group the gate declines the kernels (``fused_pcg.fused_mode``), as
the JAX package's does under an ``axis_name``: these solves run the plain
PCG loop, and no kernel launches.
"""

from __future__ import annotations

import functools

from toyslam_torch.config import OptimizerConfig
from toyslam_torch.ops import schur
from toyslam_torch.ops.collective import all_reduce
from toyslam_torch.parallel.mesh import Mesh, is_shard, shard_graph


def graph_shard_specs() -> dict[str, tuple[str, ...]]:
    """The edge fields of a ``FactorGraph2D`` that :func:`shard_graph`
    cuts into per-rank chunks; every other array is replicated."""
    return {"odom": ("i", "j", "meas", "info", "mask"),
            "lm_edges": ("pose", "lm", "meas", "info", "mask")}


def graph3d_shard_specs() -> dict[str, tuple[str, ...]]:
    """The sharded edge fields of a ``FactorGraph3D`` (the same layout
    policy: edges sharded, pose/landmark states and intrinsics
    replicated)."""
    return {"odom": ("i", "j", "meas", "info", "mask"),
            "lm_edges": ("pose", "lm", "meas", "info", "mask")}


def _sharded(inner, mesh: Mesh, error):
    """The solve ``inner`` on this rank's shard, with ``prepare`` (the shard
    of a host graph, once per structure) and the sharded chi^2 that
    ``GaussNewton`` uses for its step rejection."""

    def prepare(graph):
        return graph if is_shard(graph) else shard_graph(graph, mesh)

    def solve(graph, lam):
        return inner(prepare(graph), lam)

    def error_fn(graph):
        return all_reduce(mesh.group, error(graph))[0]

    solve.prepare = prepare
    solve.error_fn = error_fn
    return solve


def distributed_linearize_solve(cfg: OptimizerConfig, mesh: Mesh):
    """A linearize-solve that runs the Schur/PCG solve across ``mesh``'s
    ranks; it plugs into ``GaussNewton(config, solve=...)`` unchanged.

    ``solve.prepare(graph)`` (``GaussNewton`` calls it once per graph
    structure) pads the edge arrays to the mesh and gives this rank its
    edge chunk and per-shard gather tables on its device
    (``mesh.shard_graph``); ``solve.error_fn`` is the chi^2 of a state
    summed over the shards."""
    from toyslam_torch.ops.assemble import total_error

    return _sharded(
        schur.schur_linearize_solve(cfg, group=mesh.group), mesh,
        functools.partial(total_error, huber_delta=cfg.huber_delta,
                          exact_odom_jacobians=cfg.exact_odom_jacobians))


def distributed_linearize_solve_3d(cfg: OptimizerConfig, mesh: Mesh):
    """The edge-sharded SE(3) BA solve over the 6/3 block system
    (``ops/schur3d.py``); plugs into ``GaussNewton(config, solve=...)`` with
    ``solver="schur3d"``.  Unlike the JAX package's, which drops the gather
    plan here and sums with ``segment_sum``, it takes per-shard tables as
    the 2D solve does: the port's Schur solve requires a gather plan."""
    from toyslam_torch.ops.schur3d import schur3d_linearize_solve
    from toyslam_torch.ops.schur3d import total_error_3d

    return _sharded(
        schur3d_linearize_solve(cfg, group=mesh.group), mesh,
        functools.partial(total_error_3d, huber_delta=cfg.huber_delta,
                          exact_odom_jacobians=cfg.exact_odom_jacobians))
