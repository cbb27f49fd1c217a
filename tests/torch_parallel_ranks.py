"""Rank functions of the port's multi-process tests
(``tests/test_torch_distributed.py``, ``test_torch_partition.py``,
``test_torch_partition3d.py``).

Each runs in a spawned rank (``toyslam_torch.parallel.launch.run_ranks``,
gloo on the CPU), runs every case of its test module once, and returns
numpy arrays and numbers per case.  This module imports only torch, numpy
and ``toyslam_torch``: the JAX side of every comparison runs in the test
process.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from toyslam_torch.config import OptimizerConfig
from toyslam_torch.ops import fused_pcg as fp
from toyslam_torch.ops import schur
from toyslam_torch.ops.collective import all_reduce
from toyslam_torch.optimizer import GaussNewton
from toyslam_torch.parallel import (
    distributed_linearize_solve,
    distributed_linearize_solve_3d,
    gather_result,
    partitioned_linearize_solve,
    shard_graph,
)
from toyslam_torch.parallel import partition as part

LAM = 1e-3
PRECONDS = ("jacobi", "tridiag", "chunk", "chunk+coarse", "jacobi+coarse")


def _np(t):
    return t.detach().cpu().numpy()


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _lam(dtype=torch.float32):
    return torch.tensor(LAM, dtype=dtype)


def _reset_counts():
    fp.fused_pcg_chunk.launches = 0
    fp.band_fused_pcg_chunk.launches = 0


def _launches():
    return fp.fused_pcg_chunk.launches + fp.band_fused_pcg_chunk.launches


def _solve_out(out):
    dxp, dxl, err, stats = out
    return dict(dxp=_np(dxp), dxl=_np(dxl), err=_np(err),
                pcg_iters=int(stats.pcg_iters))


def _gn_out(res):
    it = res.iterations_run
    return dict(iterations_run=it, errors=_np(res.errors),
                lambdas=_np(res.lambdas), pcg_iters=_np(res.pcg_iters),
                digest=_digest(_np(res.errors), _np(res.lambdas),
                               _np(res.pcg_iters), np.asarray([it])))


# --- the edge-sharded solve ---------------------------------------------


def distributed_cases(mesh, graph, graph3d, cfg_kw, cfg3d_kw):
    """The 2D solve (per-shard tables), the 2D GN, the SE(3) assembly and
    the SE(3) solve, all on this rank's edge shard."""
    _reset_counts()
    out = {}
    cfg = OptimizerConfig(**cfg_kw)
    solve = distributed_linearize_solve(cfg, mesh)
    shard = solve.prepare(graph)
    out["plan_shape"] = tuple(shard.plan.lm_by_pose.idx.shape)
    out["solve"] = _solve_out(solve(shard, _lam()))

    gcfg = OptimizerConfig(**dict(cfg_kw, iterations=8))
    res = GaussNewton(gcfg, solve=distributed_linearize_solve(
        gcfg, mesh)).optimize(graph)
    out["gn"] = dict(_gn_out(res), poses=_np(res.graph.poses))
    out["gn"]["digest"] += _digest(out["gn"]["poses"])

    cfg3 = OptimizerConfig(**cfg3d_kw)
    from toyslam_torch.ops import schur3d

    sys3 = schur3d.assemble_blocks_3d(
        shard_graph(graph3d, mesh), cfg3.huber_delta,
        fixed_prior=cfg3.fixed_prior,
        exact_odom_jacobians=cfg3.exact_odom_jacobians, group=mesh.group)
    out["asm3d"] = {k: _np(getattr(sys3, k))
                    for k in ("hpp_diag", "hll", "bp", "bl", "err")}
    out["solve3d"] = _solve_out(
        distributed_linearize_solve_3d(cfg3, mesh)(graph3d, _lam()))
    out["launches"] = _launches()
    return out


# --- the partitioned solve ------------------------------------------------


def _matvec_collectives(mesh, graph, cfg):
    """The all-reduces of one partitioned matvec."""
    solve = partitioned_linearize_solve(cfg, mesh)
    g = solve.prepare(graph)
    pose_bnd, lm_bnd = part._publish_states(g, mesh.group)
    d = schur.damp(part._assemble_local(g, cfg, mesh.group, pose_bnd,
                                        lm_bnd), _lam())
    matvec = part._partitioned_matvec(d, schur.inv_blocks(d.hll), g.plan,
                                      g.poses.shape[0],
                                      g.landmarks.shape[0], mesh.group)
    c0 = all_reduce.calls
    matvec(torch.ones_like(d.bp))
    return all_reduce.calls - c0


def partition_cases(mesh, graph, cfg_kw, jax_pgraph, jax_meta):
    """The five preconditioners, exact odometry Jacobians, GN through
    ``gather_result``, the collectives of one matvec, and the jacobi solve
    on the tables the JAX package built (``jax_pgraph``, bridged)."""
    _reset_counts()
    out = {}
    for precond in PRECONDS:
        cfg = OptimizerConfig(**dict(cfg_kw, pcg_precond=precond))
        solve = partitioned_linearize_solve(cfg, mesh)
        out[precond] = _solve_out(solve(solve.prepare(graph), _lam()))
        out["meta"] = solve.meta
    cfg = OptimizerConfig(**dict(cfg_kw, exact_odom_jacobians=True))
    out["exact"] = _solve_out(partitioned_linearize_solve(cfg, mesh)(
        graph, _lam()))

    gcfg = OptimizerConfig(**dict(cfg_kw, iterations=8,
                                  pcg_precond="chunk+coarse"))
    solve = partitioned_linearize_solve(gcfg, mesh)
    res = GaussNewton(gcfg, solve=solve).optimize(graph)
    poses, landmarks = gather_result(res, solve.meta, mesh)
    out["gn"] = dict(_gn_out(res), poses=_np(poses),
                     landmarks=_np(landmarks))
    out["gn"]["digest"] += _digest(out["gn"]["poses"],
                                   out["gn"]["landmarks"])

    out["matvec_collectives"] = _matvec_collectives(
        mesh, graph, OptimizerConfig(**cfg_kw))
    cfg = OptimizerConfig(**dict(cfg_kw, pcg_precond="jacobi"))
    out["jax_tables"] = _solve_out(partitioned_linearize_solve(cfg, mesh)(
        part.partition_shard(jax_pgraph, jax_meta, mesh.rank), _lam()))
    out["launches"] = _launches()
    return out


def partition3d_cases(mesh, graph, cfg_kw, cfg64_kw, gn_kw):
    """SE(3): ``jacobi`` and ``chunk+coarse`` in float32, the float64 pin,
    and GN in float64 through ``gather_result``."""
    _reset_counts()
    out = {}
    for precond in ("jacobi", "chunk+coarse"):
        cfg = OptimizerConfig(**dict(cfg_kw, pcg_precond=precond))
        solve = partitioned_linearize_solve(cfg, mesh)
        out[precond] = _solve_out(solve(solve.prepare(graph), _lam()))
        out["meta"] = solve.meta
    cfg = OptimizerConfig(**cfg64_kw)
    out["f64"] = _solve_out(partitioned_linearize_solve(cfg, mesh)(
        graph.astype(torch.float64), _lam(torch.float64)))
    gcfg = OptimizerConfig(**gn_kw)
    solve = partitioned_linearize_solve(gcfg, mesh)
    res = GaussNewton(gcfg, solve=solve).optimize(graph.astype(torch.float64))
    poses, _ = gather_result(res, solve.meta, mesh)
    out["gn"] = dict(_gn_out(res), poses=_np(poses))
    out["gn"]["digest"] += _digest(out["gn"]["poses"])
    out["launches"] = _launches()
    return out


def skewed_finish(mesh, late_rank, sleep_s):
    """One all-reduce, then ``late_rank`` sleeps before it returns (and so
    before its result is saved), while the other ranks go on to leave the
    group: ``tests/test_torch_parallel_launch.py``'s skewed teardown."""
    import time

    import torch.distributed as dist

    t = torch.full((4,), float(mesh.rank + 1))
    dist.all_reduce(t, group=mesh.group)
    if mesh.rank == late_rank:
        time.sleep(sleep_s)
    return {"rank": mesh.rank, "sum": t.tolist()}
