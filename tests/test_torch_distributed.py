"""The port's edge-sharded solve (``toyslam_torch.parallel.distributed``) on
4 gloo ranks on the CPU against the JAX package's on a 4-device mesh of
the fake CPU devices, on the inputs and at the tolerances of
``tests/test_distributed.py`` and ``tests/test_distributed3d.py``: one
linearize-solve (err rtol 1e-5; dx rtol 1e-3, atol 1e-5), with the
per-shard gather tables, GN end to end (poses atol 5e-3), the SE(3)
assembly (atol 1e-4 on the scaled blocks), bitwise agreement of the
replicated outputs across the ranks, and no kernel launch.

The ranks start once for the module (``run_ranks``) and run every case;
the test functions compare what they returned."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import oracle
import torch_parallel_ranks as ranks
from toyslam_tpu.config import OptimizerConfig as JOpt
from toyslam_tpu.ops import schur3d as j_schur3d
from toyslam_tpu.ops.gather_plan import attach_plan as j_attach_plan
from toyslam_tpu.optimizer import GaussNewton as JGaussNewton
from toyslam_tpu.parallel import distributed_linearize_solve as j_dist
from toyslam_tpu.parallel import make_mesh as j_make_mesh
from toyslam_tpu.parallel.distributed import graph3d_shard_specs
from toyslam_tpu.parallel.mesh import EDGE_AXIS
from toyslam_tpu.parallel.mesh import pad_edges_for_mesh as j_pad
from toyslam_tpu.sim import synthetic3d as j_synth3d
from toyslam_torch.bridge import graph3d_from_arrays, graph_from_arrays
from toyslam_torch.config import OptimizerConfig
from toyslam_torch.ops import fused_pcg as t_fp
from toyslam_torch.ops import schur as t_schur
from toyslam_torch.ops.gather_plan import attach_plan
from toyslam_torch.parallel.launch import run_ranks

D = 4
CFG = dict(solver="schur", pcg_tol=1e-8, pcg_max_iters=500)
CFG3D = dict(iterations=15, lr=1.0, solver="schur3d",
             exact_odom_jacobians=True, huber_delta=1e9, pcg_tol=1e-8,
             pcg_max_iters=300, convergence_eps=1e-8,
             reject_worse_steps=True)


@pytest.fixture(scope="module")
def graphs():
    prob = oracle.make_random_problem(np.random.default_rng(9), n_poses=25,
                                      n_lms=14, n_lm_edges=120)
    jg = oracle.problem_to_builder(prob).build()
    jg3, _, _ = j_synth3d.make_ba_problem(num_poses=24, num_landmarks=96,
                                          obs_per_pose=12, seed=1)
    return jg, graph_from_arrays(jg), jg3, graph3d_from_arrays(jg3)


@pytest.fixture(scope="module")
def port(graphs):
    _, tg, _, tg3 = graphs
    return run_ranks(ranks.distributed_cases, D, "cpu",
                     (tg, tg3, CFG, CFG3D))


@pytest.fixture(scope="module")
def mesh():
    return j_make_mesh(D)


def _close(port, ref, rtol, atol):
    np.testing.assert_allclose(np.asarray(port, np.float64),
                               np.asarray(ref, np.float64),
                               rtol=rtol, atol=atol)


def _check_solve(got, ref):
    dxp, dxl, err, _ = ref
    _close(got["err"], float(err), 1e-5, 0.0)
    _close(got["dxp"], dxp, 1e-3, 1e-5)
    _close(got["dxl"], dxl, 1e-3, 1e-5)


def test_distributed_solve_matches_jax(graphs, port, mesh):
    """Against the JAX package's edge-sharded solve without tables
    (``segment_sum`` under ``shard_map``)."""
    jg = graphs[0]
    ref = jax.jit(j_dist(JOpt(**CFG), mesh))(jg, jnp.asarray(1e-3))
    _check_solve(port[0]["solve"], ref)


def test_distributed_sharded_plan_matches_jax(graphs, port, mesh):
    """Against the JAX package's per-shard-table solve: the same [D, V, K]
    tables, the rank's own on each rank."""
    jg = graphs[0]
    jsolve = j_dist(JOpt(**CFG), mesh)
    gprep = jsolve.prepare(jg)
    ref = jax.jit(jsolve)(gprep, jnp.asarray(1e-3))
    assert port[0]["plan_shape"] == gprep.plan.lm_by_pose.idx.shape[1:]
    _check_solve(port[0]["solve"], ref)


def test_distributed_solve_matches_single_device(graphs, port):
    """Against the port's own single-device plain-loop solve."""
    tg = graphs[1]
    ref = t_schur.schur_linearize_solve(OptimizerConfig(
        **dict(CFG, pcg_backend="xla")))(attach_plan(tg), torch.tensor(1e-3))
    _check_solve(port[0]["solve"], ref)


def test_distributed_gauss_newton_end_to_end(graphs, port, mesh):
    jg = graphs[0]
    n = 25
    cfg = JOpt(**dict(CFG, iterations=8))
    ref = JGaussNewton(cfg, solve=j_dist(cfg, mesh)).optimize(jg)
    single = JGaussNewton(cfg).optimize(j_attach_plan(jg))
    for r in port:
        np.testing.assert_allclose(r["gn"]["poses"][:n],
                                   np.asarray(ref.graph.poses)[:n],
                                   atol=5e-3)
        np.testing.assert_allclose(r["gn"]["poses"][:n],
                                   np.asarray(single.graph.poses)[:n],
                                   atol=5e-3)


def test_distributed3d_assembly_matches_jax(graphs, port, mesh):
    """The SE(3) edge-sharded assembly against the JAX package's, on its
    mesh and single-device, on the scaled blocks."""
    jg3 = graphs[2]
    cfg = JOpt(**CFG3D)

    def blocks(g, axis):
        s = j_schur3d.assemble_blocks_3d(
            g, cfg.huber_delta, fixed_prior=cfg.fixed_prior,
            exact_odom_jacobians=cfg.exact_odom_jacobians, axis_name=axis)
        return s.hpp_diag, s.hll, s.bp, s.bl, s.err

    single = blocks(jg3, None)
    sharded = jax.jit(shard_map(
        lambda g: blocks(g, EDGE_AXIS), mesh=mesh,
        in_specs=(graph3d_shard_specs(),), out_specs=(P(),) * 5,
    ))(j_pad(jg3, D))
    names = ("hpp_diag", "hll", "bp", "bl", "err")
    for ref in (single, sharded):
        for name, a in zip(names, ref):
            a = np.asarray(a)
            scale = max(np.abs(a).max(), 1.0)
            np.testing.assert_allclose(port[0]["asm3d"][name] / scale,
                                       a / scale, atol=1e-4, err_msg=name)


def test_distributed3d_solve_is_finite_on_every_rank(port):
    for r in port:
        assert np.isfinite(r["solve3d"]["dxp"]).all()
        assert np.isfinite(r["solve3d"]["err"]).all()


def test_replicated_outputs_agree_bitwise_across_ranks(port):
    """States are replicated: every rank's solve, trajectory, chi^2,
    lambda and iteration counts have the same bits."""
    for r in port[1:]:
        for case in ("solve", "solve3d"):
            for k in ("dxp", "dxl", "err"):
                np.testing.assert_array_equal(r[case][k], port[0][case][k])
            assert r[case]["pcg_iters"] == port[0][case]["pcg_iters"]
        assert r["gn"]["digest"] == port[0]["gn"]["digest"]
        for name, a in r["asm3d"].items():
            np.testing.assert_array_equal(a, port[0]["asm3d"][name])


def test_no_kernel_launch_under_a_group(graphs, port):
    """The gate declines the kernels under a process group, as the JAX
    package's does under an axis name: no launch on any rank."""
    assert [r["launches"] for r in port] == [0] * D
    tg = attach_plan(graphs[1])
    cfg = OptimizerConfig(solver="schur", pcg_precond="tridiag")
    assert t_fp.fused_mode(cfg, tg) == "resident"
    assert t_fp.fused_mode(cfg, tg, group=object()) is None
