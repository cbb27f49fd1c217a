"""The main path of the PyTorch port against the JAX package: damped
Gauss-Newton with the Schur/fused-PCG solve on the seeded 150-pose
simulation, and the loop's control branches on a smaller graph.

Bounds are those the JAX package holds its own fused path to: per-iteration
chi^2 at rtol 1e-4, poses at atol 1e-3; the ATE within 2e-3 of 0.7552."""

import jax
import numpy as np
import pytest
import torch

from toyslam_tpu.config import OptimizerConfig as JOpt
from toyslam_tpu.config import SimConfig as JSim, SlamConfig as JSlam
from toyslam_tpu.ops.gather_plan import attach_plan as j_attach_plan
from toyslam_tpu.optimizer.gauss_newton import GaussNewton as JGN
from toyslam_tpu.sim import frontend as jf
from toyslam_torch.config import OptimizerConfig as TOpt
from toyslam_torch.config import SimConfig as TSim, SlamConfig as TSlam
from toyslam_torch.ops import fused_pcg
from toyslam_torch.optimizer import GaussNewton as TGN
from toyslam_torch.sim import frontend as tf

torch.set_num_threads(1)
MAIN = dict(iterations=10, lr=0.2, solver="schur", pcg_precond="tridiag")


def _graphs(steps):
    jg = jf.build_graph(jf.simulate(JSim(robot_steps=steps)), JSlam())[0]
    sim = tf.simulate(TSim(robot_steps=steps))
    return jg, tf.build_graph(sim, TSlam())[0], sim


def _compare(jr, tr):
    je, te = np.asarray(jr.errors), tr.errors.numpy()
    valid = ~np.isnan(je)
    assert np.array_equal(valid, ~np.isnan(te))
    np.testing.assert_allclose(te[valid], je[valid], rtol=1e-4)
    np.testing.assert_allclose(tr.graph.poses.numpy(),
                               np.asarray(jr.graph.poses), atol=1e-3)
    np.testing.assert_allclose(tr.graph.landmarks.numpy(),
                               np.asarray(jr.graph.landmarks), atol=1e-3)
    np.testing.assert_allclose(tr.lambdas.numpy()[valid],
                               np.asarray(jr.lambdas)[valid], rtol=1e-6)
    assert tr.iterations_run == int(jr.iterations_run)
    assert tr.converged == bool(jr.converged)
    assert tr.diverged == bool(jr.diverged)
    dit = np.abs(tr.pcg_iters.numpy() - np.asarray(jr.pcg_iters))
    assert dit.max() <= 16          # one chunk of the fused loop


def test_main_path_matches_jax():
    jg, tg, sim = _graphs(150)
    jr = JGN(JOpt(**MAIN)).optimize(jg)
    before = fused_pcg.fused_pcg_chunk.launches
    tr = TGN(TOpt(**MAIN)).optimize(tg)
    assert fused_pcg.fused_pcg_chunk.launches == before   # CPU: no kernel
    _compare(jr, tr)
    n = sim.poses_gt.shape[0]
    ate = tf.ate_rmse(tr.graph.poses[:n], sim.poses_gt)
    assert abs(ate - 0.7552) <= 2e-3
    assert abs(tf.ate_rmse(sim.poses_dr, sim.poses_gt) - 6.5673) <= 1e-4
    np.testing.assert_allclose(tr.errors[0].item(), 228733.5, rtol=1e-4)
    np.testing.assert_allclose(tr.errors[-1].item(), 27524.9, rtol=1e-3)


@pytest.mark.parametrize("change", [
    {"reject_worse_steps": True, "lr": 1.0, "iterations": 4},
    {"lr": 2.5, "iterations": 6, "penalty_limit": 0},
    {"convergence_eps": 50.0, "iterations": 5},
    {"pcg_precond": "jacobi", "iterations": 3},
], ids=["reject_worse_steps", "diverges", "converges", "jacobi"])
def test_control_branches_match_jax(change):
    jg, tg, _ = _graphs(40)
    cfg = dict(MAIN, **change)
    jr = JGN(JOpt(**cfg)).optimize(jg)
    tr = TGN(TOpt(**cfg)).optimize(tg)
    _compare(jr, tr)
    if "penalty_limit" in change:
        assert tr.diverged
    if "convergence_eps" in change:
        assert tr.converged and tr.iterations_run < 5


def test_step_matches_jax():
    jg, tg, _ = _graphs(40)
    jgn, tgn = JGN(JOpt(**MAIN)), TGN(TOpt(**MAIN))
    jg2, jerr = jax.jit(jgn.step)(j_attach_plan(jg))
    tg2, terr = tgn.step(tg)
    np.testing.assert_allclose(float(terr), float(jerr), rtol=1e-5)
    np.testing.assert_allclose(tg2.poses.numpy(), np.asarray(jg2.poses),
                               atol=1e-4)


def test_unported_solvers_raise():
    """Every solver is ported now; what raises is ``pcg_unroll``, the
    reference's cost-analysis harness (ROADMAP.md "Do not port"), in the
    plain loop the gate sends it to, stateful or not."""
    from toyslam_torch.optimizer.gauss_newton import dense_linearize_solve

    _, tg, _ = _graphs(40)
    assert TGN(TOpt(solver="schur_grid")).solve.prepare is not None
    assert TGN(TOpt()).solve.__qualname__.startswith(
        dense_linearize_solve.__name__)
    gn = TGN(TOpt(**dict(MAIN, pcg_unroll=True)))
    with pytest.raises(NotImplementedError, match="pcg_unroll"):
        gn.optimize(tg)
    gn = TGN(TOpt(**dict(MAIN, pcg_unroll=True, pcg_precond_refresh=0)))
    with pytest.raises(NotImplementedError, match="pcg_unroll"):
        gn.optimize(tg)


@pytest.mark.parametrize("change", [
    {"exact_odom_jacobians": True, "iterations": 4},
    {"pcg_precond": "tridiag+coarse", "pcg_coarse_group": 16,
     "iterations": 4},
    {"pcg_precond_refresh": 3, "iterations": 5},
    {"pcg_precond_refresh": 0, "iterations": 3},
], ids=["exact_odom_jacobians", "tridiag_coarse", "refresh3", "frozen"])
def test_resident_options_match_jax(change):
    """The options the scale path brings, on the resident 150-pose path:
    the JAX package runs them through its fused kernel too."""
    jg, tg, _ = _graphs(150)
    cfg = dict(MAIN, **change)
    jr = JGN(JOpt(**cfg)).optimize(jg)
    tr = TGN(TOpt(**cfg)).optimize(tg)
    _compare(jr, tr)


# the scale path's config (exact odometry Jacobians, tridiag+coarse, the
# preconditioner refreshed every 2 iterations, chunks of 10) with damping
# and a tolerance at which every PCG solve converges
SCALE = dict(solver="schur", iterations=3, lr=1.0, exact_odom_jacobians=True,
             lambda_init=10.0, pcg_tol=1e-6, pcg_max_iters=400,
             pcg_restart_every=40, pcg_precond="tridiag+coarse",
             pcg_coarse_group=64, pcg_precond_refresh=2, pcg_fused_chunk=10)


def test_stateful_band_path_matches_jax_plain_pcg():
    """Three GN iterations of the stateful band path on a 2100-pose graph:
    the port through its band solve, the JAX package through its plain
    PCG loop (f32), chi^2 at rtol 1e-3.  The solves converge here: with
    the PCG truncated (tol 1e-2, cap 80, lambda 1e-3) the JAX package's own
    plain and fused paths differ by 10 % in chi^2 at iteration 2 on this
    graph, so truncated runs cannot be held to each other."""
    from toyslam_tpu.sim import synthetic as j_syn
    from toyslam_torch.ops import fused_pcg as t_fp
    from toyslam_torch.ops.gather_plan import attach_plan
    from toyslam_torch.sim import synthetic as t_syn

    kw = dict(num_poses=2100, num_landmarks=1500, obs_per_pose=5, seed=4,
              pose_bucket=64, landmark_bucket=64, edge_bucket=256)
    jg = j_syn.make_large_problem(**kw)[0]
    tg = attach_plan(t_syn.make_large_problem(**kw)[0])
    assert t_fp.fused_mode(TOpt(**SCALE), tg) == "band"
    jr = JGN(JOpt(**dict(SCALE, pcg_backend="xla"))).optimize(jg)
    tr = TGN(TOpt(**SCALE)).optimize(tg)
    je, te = np.asarray(jr.errors), tr.errors.numpy()
    np.testing.assert_allclose(te, je, rtol=1e-3)
    assert tr.iterations_run == int(jr.iterations_run) == 3
    assert te[-1] < 0.5 * te[0]
    dit = np.abs(tr.pcg_iters.numpy() - np.asarray(jr.pcg_iters))
    assert dit.max() <= 10          # one chunk of the fused loop
