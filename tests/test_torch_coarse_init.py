"""``optimizer/coarse_init.py`` of the PyTorch port against the JAX package's.

``decimate`` and ``prolong`` are float64 numpy on both sides: every array is
identical (no tolerance).  ``incremental_init`` and ``coarse_to_fine_init``
run Gauss-Newton solves inside, so they are compared with converged PCG
solves (truncated PCG is chaotic from 2k poses on) on a 512-pose two-lap
graph: the chi^2 of the initialized state at rtol 1e-3, its ATE within 2 %.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from toyslam_tpu.config import NoiseConfig as JNoise, OptimizerConfig as JOpt
from toyslam_tpu.ops import assemble as j_assemble
from toyslam_tpu.optimizer import coarse_init as j_ci
from toyslam_tpu.sim import synthetic as j_syn
from toyslam_torch.config import NoiseConfig, OptimizerConfig
from toyslam_torch.ops import assemble
from toyslam_torch.optimizer import coarse_init as ci
from toyslam_torch.sim import frontend, synthetic

torch.set_num_threads(1)

STATE = ("poses", "landmarks", "pose_mask", "lm_mask", "pose_fixed",
         "lm_fixed")
BUCKETS = dict(pose_bucket=64, landmark_bucket=64, edge_bucket=256)
PROBLEM = dict(num_poses=512, num_landmarks=256, obs_per_pose=5, seed=1,
               laps=2, **BUCKETS)
NOISE = dict(position_std=0.25, orientation_std=float(np.radians(4.0)),
             variance_as_std=False)
# converged solves: both packages then reach the same state up to f32
SOLVE = dict(lr=1.0, solver="schur", exact_odom_jacobians=True,
             pcg_tol=1e-7, pcg_max_iters=300, pcg_restart_every=50,
             pcg_precond="tridiag+coarse", pcg_coarse_group=32)


def _same_graph(jg, tg):
    for f in STATE:
        np.testing.assert_array_equal(np.asarray(getattr(jg, f)),
                                      getattr(tg, f).numpy(), err_msg=f)
    for je, te, names in (
            (jg.odom, tg.odom, ("i", "j", "meas", "info", "mask")),
            (jg.lm_edges, tg.lm_edges,
             ("pose", "lm", "meas", "info", "mask"))):
        for f in names:
            np.testing.assert_array_equal(np.asarray(getattr(je, f)),
                                          getattr(te, f).numpy(), err_msg=f)


@pytest.fixture(scope="module")
def graphs():
    jg, gt, _ = j_syn.make_large_problem(noise=JNoise(**NOISE), **PROBLEM)
    tg, gt_t, _ = synthetic.make_large_problem(noise=NoiseConfig(**NOISE),
                                               **PROBLEM)
    assert np.array_equal(gt, gt_t)
    return jg, tg, gt


@pytest.mark.parametrize("factor", [8, 5], ids=["divides", "ragged"])
def test_decimate_and_prolong_bit_identical(graphs, factor):
    jg, tg, _ = graphs
    jc, j_rel = j_ci.decimate(jg, factor, **BUCKETS)
    tc, t_rel = ci.decimate(tg, factor, **BUCKETS)
    assert t_rel.dtype == np.float64
    np.testing.assert_array_equal(j_rel, t_rel)
    _same_graph(jc, tc)
    assert tc.odom.i.dtype == torch.int64 and tc.plan is None

    # prolong from a perturbed coarse state (the same on both sides)
    rng = np.random.default_rng(0)
    dp = rng.normal(0, 0.1, np.asarray(jc.poses).shape).astype(np.float32)
    dl = rng.normal(0, 0.1, np.asarray(jc.landmarks).shape).astype(np.float32)
    jc2 = jc.with_state(np.asarray(jc.poses) + dp,
                        np.asarray(jc.landmarks) + dl)
    tc2 = tc.with_state(tc.poses + torch.from_numpy(dp),
                        tc.landmarks + torch.from_numpy(dl))
    jf_, tf_ = (j_ci.prolong(jg, jc2, j_rel, factor),
                ci.prolong(tg, tc2, t_rel, factor))
    _same_graph(jf_, tf_)
    assert not np.array_equal(tf_.poses.numpy(), tg.poses.numpy())


def test_decimate_consistent_at_ground_truth():
    """With exact sensors the decimated problem at the decimated state is
    residual-free, and prolongation gives the original state back (the JAX
    package's own bounds: 1e-3 per edge, atol 1e-3)."""
    zero = NoiseConfig(lidar_std=1e-9, position_std=1e-9,
                       orientation_std=1e-9, variance_as_std=False)
    graph, _, _ = synthetic.make_large_problem(
        num_poses=512, num_landmarks=256, obs_per_pose=4, seed=3, noise=zero)
    coarse, rel_dr = ci.decimate(graph, factor=8)
    eye2 = torch.eye(2).expand_as(coarse.lm_edges.info).contiguous()
    eye3 = torch.eye(3).expand_as(coarse.odom.info).contiguous()
    coarse_id = dataclasses.replace(
        coarse,
        lm_edges=dataclasses.replace(coarse.lm_edges, info=eye2),
        odom=dataclasses.replace(coarse.odom, info=eye3),
    )
    err = float(assemble.total_error(coarse_id, huber_delta=1e9,
                                     exact_odom_jacobians=True))
    assert err / max(int(coarse.lm_edges.mask.sum()), 1) < 1e-3, err
    fine = ci.prolong(graph, coarse, rel_dr, 8)
    n = int(graph.pose_mask.sum())
    np.testing.assert_allclose(fine.poses[:n, :2].numpy(),
                               graph.poses[:n, :2].numpy(), atol=1e-3)


def test_decimate_rejects_loop_closure_odometry(graphs):
    _, tg, _ = graphs
    j = tg.odom.j.clone()
    j[3] = 9
    bad = dataclasses.replace(tg, odom=dataclasses.replace(tg.odom, j=j))
    with pytest.raises(ValueError, match="chain-only"):
        ci.decimate(bad, 8)
    with pytest.raises(ValueError, match="chain-only"):
        ci.incremental_init(bad, window=128)


def _chi2_j(g):
    return float(j_assemble.total_error(
        jax.device_put(g), huber_delta=1e9, exact_odom_jacobians=True))


def _chi2_t(g):
    return float(assemble.total_error(g, huber_delta=1e9,
                                      exact_odom_jacobians=True))


def _compare_init(jg, tg, j_init, t_init, gt):
    n = gt.shape[0]
    # the same measure on both states (the port's), and each package's own
    np.testing.assert_allclose(_chi2_t(t_init), _chi2_j(j_init), rtol=1e-3)
    ate_j = frontend.ate_rmse(np.asarray(j_init.poses)[:n], gt)
    ate_t = frontend.ate_rmse(t_init.poses[:n].numpy(), gt)
    ate_dr = frontend.ate_rmse(tg.poses[:n].numpy(), gt)
    assert abs(ate_t - ate_j) <= 0.02 * ate_j, (ate_t, ate_j)
    assert _chi2_t(t_init) < 0.05 * _chi2_t(tg)
    # structure and masks are the input's; only the state moved
    assert torch.equal(t_init.pose_mask, tg.pose_mask)
    assert torch.equal(t_init.lm_edges.mask, tg.lm_edges.mask)
    assert t_init.poses.dtype == torch.float32
    return ate_t, ate_dr


def test_incremental_init_matches_jax(graphs):
    """Four windows of 160 over 512 poses: the last one is partial, so the
    overlap re-initialization of the JAX package is on the path."""
    jg, tg, gt = graphs
    kw = dict(window=160, iters_per_prefix=5)
    j_init = j_ci.incremental_init(
        jg, solver_cfg=JOpt(pcg_precond_refresh=0, **SOLVE), **kw)
    t_init = ci.incremental_init(
        tg, solver_cfg=OptimizerConfig(pcg_precond_refresh=0, **SOLVE), **kw)
    ate_t, ate_dr = _compare_init(jg, tg, j_init, t_init, gt)
    assert ate_t < 0.5 * ate_dr, (ate_t, ate_dr)


def test_incremental_init_default_config_runs(graphs):
    """The default (truncated, ``pcg_precond_refresh=0``) schedule: not
    compared across packages, only held to the basin property."""
    _, tg, gt = graphs
    n = gt.shape[0]
    t_init = ci.incremental_init(tg, window=128, iters_per_prefix=3)
    assert torch.isfinite(t_init.poses).all()
    assert _chi2_t(t_init) < 0.05 * _chi2_t(tg)
    assert frontend.ate_rmse(t_init.poses[:n].numpy(), gt) < (
        frontend.ate_rmse(tg.poses[:n].numpy(), gt))


def test_coarse_to_fine_init_matches_jax(graphs):
    jg, tg, gt = graphs
    cfg = dict(iterations=12, pcg_precond_refresh=1, convergence_eps=1e-4,
               **SOLVE)
    j_init = j_ci.coarse_to_fine_init(jg, factor=8, coarse_cfg=JOpt(**cfg))
    t_init = ci.coarse_to_fine_init(tg, factor=8,
                                    coarse_cfg=OptimizerConfig(**cfg))
    n = gt.shape[0]
    np.testing.assert_allclose(_chi2_t(t_init), _chi2_j(j_init), rtol=1e-3)
    ate_j = frontend.ate_rmse(np.asarray(j_init.poses)[:n], gt)
    ate_t = frontend.ate_rmse(t_init.poses[:n].numpy(), gt)
    assert abs(ate_t - ate_j) <= 0.02 * ate_j, (ate_t, ate_j)
    assert ate_t < frontend.ate_rmse(tg.poses[:n].numpy(), gt)
