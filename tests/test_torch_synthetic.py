"""The scale-workload generators of the PyTorch port against the JAX
package's: host numpy seeded by ``default_rng`` on both sides, so every
array must agree bit for bit (no tolerance)."""

import numpy as np
import pytest

from toyslam_tpu.sim import synthetic as j_syn
from toyslam_torch.sim import synthetic as t_syn

FIELDS = ("poses", "landmarks", "pose_mask", "lm_mask", "pose_fixed",
          "lm_fixed")
EDGE_FIELDS = ("meas", "info", "mask")


def _same_graph(jg, tg):
    for f in FIELDS:
        assert np.array_equal(np.asarray(getattr(jg, f)),
                              getattr(tg, f).numpy()), f
    for je, te, idx in ((jg.odom, tg.odom, ("i", "j")),
                        (jg.lm_edges, tg.lm_edges, ("pose", "lm"))):
        for f in idx:
            assert np.array_equal(np.asarray(getattr(je, f)),
                                  getattr(te, f).numpy()), f
        for f in EDGE_FIELDS:
            assert np.array_equal(np.asarray(getattr(je, f)),
                                  getattr(te, f).numpy()), f


@pytest.mark.parametrize("kw", [
    dict(num_poses=600, num_landmarks=500, obs_per_pose=6, seed=0),
    dict(num_poses=600, num_landmarks=400, obs_per_pose=5, seed=2,
         pose_bucket=64, landmark_bucket=64, edge_bucket=256),
    dict(num_poses=600, num_landmarks=300, obs_per_pose=4, seed=1,
         laps=2, pose_bucket=64, landmark_bucket=64, edge_bucket=256),
], ids=["default_buckets", "small_buckets", "two_laps"])
def test_make_large_problem_is_bit_identical(kw):
    jg, jp, jl = j_syn.make_large_problem(**kw)
    tg, tp, tl = t_syn.make_large_problem(**kw)
    _same_graph(jg, tg)
    assert np.array_equal(jp, tp) and np.array_equal(jl, tl)
    assert int(tg.pose_mask.sum()) == 600


def test_knn_obs_cells_matches_jax():
    """The cell-hash K-nearest search (the >20k-landmark branch) on small
    arrays: identical index arrays."""
    rng = np.random.default_rng(3)
    m = 900
    g = int(np.ceil(np.sqrt(m)))
    gx, gy = np.meshgrid(np.linspace(0, 60, g), np.linspace(0, 60, g))
    lms = np.stack([gx.ravel(), gy.ravel()], axis=1)[:m]
    lms = lms + rng.normal(0, 0.3, lms.shape)
    poses = rng.uniform(8, 52, size=(300, 2))
    lo, hi = np.array([0.0, 0.0]), np.array([60.0, 60.0])
    jp, jl = j_syn._knn_obs_cells(poses, lms, 6, lo, hi)
    tp, tl = t_syn._knn_obs_cells(poses, lms, 6, lo, hi)
    assert np.array_equal(jp, tp) and np.array_equal(jl, tl)
    bp, bl = t_syn._knn_obs_brute(poses, lms, 6)
    jbp, jbl = j_syn._knn_obs_brute(poses, lms, 6)
    assert np.array_equal(bp, jbp) and np.array_equal(bl, jbl)


def test_controls_helpers_match_jax():
    rng = np.random.default_rng(0)
    controls = rng.normal(0, 0.3, (50, 3))
    start = np.array([1.0, -2.0, 0.3])
    ji = j_syn._integrate(start, controls)
    ti = t_syn._integrate(start, controls)
    assert np.array_equal(ji, ti)
    assert np.array_equal(j_syn._relative_controls(ji),
                          t_syn._relative_controls(ti))
    assert np.array_equal(j_syn.multi_loop_controls(200, 0.5, 80),
                          t_syn.multi_loop_controls(200, 0.5, 80))
