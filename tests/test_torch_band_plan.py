"""The band layout search of the PyTorch port against the JAX package's:
pure host structure code, so every integer field must be equal and every
float mask identical.  The layout is built on the 2100-pose graph of
tests/test_band_fused.py, searched and dense-streamed (``search=()``)."""

import dataclasses

import numpy as np
import pytest
import torch

from toyslam_tpu.ops import band_plan as j_bp
from toyslam_tpu.ops import gather_plan as j_gp
from toyslam_tpu.sim import synthetic as j_syn
from toyslam_torch.bridge import graph_from_arrays
from toyslam_torch.ops import band_plan as t_bp
from toyslam_torch.ops import gather_plan as t_gp
from toyslam_torch.sim import synthetic as t_syn

ARRAYS = ("scatter_base", "band_mask", "win_off", "wide_idx", "wide_mask",
          "src_edges", "elem_ids", "wide_edges")
STATIC = ("chunk_b", "k_windows", "w_row", "n_chunks", "n_wide", "dp", "dl")
BIG = dict(num_poses=2100, num_landmarks=1500, obs_per_pose=5, seed=4,
           pose_bucket=64, landmark_bucket=64, edge_bucket=256)


@pytest.fixture(scope="module")
def graphs():
    return (j_syn.make_large_problem(**BIG)[0],
            t_syn.make_large_problem(**BIG)[0])


def _same_layout(ja, ta):
    for f in ARRAYS:
        assert np.array_equal(np.asarray(getattr(ja, f)),
                              getattr(ta, f).numpy()), f
    for f in STATIC:
        assert getattr(ja, f) == getattr(ta, f), f
    assert ja.tile_bytes == ta.tile_bytes


def _cover_oracle(win_off, n, w_row, dp):
    """Per pose, the windows covering it, by a plain loop over (c, k)."""
    rows = [[] for _ in range(n)]
    for ck, off in enumerate(np.asarray(win_off).reshape(-1)):
        for w in range(w_row):
            if off + w < n:
                rows[off + w].append(ck * dp * w_row + w)
    return rows


@pytest.mark.parametrize("search", [None, ()], ids=["searched",
                                                    "dense_streamed"])
def test_build_band_aux_matches_jax(graphs, search):
    jg, tg = graphs
    ja = j_bp.build_band_aux(jg, search=search)
    ta = t_bp.build_band_aux(tg, search=search)
    assert ja is not None and ta is not None
    _same_layout(ja, ta)
    if search == ():
        assert ta.k_windows == 1 and ta.w_row >= tg.num_poses
    else:
        assert ta.k_windows >= 2 and ta.n_wide > 0
    # the kernel's cover table lists exactly the covering windows, in order
    want = _cover_oracle(ta.win_off, tg.num_poses, ta.w_row, ta.dp)
    cover = ta.cover.numpy()
    assert cover.shape == (tg.num_poses, max(len(r) for r in want))
    for p, row in enumerate(want):
        got = cover[p]
        assert list(got[: len(row)]) == row and (got[len(row):] == -1).all()


def test_duplicate_observation_refuses_the_layout(graphs):
    _, tg = graphs
    le = tg.lm_edges
    real = torch.nonzero(le.mask > 0).flatten()
    pose, lm = le.pose.clone(), le.lm.clone()
    pose[real[1]], lm[real[1]] = pose[real[0]], lm[real[0]]
    dup = dataclasses.replace(
        tg, lm_edges=dataclasses.replace(le, pose=pose, lm=lm))
    assert t_bp.build_band_aux(dup) is None


def test_attach_plan_and_bridge_carry_the_layout(graphs):
    jg, tg = graphs
    tplan = t_gp.attach_plan(tg).plan
    assert tplan.band is not None
    assert t_gp.attach_plan(tg, want_band=False).plan.band is None
    jg = j_gp.attach_plan(jg)
    bridged = graph_from_arrays(jg).plan.band
    _same_layout(jg.plan.band, bridged)
    _same_layout(jg.plan.band, tplan.band)
    assert torch.equal(bridged.cover, tplan.band.cover)
    # below the threshold no layout is searched
    small = t_syn.make_large_problem(
        num_poses=600, num_landmarks=400, obs_per_pose=5, seed=2,
        pose_bucket=64, landmark_bucket=64, edge_bucket=256)[0]
    assert t_gp.attach_plan(small).plan.band is None
