"""The coarse level and the exact odometry Jacobians of the PyTorch port
against the JAX package.

* exact odometry Jacobians (closed form here, ``jax.jacfwd`` there) and the
  general odometry branch of ``assemble_blocks``, at a perturbed state
  (at the dead-reckoned start the odometry residuals are f32 noise), at
  rel 1e-5: both are the same f32 formulas up to operation order;
* ``_chol_small`` and ``spd_inverse`` on seeded matrices;
* ``build_coarse_precond`` and the "+coarse" preconditioner on the 150-pose
  graph and the 2100-pose band graph.  Its explicit inverse is 25 steps of
  f32 Newton-Schulz on a system of equilibrated condition ~1e4, so it is
  compared at rel 1e-3 of its largest entry: the iteration amplifies the
  operators' 1e-6 summation-order differences.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toyslam_tpu.config import SimConfig, SlamConfig
from toyslam_tpu.ops import fused_pcg as j_fp
from toyslam_tpu.ops import residuals as j_res
from toyslam_tpu.ops import schur as j_schur
from toyslam_tpu.ops.gather_plan import attach_plan
from toyslam_tpu.sim import frontend
from toyslam_tpu.sim import synthetic as j_syn
from toyslam_torch.bridge import graph_from_arrays
from toyslam_torch.ops import fused_pcg as t_fp
from toyslam_torch.ops import residuals as t_res
from toyslam_torch.ops import schur as t_schur

torch.set_num_threads(1)
LAM = 1e-3


def _rel(port, ref):
    port = port.detach().double().numpy() if torch.is_tensor(port) \
        else np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    return float(np.abs(port - ref).max() / np.abs(ref).max())


def _perturbed(jg, seed=0):
    """The graph at a perturbed state, so the odometry residuals and the
    exact Jacobians' rotation terms are far from zero."""
    rng = np.random.default_rng(seed)
    poses = np.asarray(jg.poses).copy()
    poses += rng.normal(0, [0.3, 0.3, 0.2], poses.shape).astype(np.float32)
    lms = np.asarray(jg.landmarks) + rng.normal(
        0, 0.2, np.asarray(jg.landmarks).shape).astype(np.float32)
    jg = jg.with_state(jnp.asarray(poses), jnp.asarray(lms))
    return jg, graph_from_arrays(jg)


@pytest.fixture(scope="module")
def main_graph():
    jg = attach_plan(frontend.build_graph(frontend.simulate(SimConfig()),
                                          SlamConfig())[0])
    return _perturbed(jg)


@pytest.fixture(scope="module")
def band_graph():
    jg = j_syn.make_large_problem(
        num_poses=2100, num_landmarks=1500, obs_per_pose=5, seed=4,
        pose_bucket=64, landmark_bucket=64, edge_bucket=256)[0]
    return _perturbed(attach_plan(jg, want_band=False), seed=1)


def test_exact_odom_jacobians_match_jax(main_graph):
    jg, tg = main_graph
    o = jg.odom
    jev = j_res.eval_odom_edges(jg.poses, o.i, o.j, o.meas, o.info, o.mask,
                                1.5, exact=True)
    tev = t_res.eval_odom_edges(tg.poses, tg.odom.i, tg.odom.j,
                                tg.odom.meas, tg.odom.info, tg.odom.mask,
                                1.5, exact=True)
    for name in ("r", "JA", "JB", "chi2", "w", "robust_err"):
        assert _rel(getattr(tev, name), getattr(jev, name)) < 1e-5, name
    # not the ±I approximation
    assert float((tev.JA + torch.eye(3)).abs().max()) > 0.1


@pytest.mark.parametrize("exact", [False, True])
def test_assemble_blocks_matches_jax(main_graph, exact):
    jg, tg = main_graph
    js = j_schur.assemble_blocks(jg, 1.5, exact_odom_jacobians=exact)
    ts = t_schur.assemble_blocks(tg, 1.5, exact_odom_jacobians=exact)
    for name in js._fields:
        ref = getattr(js, name)
        if name == "hpp_diag":   # without the 1e6 gauge prior of pose 0
            ref, port = np.asarray(ref)[1:], getattr(ts, name)[1:]
        else:
            port = getattr(ts, name)
        assert _rel(port, ref) < 1e-5, name


def test_chol_small_matches_jax():
    rng = np.random.default_rng(0)
    for k in (2, 3):
        a = rng.normal(size=(64, k, k))
        a = (a @ a.transpose(0, 2, 1) + 0.1 * np.eye(k)).astype(np.float32)
        a[0, 0, 0] = 0.0              # a clamped first pivot
        jl = j_schur._chol_small(jnp.asarray(a))
        tl = t_schur._chol_small(torch.as_tensor(a))
        assert _rel(tl, jl) < 1e-6
        assert torch.isfinite(tl).all()


def test_spd_inverse_matches_jax():
    """At equilibrated cond 1e4 (the call sites' envelope), both converge
    to the f32 floor: rel 1e-3, and exactly symmetric."""
    rng = np.random.default_rng(3)
    q, _ = np.linalg.qr(rng.standard_normal((96, 96)))
    d = np.geomspace(1.0, 1e4, 96)
    a = ((q * d) @ q.T).astype(np.float32)
    jx = np.asarray(j_schur.spd_inverse(jnp.asarray(a)))
    tx = t_schur.spd_inverse(torch.as_tensor(a))
    assert torch.equal(tx, tx.T)
    assert _rel(tx, jx) < 1e-3
    want = np.linalg.inv(a.astype(np.float64))
    assert _rel(tx, want) < 5e-2


@pytest.mark.parametrize("which", ["main", "band"])
def test_build_coarse_precond_matches_jax(which, main_graph, band_graph):
    jg, tg = main_graph if which == "main" else band_graph
    group = 16 if which == "main" else 64
    jd = j_schur.damp(j_schur.assemble_blocks(jg, 1.5), jnp.float32(LAM))
    td = t_schur.damp(t_schur.assemble_blocks(tg, 1.5), torch.tensor(LAM))
    jc = j_schur.build_coarse_precond(jd, j_schur.inv_blocks(jd.hll), jg,
                                      group)
    tc = t_schur.build_coarse_precond(td, t_schur.inv_blocks(td.hll), tg,
                                      group)
    nc = -(-tg.num_poses // group)
    assert tc.shape == (3 * nc, 3 * nc)
    assert torch.equal(tc, tc.T)
    assert _rel(tc, jc) < 1e-3


@pytest.mark.parametrize("precond", ["jacobi+coarse", "tridiag+coarse"])
def test_fused_coarse_precond_matches_jax(precond, main_graph):
    jg, tg = main_graph
    jd = j_schur.damp(j_schur.assemble_blocks(jg, 1.5), jnp.float32(LAM))
    td = t_schur.damp(t_schur.assemble_blocks(tg, 1.5), torch.tensor(LAM))
    jhi, thi = j_schur.inv_blocks(jd.hll), t_schur.inv_blocks(td.hll)
    jpre = j_fp.build_fused_precond(
        jd, jhi, jg, j_schur.schur_s_diag(jd, jhi, jg), precond, 64)
    tpre = t_fp.build_fused_precond(
        td, thi, tg, t_schur.schur_s_diag(td, thi, tg), precond, 64)
    assert torch.equal(tpre.rmat, torch.as_tensor(np.asarray(jpre.rmat)))
    assert _rel(tpre.cinv, jpre.cinv) < 1e-3
    for name in ("alphas", "gammas", "binv"):
        if getattr(tpre, name).numel():
            assert _rel(getattr(tpre, name), getattr(jpre, name)) < 1e-5
