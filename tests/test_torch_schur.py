"""Linearization and Schur blocks of the PyTorch port against the JAX
package on the 150-pose main-path graph: SE(2) ops, residuals, per-edge
blocks, the block assembly, the landmark elimination pieces and the PCR
preconditioner build.

Tolerance: ``max|port - jax| <= 1e-5 * max|jax|`` per array.  Both sides
are float32 with sums in other orders; the gauge-fixed pose 0 carries a
1e6 prior, so the pose-diagonal arrays are compared without it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toyslam_tpu.config import SimConfig, SlamConfig
from toyslam_tpu.ops import edge_blocks as j_eb
from toyslam_tpu.ops import residuals as j_res
from toyslam_tpu.ops import schur as j_schur
from toyslam_tpu.ops import se2 as j_se2
from toyslam_tpu.ops.gather_plan import attach_plan
from toyslam_tpu.sim import frontend
from toyslam_torch.bridge import graph_from_arrays
from toyslam_torch.ops import edge_blocks as t_eb
from toyslam_torch.ops import residuals as t_res
from toyslam_torch.ops import schur as t_schur
from toyslam_torch.ops import se2 as t_se2

torch.set_num_threads(1)
RTOL = 1e-5
LAM = 1e-3


def _close(port, ref, rtol=RTOL):
    port = port.detach().double().numpy() if torch.is_tensor(port) \
        else np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    scale = np.abs(ref).max()
    assert np.abs(port - ref).max() <= rtol * scale, (
        np.abs(port - ref).max() / scale)


@pytest.fixture(scope="module")
def graphs():
    jg = attach_plan(frontend.build_graph(frontend.simulate(SimConfig()),
                                          SlamConfig())[0])
    return jg, graph_from_arrays(jg)


@pytest.fixture(scope="module")
def moved(graphs):
    """The graphs at a perturbed state: at the dead-reckoned start the
    odometry residuals are f32 rounding noise."""
    jg, tg = graphs
    rng = np.random.default_rng(7)
    poses = np.asarray(jg.poses) + rng.normal(
        0.0, [0.3, 0.3, 0.05], jg.poses.shape).astype(np.float32)
    lms = np.asarray(jg.landmarks) + rng.normal(
        0.0, 0.3, jg.landmarks.shape).astype(np.float32)
    return (jg.with_state(jnp.asarray(poses), jnp.asarray(lms)),
            tg.with_state(torch.as_tensor(poses), torch.as_tensor(lms)))


@pytest.fixture(scope="module")
def systems(graphs):
    jg, tg = graphs
    js = j_schur.assemble_blocks(jg, 1.5)
    ts = t_schur.assemble_blocks(tg, 1.5)
    jd = j_schur.damp(js, jnp.float32(LAM))
    td = t_schur.damp(ts, torch.tensor(LAM))
    return js, ts, jd, td


def _poses(seed, n=64):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(n, 3)).astype(np.float32) * [5.0, 5.0, 2.0]
    return p.astype(np.float32)


@pytest.mark.parametrize("fn", ["compose", "relative", "retract"])
def test_se2_binary(fn):
    a, b = _poses(0), _poses(1)
    _close(getattr(t_se2, fn)(torch.as_tensor(a), torch.as_tensor(b)),
           getattr(j_se2, fn)(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("fn", ["inverse", "radial_to_euclidean",
                                "inv_transform_point", "wrap_angle"])
def test_se2_unary(fn):
    a, b = _poses(2), _poses(3)
    if fn == "inv_transform_point":
        args_t = (torch.as_tensor(a), torch.as_tensor(b[:, :2]))
        args_j = (jnp.asarray(a), jnp.asarray(b[:, :2]))
    elif fn == "radial_to_euclidean":
        args_t, args_j = (torch.as_tensor(a[:, :2]),), (jnp.asarray(a[:, :2]),)
    elif fn == "wrap_angle":
        args_t, args_j = (torch.as_tensor(a[:, 2] * 4),), (jnp.asarray(a[:, 2] * 4),)
    else:
        args_t, args_j = (torch.as_tensor(a),), (jnp.asarray(a),)
    _close(getattr(t_se2, fn)(*args_t), getattr(j_se2, fn)(*args_j))


def test_huber_weights():
    chi2 = np.array([0.0, 1.0, 2.25, 2.26, 10.0, 1e4], np.float32)
    for a, b in zip(t_res.huber_weights(torch.as_tensor(chi2), 1.5),
                    j_res.huber_weights(jnp.asarray(chi2), 1.5)):
        _close(a, b)


def test_odom_residuals(moved):
    jg, tg = moved
    o, p = jg.odom, tg.odom
    a = t_res.eval_odom_edges(tg.poses, p.i, p.j, p.meas, p.info, p.mask, 1.5)
    b = j_res.eval_odom_edges(jg.poses, o.i, o.j, o.meas, o.info, o.mask, 1.5)
    for name in b._fields:
        _close(getattr(a, name), getattr(b, name))


def test_landmark_residuals(moved):
    jg, tg = moved
    o, p = jg.lm_edges, tg.lm_edges
    a = t_res.eval_landmark_edges(tg.poses, tg.landmarks, p.pose, p.lm,
                                  p.meas, p.info, p.mask, 1.5)
    b = j_res.eval_landmark_edges(jg.poses, jg.landmarks, o.pose, o.lm,
                                  o.meas, o.info, o.mask, 1.5)
    assert float(b.w.min()) < 1.0      # the Huber branch is exercised
    for name in b._fields:
        _close(getattr(a, name), getattr(b, name))


def test_exact_odom_jacobians_not_ported(graphs):
    """Exact odometry Jacobians run (held against the reference in
    test_torch_coarse.py); with loop closures the gate declines the
    kernels, as the reference's does, and the plain PCG loop runs them
    (tests/test_torch_pcg.py)."""
    import dataclasses

    from toyslam_torch.config import OptimizerConfig
    from toyslam_torch.ops import fused_pcg as t_fp
    from toyslam_torch.ops.gather_plan import attach_plan as t_attach

    _, tg = graphs
    p = tg.odom
    ev = t_res.eval_odom_edges(tg.poses, p.i, p.j, p.meas, p.info, p.mask,
                               1.5, exact=True)
    assert torch.isfinite(ev.JA).all() and torch.isfinite(ev.JB).all()
    sys = t_schur.assemble_blocks(tg, 1.5, exact_odom_jacobians=True)
    assert torch.isfinite(sys.hpp_off).all()
    k = int(torch.nonzero(p.mask == 0)[0])
    i, j, mask = p.i.clone(), p.j.clone(), p.mask.clone()
    i[k], j[k], mask[k] = 10, 120, 1.0           # a loop closure
    closed = t_attach(dataclasses.replace(
        tg, odom=dataclasses.replace(p, i=i, j=j, mask=mask), plan=None))
    cfg = OptimizerConfig(solver="schur", exact_odom_jacobians=True)
    assert t_fp.fused_mode(cfg, closed) is None
    assert t_fp.fused_mode(cfg, tg) == "resident"


def test_edge_blocks(moved):
    jg, tg = moved
    o, p = jg.odom, tg.odom
    a = t_eb.odom_edge_blocks(tg.poses, p.i, p.j, p.meas, p.info, p.mask, 1.5)
    b = j_eb.odom_edge_blocks(jg.poses, o.i, o.j, o.meas, o.info, o.mask, 1.5)
    for name in b._fields:
        _close(getattr(a, name), getattr(b, name))
    o, p = jg.lm_edges, tg.lm_edges
    a = t_eb.lm_edge_blocks(tg.poses, tg.landmarks, p.pose, p.lm, p.meas,
                            p.info, p.mask, 1.5)
    b = j_eb.lm_edge_blocks(jg.poses, jg.landmarks, o.pose, o.lm, o.meas,
                            o.info, o.mask, 1.5)
    for name in b._fields:
        _close(getattr(a, name), getattr(b, name))


@pytest.mark.parametrize("field", ["hpp_diag", "hpp_off", "hll", "hpl", "bp",
                                   "bl", "err"])
def test_assemble_blocks(systems, field):
    js, ts, _, _ = systems
    a, b = getattr(ts, field), getattr(js, field)
    if field == "hpp_diag":
        a, b = a[1:], b[1:]
    _close(a, b)


def test_damp_and_small_inverses(systems):
    _, _, jd, td = systems
    _close(td.hll, jd.hll)
    _close(td.hpp_diag[1:], jd.hpp_diag[1:])
    _close(t_schur.inv_blocks(td.hll), j_schur.inv_blocks(jd.hll))
    _close(t_schur.inv_blocks(td.hpp_diag), j_schur.inv_blocks(jd.hpp_diag))


def test_landmark_coupling_matvecs(graphs, systems):
    jg, tg = graphs
    _, _, jd, td = systems
    rng = np.random.default_rng(4)
    xp = rng.normal(size=(jg.num_poses, 3)).astype(np.float32)
    yl = rng.normal(size=(jg.num_landmarks, 2)).astype(np.float32)
    _close(t_schur.hlp_matvec(td, tg.lm_edges.pose, torch.as_tensor(xp),
                              tg.plan),
           j_schur.hlp_matvec(jd, jg.lm_edges.pose, jg.lm_edges.lm, xp,
                              jg.num_landmarks, None, jg.plan))
    _close(t_schur.hpl_matvec(td, tg.lm_edges.lm, torch.as_tensor(yl),
                              tg.plan),
           j_schur.hpl_matvec(jd, jg.lm_edges.pose, jg.lm_edges.lm, yl,
                              jg.num_poses, None, jg.plan))


def test_chain_upper_sdiag_and_tridiag_precond(graphs, systems):
    jg, tg = graphs
    _, _, jd, td = systems
    j_up = j_schur.chain_upper(jd, jg.odom.i, jg.odom.j, jg.num_poses)
    t_up = t_schur.chain_upper(td, tg.odom.i, tg.odom.j, tg.num_poses)
    _close(t_up, j_up)
    j_sd = j_schur.schur_s_diag(jd, j_schur.inv_blocks(jd.hll), jg)
    t_sd = t_schur.schur_s_diag(td, t_schur.inv_blocks(td.hll), tg)
    _close(t_sd[1:], j_sd[1:])
    jp = j_schur.build_tridiag_precond(j_sd, j_up)
    tp = t_schur.build_tridiag_precond(t_sd, t_up)
    assert tp.alphas.shape == (8, 192, 3, 3)
    for name in jp._fields:
        _close(getattr(tp, name), getattr(jp, name))
