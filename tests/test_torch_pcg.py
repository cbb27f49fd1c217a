"""The plain PCG loop of the PyTorch port (``ops/schur.py``: ``pcg``,
``schur_solve``, the preconditioner applies, the vertex-major operator)
against the JAX package, and the gate's fallback to it.

* ``tridiag_apply``, ``chunk_apply``, ``coarse_apply`` and the operators
  (``plan_matvec``, ``schur_matvec``, ``plan_s_diag``) on the 150-pose
  system: ``max|port - jax| <= 1e-5 * max|jax|`` (pose 0's 1e6 gauge prior
  left out of the matvec's scale);
* ``schur_solve`` at tol 1e-6 against the JAX package's plain loop: dx
  within 1e-3 of its scale (tests/test_fused_pcg.py:130), iteration
  counts within 2;
* ``pcg``'s control (max-iteration masking, the sticky breakdown stop,
  chunked residual replacement) against the JAX ``pcg`` on a small SPD
  system: x at rel 1e-5, the same iteration counts;
* the plain-loop GN on the 150-pose graph: PCG iterations 35, 35, 34, 33,
  33, 32, 32, 32, 31, 31 exactly, chi^2 at rtol 1e-4 per iteration against
  the JAX package's ``pcg_backend="xla"`` run, ATE 0.7552;
* every case where the gate declines the kernels runs the plain loop (no
  launch) and ``pcg_backend="fused"`` raises ``ValueError`` there; the
  SE(3) fallback at dp=6.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toyslam_tpu.config import OptimizerConfig as JOpt
from toyslam_tpu.config import SimConfig as JSim, SlamConfig as JSlam
from toyslam_tpu.ops import schur as j_schur
from toyslam_tpu.ops.gather_plan import attach_plan as j_attach_plan
from toyslam_tpu.optimizer.gauss_newton import GaussNewton as JGN
from toyslam_tpu.sim import frontend as jf
from toyslam_torch.bridge import graph_from_arrays
from toyslam_torch.config import OptimizerConfig as TOpt
from toyslam_torch.config import SimConfig as TSim, SlamConfig as TSlam
from toyslam_torch.ops import fused_pcg as t_fp
from toyslam_torch.ops import schur as t_schur
from toyslam_torch.ops.gather_plan import attach_plan as t_attach_plan
from toyslam_torch.optimizer import GaussNewton as TGN
from toyslam_torch.sim import frontend as tf

torch.set_num_threads(1)
LAM = 1e-3
MAIN_PCG_ITERS = [35, 35, 34, 33, 33, 32, 32, 32, 31, 31]


def _close(port, ref, rtol=1e-5):
    port = port.detach().double().numpy() if torch.is_tensor(port) \
        else np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    err = np.abs(port - ref).max() / np.abs(ref).max()
    assert err <= rtol, err


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.fixture(scope="module")
def main():
    jg = j_attach_plan(jf.build_graph(jf.simulate(JSim()), JSlam())[0])
    tg = graph_from_arrays(jg)
    js, ts = j_schur.assemble_blocks(jg, 1.5), t_schur.assemble_blocks(tg, 1.5)
    jd = j_schur.damp(js, jnp.float32(LAM))
    td = t_schur.damp(ts, torch.tensor(LAM))
    jhi, thi = j_schur.inv_blocks(jd.hll), t_schur.inv_blocks(td.hll)
    sd = j_schur.schur_s_diag(jd, jhi, jg)
    up = j_schur.chain_upper(jd, jg.odom.i, jg.odom.j, jg.num_poses)
    r = np.random.default_rng(3).normal(size=(jg.num_poses, 3))
    return dict(jg=jg, tg=tg, js=js, ts=ts, jd=jd, td=td, jhi=jhi, thi=thi,
                sd=sd, up=up, r=r.astype(np.float32))


@pytest.mark.parametrize("kind", ["tridiag", "chunk", "coarse"])
def test_preconditioner_apply_matches_jax(main, kind):
    """Each apply on the same built preconditioner (the JAX package's),
    and the port's own build of it."""
    r = main["r"]
    if kind == "tridiag":
        jp = j_schur.build_tridiag_precond(main["sd"], main["up"])
        tp = t_schur.TridiagPrecond(*(_t(a) for a in jp))
        _close(t_schur.tridiag_apply(tp, _t(r)), j_schur.tridiag_apply(jp, r))
    elif kind == "chunk":
        jinv = j_schur.build_chunk_precond(main["sd"], main["up"], 64)
        tinv = t_schur.build_chunk_precond(_t(main["sd"]), _t(main["up"]), 64)
        assert tinv.shape == (3, 192, 192)
        _close(tinv, jinv)
        _close(t_schur.chunk_apply(_t(jinv), _t(r)),
               j_schur.chunk_apply(jinv, jnp.asarray(r)))
        # a ragged tail (192 = 2 * 80 + 32)
        jinv = j_schur.build_chunk_precond(main["sd"], main["up"], 80)
        _close(t_schur.build_chunk_precond(_t(main["sd"]), _t(main["up"]),
                                           80), jinv)
        _close(t_schur.chunk_apply(_t(jinv), _t(r)),
               j_schur.chunk_apply(jinv, jnp.asarray(r)))
    else:
        for group in (16, 40):          # 40 leaves a ragged last group
            cinv = j_schur.build_coarse_precond(main["jd"], main["jhi"],
                                                main["jg"], group)
            _close(t_schur.coarse_apply(_t(cinv), group, _t(r)),
                   j_schur.coarse_apply(cinv, group, jnp.asarray(r)))


def test_operators_match_jax(main):
    jd, td, jg, tg = main["jd"], main["td"], main["jg"], main["tg"]
    x = main["r"]
    want = np.asarray(j_schur.schur_matvec(jd, main["jhi"], jg, x))
    op = t_schur.make_plan_operator(td, main["thi"], tg)
    jop = j_schur.make_plan_operator(jd, main["jhi"], jg)
    for name in jop._fields:
        _close(getattr(op, name), getattr(jop, name), rtol=1e-5
               if getattr(jop, name).dtype == jnp.float32 else 0.0)
    _close(t_schur.plan_matvec(op, _t(x))[1:], want[1:])
    _close(t_schur.schur_matvec(td, main["thi"], tg, _t(x))[1:], want[1:])
    _close(t_schur.hpp_matvec(td, tg.odom.i, tg.odom.j, _t(x), tg.plan)[1:],
           np.asarray(j_schur.hpp_matvec(jd, jg.odom.i, jg.odom.j, x, None,
                                         jg.plan))[1:])
    _close(t_schur.plan_s_diag(op)[1:],
           np.asarray(j_schur.plan_s_diag(jop))[1:])


@pytest.mark.parametrize("precond", ["jacobi", "tridiag", "chunk",
                                     "tridiag+coarse", "chunk+coarse"])
def test_schur_solve_matches_jax(main, precond):
    jdp, jdl, jst = j_schur.schur_solve(
        main["js"], main["jg"], jnp.float32(LAM), 1e-6, 400, None, 64,
        precond, 64)
    tdp, tdl, tst = t_schur.schur_solve(
        main["ts"], main["tg"], torch.tensor(LAM), 1e-6, 400, 64, precond,
        64)
    scale = float(np.abs(np.asarray(jdp)).max())
    assert float((tdp - _t(jdp)).abs().max()) / scale < 1e-3
    scale_l = float(np.abs(np.asarray(jdl)).max())
    assert float((tdl - _t(jdl)).abs().max()) / scale_l < 1e-3
    assert abs(int(tst.pcg_iters) - int(jst.pcg_iters)) <= 2
    assert int(tst.pcg_iters) < 400


def _spd(sign, n=40, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(3 * n, 3 * n)) / np.sqrt(3 * n)
    m = sign * (a @ a.T + 0.05 * np.eye(3 * n))
    return m.astype(np.float32), rng.normal(size=(n, 3)).astype(np.float32)


@pytest.mark.parametrize("case", ["maxit_masks", "breakdown_stops",
                                  "restart_chunks", "converges"])
def test_pcg_control_matches_jax(case):
    m, rhs = _spd(-1.0 if case == "breakdown_stops" else 1.0)
    max_iters, restart, tol = {
        "maxit_masks": (5, 16, 1e-7), "breakdown_stops": (16, 16, 1e-7),
        "restart_chunks": (30, 4, 1e-7), "converges": (400, 64, 1e-4),
    }[case]
    n = rhs.shape[0]
    dinv = (1.0 / np.diag(m)).reshape(n, 3).astype(np.float32)
    jm = jnp.asarray(m)
    jres = j_schur.pcg(lambda x: (jm @ x.reshape(-1)).reshape(n, 3),
                       lambda r: r * dinv, jnp.asarray(rhs), tol, max_iters,
                       restart)
    tm = _t(m)
    tres = t_schur.pcg(lambda x: (tm @ x.reshape(-1)).reshape(n, 3),
                       lambda r: r * _t(dinv), _t(rhs), tol, max_iters,
                       restart)
    assert int(tres.iterations) == int(jres.iterations)
    if case == "breakdown_stops":
        assert int(tres.iterations) == 0
        assert float(tres.x.abs().max()) == 0.0
    else:
        _close(tres.x, jres.x)
    if case == "converges":
        # both stop at the tolerance; the residuals there are f32 noise
        assert int(tres.iterations) < 400
        assert float(tres.residual_norm) <= tol * np.linalg.norm(rhs)
    else:
        np.testing.assert_allclose(float(tres.residual_norm),
                                   float(jres.residual_norm), rtol=1e-3)
    with pytest.raises(NotImplementedError, match="pcg_unroll"):
        t_schur.pcg(lambda x: x, lambda r: r, _t(rhs), tol, 4, unroll=True)


MAIN = dict(iterations=10, lr=0.2, solver="schur", pcg_precond="tridiag")


def test_plain_loop_gn_matches_jax():
    cfg = dict(MAIN, pcg_backend="xla")
    jg = jf.build_graph(jf.simulate(JSim()), JSlam())[0]
    sim = tf.simulate(TSim())
    tg = tf.build_graph(sim, TSlam())[0]
    before = t_fp.fused_pcg_chunk.launches
    tr = TGN(TOpt(**cfg)).optimize(tg)
    assert t_fp.fused_pcg_chunk.launches == before
    assert tr.pcg_iters.tolist() == MAIN_PCG_ITERS
    jr = JGN(JOpt(**cfg)).optimize(jg)
    assert np.asarray(jr.pcg_iters).tolist() == MAIN_PCG_ITERS
    np.testing.assert_allclose(tr.errors.numpy(), np.asarray(jr.errors),
                               rtol=1e-4)
    np.testing.assert_allclose(tr.errors[0].item(), 228733.53, rtol=1e-4)
    np.testing.assert_allclose(tr.errors[-1].item(), 27524.89, rtol=1e-3)
    np.testing.assert_allclose(tr.graph.poses.numpy(),
                               np.asarray(jr.graph.poses), atol=1e-3)
    n = sim.poses_gt.shape[0]
    assert abs(tf.ate_rmse(tr.graph.poses[:n], sim.poses_gt) - 0.7552) <= 2e-3


def _closure(tg):
    """The graph plus two loop-closure odometry edges in padded slots."""
    o = tg.odom
    i, j, mask = o.i.clone(), o.j.clone(), o.mask.clone()
    meas, info = o.meas.clone(), o.info.clone()
    for k, (a, b) in zip(torch.nonzero(mask == 0)[:2, 0].tolist(),
                         [(5, 30), (12, 36)]):
        i[k], j[k], mask[k] = a, b, 1.0
        meas[k] = torch.tensor([0.1, 0.05, 0.02])
        info[k] = torch.diag(torch.tensor([4.0, 4.0, 20.0]))
    return dataclasses.replace(tg, odom=dataclasses.replace(
        o, i=i, j=j, mask=mask, meas=meas, info=info), plan=None)


SMALL = dict(MAIN, iterations=3)


@pytest.mark.parametrize("case", [
    "xla", "chunk", "closure_exact", "coarse_group", "past_resident",
])
def test_gate_falls_back_to_the_plain_loop(case, monkeypatch):
    """Each case the gate used to refuse now runs the plain loop, with no
    kernel launch and the bits of the same config at
    ``pcg_backend="xla"``; ``pcg_backend="fused"`` raises there."""
    tg = tf.build_graph(tf.simulate(TSim(robot_steps=40)), TSlam())[0]
    change = {
        "xla": dict(pcg_backend="xla"),
        "chunk": dict(pcg_precond="chunk", pcg_chunk=16),
        "closure_exact": dict(exact_odom_jacobians=True),
        "coarse_group": dict(pcg_precond="tridiag+coarse",
                             pcg_coarse_group=7),
        "past_resident": {},
    }[case]
    if case == "closure_exact":
        tg = _closure(tg)
    if case == "past_resident":
        monkeypatch.setattr(t_fp, "SLAB_BUDGET_BYTES", 0)
    cfg = TOpt(**dict(SMALL, **change))
    gp = t_attach_plan(tg)
    assert t_fp.fused_mode(cfg, gp) is None
    assert not t_fp.fused_supported(cfg, gp)
    launches = t_fp.fused_pcg_chunk.launches
    r = TGN(cfg).optimize(tg)
    assert t_fp.fused_pcg_chunk.launches == launches
    x = TGN(dataclasses.replace(cfg, pcg_backend="xla")).optimize(tg)
    assert torch.equal(r.errors, x.errors)
    assert torch.equal(r.graph.poses, x.graph.poses)
    assert r.errors[-1] < r.errors[0] and bool(r.pcg_iters.gt(0).all())
    # the stateful solve falls back too
    s = TGN(dataclasses.replace(cfg, pcg_precond_refresh=2)).optimize(tg)
    assert s.errors[-1] < s.errors[0]
    if case != "xla":     # "fused" in place of "xla" admits the kernel
        with pytest.raises(ValueError, match="fused"):
            TGN(dataclasses.replace(cfg, pcg_backend="fused")).optimize(tg)


def test_closure_fallback_matches_jax():
    """Loop closures with exact odometry Jacobians: the JAX package's gate
    declines its kernels too; both plain loops agree."""
    tg = _closure(tf.build_graph(tf.simulate(TSim(robot_steps=40)),
                                 TSlam())[0])
    o = tg.odom
    jg0 = jf.build_graph(jf.simulate(JSim(robot_steps=40)), JSlam())[0]
    jg = dataclasses.replace(jg0, odom=dataclasses.replace(
        jg0.odom, **{f: jnp.asarray(getattr(o, f).numpy()) for f in
                     ("i", "j", "mask", "meas", "info")}))
    cfg = dict(SMALL, exact_odom_jacobians=True)
    tr = TGN(TOpt(**cfg)).optimize(tg)
    jr = JGN(JOpt(**cfg)).optimize(jg)
    np.testing.assert_allclose(tr.errors.numpy(), np.asarray(jr.errors),
                               rtol=1e-4)
    np.testing.assert_allclose(tr.graph.poses.numpy(),
                               np.asarray(jr.graph.poses), atol=1e-3)
    assert np.abs(tr.pcg_iters.numpy() - np.asarray(jr.pcg_iters)).max() <= 2


def test_se3_fallback_matches_jax():
    """The SE(3) solve takes the plain loop at dp=6, dl=3 where the gate
    declines the kernels: one solve against the JAX package's, and a short
    GN run with no launch."""
    from toyslam_tpu.ops import schur3d as j_schur3d
    from toyslam_tpu.sim import synthetic3d as j_syn3
    from toyslam_torch.bridge import graph3d_from_arrays
    from toyslam_torch.ops import schur3d as t_schur3d

    jg = j_attach_plan(j_syn3.make_ba_problem(96, 300, seed=0)[0])
    tg = graph3d_from_arrays(jg)
    kw = dict(solver="schur3d", pcg_tol=1e-6, pcg_max_iters=300,
              pcg_backend="xla")
    js = j_schur3d.assemble_blocks_3d(jg, 1.5)
    jdp, jdl, jst = j_schur.schur_solve(js, jg, jnp.float32(LAM), 1e-6,
                                        300, None, 64, "tridiag", 64)
    assert t_fp.fused_mode(TOpt(**kw), tg) is None
    solve = t_schur3d.schur3d_linearize_solve(TOpt(**kw))
    tdp, tdl, err, tst = solve(tg, torch.tensor(LAM))
    assert tdp.shape == (tg.num_poses, 6) and tdl.shape[-1] == 3
    np.testing.assert_allclose(float(err), float(js.err), rtol=1e-5)
    scale = float(np.abs(np.asarray(jdp)).max())
    assert float((tdp - _t(jdp)).abs().max()) / scale < 1e-3
    assert int(tst.pcg_iters) < 300
    launches = t_fp.fused_pcg_chunk.launches
    r = TGN(TOpt(**dict(kw, iterations=2, lr=1.0,
                        reject_worse_steps=True))).optimize(tg)
    assert t_fp.fused_pcg_chunk.launches == launches
    assert r.errors[1] <= r.errors[0]
