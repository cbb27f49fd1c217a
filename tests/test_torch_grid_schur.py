"""The grid solver of the PyTorch port (``solver="schur_grid"``,
``ops/grid_schur.py``) and its band operator against the JAX package:

* ``build_grid_plan`` field for field on a 600-pose graph, and its
  ``ValueError``s (non-chain odometry, two edges on one chain pair);
* the grid assembly, matvec and S diagonal at 1e-5 of each array's scale
  (pose 0's 1e6 gauge prior left out);
* ``build_grid_band`` (the JAX layout field for field, plus the kernel's
  ``cover`` table) and ``build_band_operator_grid``'s tiles and wide
  columns at 1e-5 on the 2100-pose graph of tests/test_band_fused.py;
* four GN iterations of ``schur_grid`` (the bench suite's 10k config) at
  rtol 1e-2 on chi^2, tests/test_grid_schur.py's bar;
* the band mode of the grid solve (B2's plain version on the CPU) against
  the plain grid loop on converged solves, at 2e-4 of max|dx|;
* the band gate: ``_band_mode``'s static refusals and ``_band_cost_wins``'
  decisions on stubs.

``python tests/test_torch_grid_schur.py`` prints the JAX package's
reference values of chip_smoke.py's grid rows (``GRID_REF``).
"""

import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toyslam_tpu.config import OptimizerConfig as JOpt
from toyslam_tpu.ops import fused_pcg as j_fp
from toyslam_tpu.ops import grid_schur as j_gs
from toyslam_tpu.ops import schur as j_schur
from toyslam_tpu.optimizer.gauss_newton import GaussNewton as JGN
from toyslam_tpu.sim import frontend as jf
from toyslam_tpu.sim import synthetic as j_syn
from toyslam_torch.bridge import graph_from_arrays
from toyslam_torch.config import OptimizerConfig as TOpt
from toyslam_torch.ops import band_plan as t_bp
from toyslam_torch.ops import fused_pcg as t_fp
from toyslam_torch.ops import grid_schur as t_gs
from toyslam_torch.ops import schur as t_schur
from toyslam_torch.optimizer import GaussNewton as TGN

ROOT = Path(__file__).resolve().parent.parent
torch.set_num_threads(1)
LAM = 1e-3
# the bench suite's 10k config (scripts/bench_suite.py:284-290)
BENCH = dict(iterations=15, lr=1.0, solver="schur_grid",
             exact_odom_jacobians=True, pcg_tol=1e-2, pcg_max_iters=15,
             pcg_restart_every=15, pcg_precond="tridiag+coarse",
             pcg_coarse_group=32, pcg_precond_refresh=5, pcg_backend="auto",
             pcg_fused_chunk=15)


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _close(port, ref, rtol=1e-5):
    port, ref = _np(port).astype(np.float64), _np(ref).astype(np.float64)
    assert port.shape == ref.shape
    err = np.abs(port - ref).max() / np.abs(ref).max()
    assert err <= rtol, err


@pytest.fixture(scope="module")
def g600():
    jg = j_syn.make_large_problem(
        num_poses=600, num_landmarks=600, obs_per_pose=6, seed=0,
        pose_bucket=64, landmark_bucket=64, edge_bucket=512)[0]
    return jg, graph_from_arrays(jg)


@pytest.fixture(scope="module")
def g2100():
    jg = j_syn.make_large_problem(
        num_poses=2100, num_landmarks=1500, obs_per_pose=5, seed=4,
        pose_bucket=64, landmark_bucket=64, edge_bucket=256)[0]
    return jg, graph_from_arrays(jg)


def test_build_grid_plan_matches_jax(g600):
    jg, tg = g600
    jp = j_gs.build_grid_plan(jg)
    tp = t_gs.build_grid_plan(tg)
    assert jp.band is None and tp.band is None        # under 2048 poses
    for f in dataclasses.fields(jp):
        if f.name != "band":
            np.testing.assert_array_equal(_np(getattr(tp, f.name)),
                                          np.asarray(getattr(jp, f.name)),
                                          err_msg=f.name)
    assert tp.L_pose.dtype == torch.int64 and tp.C_info.dtype == torch.float32


def test_build_grid_plan_refuses_non_chain_odometry(g600):
    _, tg = g600
    o = tg.odom
    k = int(torch.nonzero(o.mask == 0)[0])
    i, j, mask = o.i.clone(), o.j.clone(), o.mask.clone()
    i[k], j[k], mask[k] = 10, 120, 1.0                # a loop closure
    bad = dataclasses.replace(tg, odom=dataclasses.replace(
        o, i=i, j=j, mask=mask))
    with pytest.raises(ValueError, match="chain-only"):
        t_gs.build_grid_plan(bad)
    j[k] = 11                                         # a second (10, 11) edge
    bad = dataclasses.replace(tg, odom=dataclasses.replace(
        o, i=i, j=j, mask=mask))
    with pytest.raises(ValueError, match="at most one"):
        t_gs.build_grid_plan(bad)


@pytest.mark.parametrize("exact", [False, True], ids=["identity", "exact"])
def test_grid_assembly_and_matvec_match_jax(g600, exact):
    jg, tg = g600
    jp, tp = j_gs.build_grid_plan(jg), t_gs.build_grid_plan(tg)
    jcfg = JOpt(solver="schur_grid", exact_odom_jacobians=exact)
    tcfg = TOpt(solver="schur_grid", exact_odom_jacobians=exact)
    js, ts = j_gs._assemble(jg, jp, jcfg), t_gs._assemble(tg, tp, tcfg)
    assert (ts.kl, ts.kp) == (js.kl, js.kp)
    _close(ts.hpp_diag[1:], np.asarray(js.hpp_diag)[1:])
    for name in ("tupper", "hll", "bp", "bl", "err", "hpl_L", "hpl_P"):
        _close(getattr(ts, name), getattr(js, name))
    jd, td = j_gs._damp(js, jnp.float32(LAM)), t_gs._damp(ts, torch.tensor(LAM))
    jhi, thi = j_schur.inv_blocks(jd.hll), t_schur.inv_blocks(td.hll)
    jmv, jsd = j_gs._matvec_factory(jd, jhi, jp, jg.num_poses,
                                    jg.num_landmarks)
    tmv, tsd = t_gs._matvec_factory(td, thi, tp, tg.num_poses,
                                    tg.num_landmarks)
    x = np.random.default_rng(2).normal(size=(jg.num_poses, 3))
    x = x.astype(np.float32)
    _close(tmv(torch.as_tensor(x))[1:], np.asarray(jmv(jnp.asarray(x)))[1:])
    _close(tsd()[1:], np.asarray(jsd())[1:])
    # the flat view gives the coarse build of the reference
    jc = j_schur.build_coarse_precond(j_gs._flat_system(jd, jg, jp), jhi,
                                      j_gs._FlatGraphView(jg, jp), 32)
    tc = t_schur.build_coarse_precond(t_gs._flat_system(td), thi,
                                      t_gs._FlatGraphView(tg, tp), 32)
    _close(tc, jc, rtol=1e-3)


def test_grid_band_and_operator_match_jax(g2100):
    jg, tg = g2100
    jp, tp = j_gs.build_grid_plan(jg), t_gs.build_grid_plan(tg)
    jb, tb = jp.band, tp.band
    assert jb is not None and tb is not None and tb.n_wide > 0
    for f in ("src_rows", "elem_ids", "wide_slots", "wide_ids", "win_off"):
        np.testing.assert_array_equal(_np(getattr(tb, f)),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    for f in ("chunk_b", "k_windows", "w_row", "n_chunks", "n_wide"):
        assert getattr(tb, f) == getattr(jb, f), f
    # the kernel's cover table: that of the per-edge layout of the graph
    n = tg.num_poses
    np.testing.assert_array_equal(
        _np(tb.cover), t_bp._window_cover(np.asarray(jb.win_off), n,
                                          jb.w_row, 3))
    assert tb.cover.dtype == torch.int32
    t_edge = t_bp.build_band_aux(tg)
    assert torch.equal(tb.cover, t_edge.cover)

    cfg = JOpt(solver="schur_grid", exact_odom_jacobians=True)
    jd = j_gs._damp(j_gs._assemble(jg, jp, cfg), jnp.float32(LAM))
    td = t_gs._damp(t_gs._assemble(tg, tp, TOpt(**BENCH)), torch.tensor(LAM))
    lm_j = jp.P_lm.reshape(n, jd.kp)
    up_j = jd.tupper * jp.C_mask[:, None, None]
    jop = j_fp.build_band_operator_grid(jd.hll, jd.hpl_P, lm_j, jd.hpp_diag,
                                        up_j, jb, n)
    top = t_fp.build_band_operator_grid(
        td.hll, td.hpl_P, tp.P_lm.reshape(n, td.kp), td.hpp_diag,
        td.tupper * tp.C_mask[:, None, None], tb, n)
    assert top.u.shape == (3, 2 * tb.n_wide, n)
    for name in ("tiles", "u", "tupper", "tlower"):
        _close(getattr(top, name), getattr(jop, name))
    _close(top.tdiag[..., 1:], np.asarray(jop.tdiag)[..., 1:])
    assert torch.equal(top.cover, tb.cover)


def test_grid_gn_matches_jax(g600):
    """Four GN iterations of the bench suite's 10k config (the plain grid
    loop on both sides: no band layout under 2048 poses)."""
    jg, tg = g600
    cfg = dict(BENCH, iterations=4)
    jr = JGN(JOpt(**cfg)).optimize(jg)
    before = t_fp.band_fused_pcg_chunk.launches
    tr = TGN(TOpt(**cfg)).optimize(tg)
    assert t_fp.band_fused_pcg_chunk.launches == before
    assert isinstance(tr.graph.plan, t_gs.GridPlan)
    np.testing.assert_allclose(tr.errors.numpy(), np.asarray(jr.errors),
                               rtol=1e-2)
    assert tr.pcg_iters.tolist() == np.asarray(jr.pcg_iters).tolist()
    # the same on the general Schur path's plain loop
    sr = TGN(TOpt(**dict(cfg, solver="schur", pcg_backend="xla"))).optimize(
        tg)
    np.testing.assert_allclose(tr.errors.numpy(), sr.errors.numpy(),
                               rtol=1e-2)


@pytest.mark.parametrize("precond", ["tridiag+coarse", "jacobi"])
def test_grid_band_mode_matches_plain_grid_loop(g2100, precond):
    """The grid solve through the band operator and B2's plain version
    against the plain grid loop, both run to the f32 floor (tol 1e-8)."""
    _, tg = g2100
    kw = dict(BENCH, pcg_tol=1e-8, pcg_max_iters=400, pcg_restart_every=40,
              pcg_fused_chunk=8, pcg_coarse_group=64, pcg_precond=precond,
              pcg_precond_refresh=1)
    fused, xla = TOpt(**dict(kw, pcg_backend="fused")), TOpt(
        **dict(kw, pcg_backend="xla"))
    gp = t_gs.build_grid_plan(tg)
    assert t_gs._band_mode(fused, gp, tg.num_poses)
    assert not t_gs._band_mode(xla, gp, tg.num_poses)
    g = dataclasses.replace(tg, plan=gp)
    lam = torch.tensor(LAM)
    pre = t_gs._build_precond(fused, *_parts(fused, g, lam), g, gp)
    assert isinstance(pre, t_fp.FusedPrecond)
    if precond == "tridiag+coarse":
        assert pre.rmat.shape == (tg.num_poses, tg.num_poses // 64)
    before = t_fp.band_fused_pcg_chunk.launches
    bdp, bdl, berr, bst = t_gs._solve_once(fused, g, gp, lam)
    assert t_fp.band_fused_pcg_chunk.launches == before   # CPU: plain version
    pdp, pdl, perr, pst = t_gs._solve_once(xla, g, gp, lam)
    assert float(berr) == float(perr)
    ref = float(pdp.abs().max())
    assert float((bdp - pdp).abs().max()) <= 2e-4 * ref
    assert float((bdl - pdl).abs().max()) <= 2e-4 * max(
        float(pdl.abs().max()), 1.0)
    assert int(bst.pcg_iters) > 0 and int(pst.pcg_iters) > 0


def _parts(cfg, g, lam):
    d = t_gs._damp(t_gs._assemble(g, g.plan, cfg), lam)
    hll_inv = t_schur.inv_blocks(d.hll)
    _, s_diag = t_gs._matvec_factory(d, hll_inv, g.plan, g.num_poses,
                                     g.num_landmarks)
    return d, hll_inv, s_diag()


def test_band_mode_static_refusals(g2100, monkeypatch):
    _, tg = g2100
    gp = t_gs.build_grid_plan(tg)
    n = tg.num_poses
    fused = TOpt(**dict(BENCH, pcg_backend="fused", pcg_coarse_group=64))
    assert t_gs._band_mode(fused, gp, n)
    for change in [dict(pcg_backend="xla"), dict(pcg_unroll=True),
                   dict(pcg_precond="chunk+coarse"),
                   dict(pcg_coarse_group=50)]:
        assert not t_gs._band_mode(dataclasses.replace(fused, **change), gp,
                                   n), change
    assert not t_gs._band_mode(fused, dataclasses.replace(gp, band=None), n)
    # the plain loop's plan skips the band search
    assert t_gs.build_grid_plan(tg, want_band=False).band is None
    monkeypatch.setattr(t_fp, "BAND_BUDGET_BYTES", 2**20)
    assert not t_gs._band_mode(fused, gp, n)


def test_band_cost_model_decisions():
    """The model re-fitted on the H100, on stub layouts: the band kernel
    wins at the bench rows' stacks (it measured ten times cheaper there),
    and the plain grid loop only once a stack's stream outlasts a
    launch-bound loop iteration (past ~4.4 GB)."""

    def stub(stack_bytes):
        band = type("Band", (), {"tile_bytes": stack_bytes})()
        return type("Plan", (), {"band": band})()

    cfg = TOpt(**BENCH)
    for stack, wins in [(245_366_784, True), (179_306_496, True),
                        (48_758_784, True), (2 << 30, True),
                        (5 << 30, False), (8 << 30, False)]:
        assert t_gs._band_cost_wins(cfg, stub(stack), 10240) == wins, stack
    t_band, t_grid = t_gs._cost_model(cfg, stub(245_366_784))
    np.testing.assert_allclose(t_band, 0.9e-3 + 15 * (7.8e-5 + 245_366_784
                                                       / 1.19e12))
    np.testing.assert_allclose(t_grid, 15 * 3.8e-3)
    # a one-iteration budget still pays the build once: the band wins
    one = dataclasses.replace(cfg, pcg_max_iters=1)
    assert t_gs._band_cost_wins(one, stub(245_366_784), 10240)


# --- the reference values of chip_smoke.py --------------------------------


def jax_reference(case: str) -> dict:
    """The JAX package's f32 ``schur_grid`` run with ``pcg_backend="xla"``
    of one of chip_smoke.py's grid rows on the CPU: chi^2 per GN
    iteration, PCG iterations, the final and the dead-reckoning ATE."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    graph_kw, change = chip_smoke.GRID_CASES[case]
    jg, gt, _ = j_syn.make_large_problem(**graph_kw)
    r = JGN(JOpt(**dict(chip_smoke.GRID_BENCH, **change,
                        pcg_backend="xla"))).optimize(jg)
    it = int(r.iterations_run)
    n = gt.shape[0]
    return {
        "case": case,
        "chi2": np.asarray(r.errors)[:it].tolist(),
        "pcg_iters": np.asarray(r.pcg_iters)[:it].tolist(),
        "ate": jf.ate_rmse(np.asarray(r.graph.poses)[:n], gt),
        "ate_dr": jf.ate_rmse(np.asarray(jg.poses)[:n], gt),
    }


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    for case in chip_smoke.GRID_CASES:
        print(json.dumps(jax_reference(case)), flush=True)
