"""The streamed band solve of the PyTorch port against the JAX package, on
the 2100-pose graph of tests/test_band_fused.py.

* ``build_band_operator``: tiles, wide columns and T planes at
  1e-5 * max|ref| (the same f32 formulas in another operation order);
* the plain band matvec against the JAX package's ``schur.schur_matvec``
  oracle at 1e-5 (pose 0's 1e6 gauge prior left out of the scale);
* the band solve against the JAX package's plain PCG ``schur_solve`` at
  tol 1e-8 with 2e-4 of max|dx| (tests/test_band_fused.py's bar) for
  "tridiag+coarse" and "jacobi+coarse";
* one-chunk control (max-iteration masking, breakdown stop, carried
  chunks) of the plain band chunk against the JAX band kernel in Pallas
  interpret mode, on a tiny synthetic layout with L=0 (the JAX kernel
  keeps the PCR planes in bf16, so with L=0 both sides are f32): x at rel
  1e-5, the same iteration counts;
* the gate picks "band" past the resident budget, and the plain loop
  (None) without a layout or past the device-memory budget.

The kernel itself runs only on the card (tests/test_torch_kernel.py,
chip_smoke.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toyslam_tpu.ops import fused_pcg as j_fp
from toyslam_tpu.ops import schur as j_schur
from toyslam_tpu.ops.gather_plan import attach_plan
from toyslam_tpu.sim import synthetic as j_syn
from toyslam_torch.bridge import graph_from_arrays
from toyslam_torch.config import OptimizerConfig
from toyslam_torch.ops import band_plan as t_bp
from toyslam_torch.ops import fused_pcg as t_fp
from toyslam_torch.ops import schur as t_schur

torch.set_num_threads(1)
LAM = 1e-3


def _rel(port, ref):
    port = port.detach().double().numpy() if torch.is_tensor(port) \
        else np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    return float(np.abs(port - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def big():
    jg = attach_plan(j_syn.make_large_problem(
        num_poses=2100, num_landmarks=1500, obs_per_pose=5, seed=4,
        pose_bucket=64, landmark_bucket=64, edge_bucket=256)[0])
    tg = graph_from_arrays(jg)
    js = j_schur.assemble_blocks(jg, 1.5)
    ts = t_schur.assemble_blocks(tg, 1.5)
    jd = j_schur.damp(js, jnp.float32(LAM))
    td = t_schur.damp(ts, torch.tensor(LAM))
    return dict(jg=jg, tg=tg, js=js, ts=ts, jd=jd, td=td,
                jhi=j_schur.inv_blocks(jd.hll),
                thi=t_schur.inv_blocks(td.hll))


def test_build_band_operator_matches_jax(big):
    jop = j_fp.build_band_operator(big["jd"], big["jhi"], big["jg"])
    top = t_fp.build_band_operator(big["td"], big["thi"], big["tg"])
    n_wide = big["tg"].plan.band.n_wide
    assert top.u is not None and n_wide > 0
    assert top.u.shape == (3, 2 * n_wide, big["tg"].num_poses)
    for name in ("tiles", "u", "tdiag", "tupper", "tlower"):
        assert _rel(getattr(top, name), getattr(jop, name)) <= 1e-5, name
    assert torch.equal(top.win_off, torch.as_tensor(np.asarray(jop.win_off)))


def test_band_matvec_matches_jax_oracle(big):
    top = t_fp.build_band_operator(big["td"], big["thi"], big["tg"])
    x = np.random.default_rng(0).normal(
        size=(big["tg"].num_poses, 3)).astype(np.float32)
    want = np.asarray(j_schur.schur_matvec(big["jd"], big["jhi"], big["jg"],
                                           jnp.asarray(x)))
    xt = torch.as_tensor(x).T.contiguous()
    got = t_fp.band_matvec_ref(top, xt).T
    assert _rel(got[1:], want[1:]) < 1e-5
    # the fill V V^T x alone, where a dropped cross-window term would show:
    # at the f32 floor of the T x it is taken from
    tx = t_fp.band_matvec_ref(top._replace(tiles=torch.zeros_like(top.tiles),
                                           u=None), xt).T
    assert _rel(tx[1:] - got[1:], tx[1:].numpy() - want[1:]) < 1e-4


@pytest.mark.parametrize("precond", ["tridiag+coarse", "jacobi+coarse"])
def test_band_solve_matches_jax_plain_pcg(big, precond):
    cfg = OptimizerConfig(solver="schur", pcg_tol=1e-8, pcg_max_iters=400,
                          pcg_precond=precond, pcg_fused_chunk=8,
                          pcg_coarse_group=64)
    assert t_fp.fused_mode(cfg, big["tg"]) == "band"
    tdp, tdl, tst = t_fp.fused_schur_solve(
        big["ts"], big["tg"], torch.tensor(LAM), cfg.pcg_tol,
        cfg.pcg_max_iters, cfg.pcg_precond, cfg.pcg_coarse_group,
        cfg.pcg_fused_chunk, cfg.pcg_restart_every, mode="band")
    jdp, jdl, _ = j_schur.schur_solve(
        big["js"], big["jg"], jnp.float32(LAM), cfg.pcg_tol,
        cfg.pcg_max_iters, precond=precond, coarse_group=64)
    ref = np.abs(np.asarray(jdp)).max()
    np.testing.assert_allclose(tdp.numpy(), np.asarray(jdp), atol=2e-4 * ref)
    np.testing.assert_allclose(
        tdl.numpy(), np.asarray(jdl),
        atol=2e-4 * max(np.abs(np.asarray(jdl)).max(), 1.0))
    assert int(tst.pcg_iters) > 0


def _tiny_band(sign=1.0, seed=0, np_=256, n_chunks=2, k_win=2, w_row=128,
               b_dl=128, mw=2):
    """A small SPD (or, with sign=-1, negative definite) band system,
    block-Jacobi preconditioned, as numpy arrays."""
    rng = np.random.default_rng(seed)
    win_off = np.array([[0, 128], [128, 128]], np.int32)[:n_chunks, :k_win]
    tiles = rng.normal(0.0, 0.01, (n_chunks, k_win, 3, w_row, b_dl))
    u = rng.normal(0.0, 0.02, (3, mw, np_))
    eye = np.broadcast_to(np.eye(3)[..., None], (3, 3, np_))
    up = np.zeros((3, 3, np_))
    up[:, :, :-1] = -0.5 * np.eye(3)[..., None]
    lo = np.roll(up.transpose(1, 0, 2), 1, axis=-1)
    f32 = lambda a: np.ascontiguousarray(a, np.float32)  # noqa: E731
    op = dict(tiles=f32(tiles), win_off=win_off, u=f32(u),
              tdiag=f32(sign * 4.0 * eye), tupper=f32(up), tlower=f32(lo))
    al = np.zeros((0, 3, 3, np_), np.float32)
    pre = (al, al, f32((sign / 4.0) * eye), None, None)
    return op, pre, f32(rng.normal(size=(3, np_))), np_, w_row


@pytest.mark.parametrize("case", ["maxit_masks", "breakdown_stops",
                                  "carried_chunks"])
def test_band_chunk_control_matches_jax_band_kernel(case):
    sign = -1.0 if case == "breakdown_stops" else 1.0
    op, pre, rhs, np_, w_row = _tiny_band(sign)
    max_iters, chunk = {"maxit_masks": (5, 16), "breakdown_stops": (16, 16),
                        "carried_chunks": (30, 4)}[case]
    jop = j_fp.BandOperator(**{k: jnp.asarray(v) for k, v in op.items()})
    jres = j_fp.band_fused_pcg(
        jop, j_fp.FusedPrecond(*(None if a is None else jnp.asarray(a)
                                 for a in pre)),
        jnp.asarray(rhs), 1e-7, max_iters, chunk, restart_every=8)
    cover = t_bp._window_cover(op["win_off"], np_, w_row, 3)
    top = t_fp.BandOperator(
        cover=torch.as_tensor(cover.astype(np.int32)),
        **{k: torch.as_tensor(v) for k, v in op.items()})
    tres = t_fp.band_fused_pcg(
        top, t_fp.FusedPrecond(*(None if a is None else torch.as_tensor(a)
                                 for a in pre)),
        torch.as_tensor(rhs), 1e-7, max_iters, chunk, restart_every=8)
    assert int(tres.iterations) == int(jres.iterations)
    if case == "breakdown_stops":
        assert int(tres.iterations) == 0
        assert float(tres.x.abs().max()) == 0.0
    else:
        assert _rel(tres.x, jres.x) < 1e-5
    assert abs(float(tres.residual_norm) - float(jres.residual_norm)) <= \
        1e-4 * float(np.linalg.norm(rhs))


def test_band_chunk_wrapper_on_cpu_runs_plain_version_uncounted():
    op, pre, rhs, np_, w_row = _tiny_band()
    top = t_fp.BandOperator(
        cover=torch.as_tensor(
            t_bp._window_cover(op["win_off"], np_, w_row, 3).astype(np.int32)),
        **{k: torch.as_tensor(v) for k, v in op.items()})
    tpre = t_fp.FusedPrecond(*(None if a is None else torch.as_tensor(a)
                               for a in pre))
    rhs = torch.as_tensor(rhs)
    z = torch.zeros_like(rhs)
    st = t_fp.ChunkState(x=z, r=z, p=z, rt=rhs,
                         it=torch.zeros(1, dtype=torch.int32),
                         rz=torch.zeros(1),
                         stop=torch.zeros(1, dtype=torch.int32),
                         rr=(rhs * rhs).sum().reshape(1))
    atol2 = (1e-12 * (rhs * rhs).sum()).reshape(1)
    before = t_fp.band_fused_pcg_chunk.launches
    a = t_fp.band_fused_pcg_chunk(top, tpre, rhs, st, atol2, 50, True, 4)
    b = t_fp.band_fused_pcg_chunk_ref(top, tpre, rhs, st, atol2, 50, True, 4)
    assert t_fp.band_fused_pcg_chunk.launches == before
    for name in t_fp.ChunkState._fields:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    # the extra trip gives the true residual of the chunk's x
    want = rhs - t_fp.band_matvec_ref(top, a.x)
    assert torch.allclose(a.rt, want, atol=1e-6)
    with pytest.raises(ValueError, match="no kernel"):
        t_fp.band_fused_pcg_chunk(top, tpre, rhs.to("meta"), st, atol2, 50,
                                  True, 4)
    bad = {
        "dtype": (top._replace(tiles=top.tiles.double()), tpre),
        "shape": (top._replace(cover=top.cover[:-1]), tpre),
        "contiguous": (top._replace(tupper=top.tupper.transpose(0, 1)), tpre),
        "lanes": (top._replace(tiles=top.tiles[..., :64].contiguous()), tpre),
        "rmat": (top, tpre._replace(rmat=torch.zeros(np_, 2))),
    }
    for name, (o, p) in bad.items():
        with pytest.raises((TypeError, ValueError)):
            t_fp._band_launch(o, p, rhs, st, atol2, 50, True, 4)
    # a pose block size the kernel is not built for (it is for 3 and 6)
    with pytest.raises(ValueError, match="dp=5"):
        t_fp._band_launch(top, tpre, torch.zeros(5, np_), st, atol2, 50,
                          True, 4)


def test_gate_takes_band_past_the_resident_budget(big, monkeypatch):
    tg = big["tg"]
    cfg = OptimizerConfig(solver="schur", pcg_precond="tridiag+coarse")
    assert t_fp.fused_mode(cfg, tg) == "band"
    # the JAX gate agrees
    from toyslam_tpu.config import OptimizerConfig as JOpt

    assert j_fp.fused_mode(JOpt(solver="schur", pcg_precond="tridiag+coarse"),
                           big["jg"], None) == "band"
    no_band = dataclasses.replace(
        tg, plan=dataclasses.replace(tg.plan, band=None))
    assert t_fp.fused_mode(cfg, no_band) is None
    monkeypatch.setattr(t_fp, "BAND_BUDGET_BYTES", 2**20)
    assert t_fp.fused_mode(cfg, tg) is None
