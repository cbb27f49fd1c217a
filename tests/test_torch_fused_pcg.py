"""The fused Schur/PCG solve of the PyTorch port against the JAX package.

* the operator ``T - V V^T`` and its build match JAX's, and match
  ``schur.schur_matvec`` (rel 1e-5), on the 150-pose graph and on the same
  graph with two loop-closure odometry edges;
* the plain chunk loop (what the CPU runs) matches JAX ``fused_pcg``, whose
  Pallas kernel runs in interpret mode here, for every preconditioner the
  kernel takes (x at rel 1e-3, PCG iterations within one chunk), and one
  chunk's control (max-iteration masking, breakdown stop) is the same;
* the gate takes the main path and raises for what is not ported; the
  coarse level built by the port solves as the JAX package's does.

The wrapper and the kernel itself are tested in test_torch_kernel.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toyslam_tpu.config import OptimizerConfig as JOpt
from toyslam_tpu.config import SimConfig, SlamConfig
from toyslam_tpu.ops import blockmath as j_bm
from toyslam_tpu.ops import fused_pcg as j_fp
from toyslam_tpu.ops import schur as j_schur
from toyslam_tpu.ops.gather_plan import attach_plan
from toyslam_tpu.sim import frontend
from toyslam_torch.bridge import graph_from_arrays
from toyslam_torch.config import OptimizerConfig
from toyslam_torch.ops import fused_pcg as fp
from toyslam_torch.ops import schur

torch.set_num_threads(1)
LAM = 1e-3


def _rel(port, ref):
    port = port.detach().double().cpu().numpy() if torch.is_tensor(port) \
        else np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    if ref.size == 0:
        return 0.0
    return float(np.abs(port - ref).max() / np.abs(ref).max())


def _t(a):
    return None if a is None else torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def main_graph():
    jg = attach_plan(frontend.build_graph(frontend.simulate(SimConfig()),
                                          SlamConfig())[0])
    return jg, graph_from_arrays(jg)


@pytest.fixture(scope="module")
def closure_graph(main_graph):
    """The 150-pose graph plus two loop-closure odometry edges written into
    padded odometry slots."""
    jg, _ = main_graph
    o = jg.odom
    i, j = np.asarray(o.i).copy(), np.asarray(o.j).copy()
    mask, meas = np.asarray(o.mask).copy(), np.asarray(o.meas).copy()
    info = np.asarray(o.info).copy()
    for k, (a, b) in zip(np.nonzero(mask == 0)[0][:2], [(10, 120), (30, 140)]):
        i[k], j[k], mask[k] = a, b, 1.0
        meas[k] = [0.1, 0.05, 0.02]
        info[k] = np.diag([4.0, 4.0, 20.0])
    jg = dataclasses.replace(
        jg, odom=dataclasses.replace(o, i=i, j=j, mask=mask, meas=meas,
                                     info=info),
        plan=None)
    jg = attach_plan(jg)
    return jg, graph_from_arrays(jg)


def _damped(jg, tg):
    jd = j_schur.damp(j_schur.assemble_blocks(jg, 1.5), jnp.float32(LAM))
    td = schur.damp(schur.assemble_blocks(tg, 1.5), torch.tensor(LAM))
    return jd, j_schur.inv_blocks(jd.hll), td, schur.inv_blocks(td.hll)


@pytest.mark.parametrize("which", ["main", "closure"])
def test_fused_operator_matches_jax_and_schur_matvec(
        which, main_graph, closure_graph):
    jg, tg = main_graph if which == "main" else closure_graph
    jd, jhi, td, thi = _damped(jg, tg)
    jop = j_fp.build_fused_operator(jd, jhi, jg)
    top = fp.build_fused_operator(td, thi, tg)
    assert top.u.shape == (3, 192, 768 + (6 if which == "closure" else 0))
    for name in jop._fields:
        assert _rel(getattr(top, name), getattr(jop, name)) < 1e-5, name
    x = np.random.default_rng(0).normal(size=(192, 3)).astype(np.float32)
    y_ref = j_schur.schur_matvec(jd, jhi, jg, jnp.asarray(x))
    y = fp.fused_matvec_ref(top, torch.as_tensor(x).T.contiguous()).T
    assert _rel(y, y_ref) < 1e-5


@pytest.mark.parametrize("precond", ["jacobi", "tridiag"])
def test_fused_precond_matches_jax(precond, main_graph):
    jg, tg = main_graph
    jd, jhi, td, thi = _damped(jg, tg)
    jpre = j_fp.build_fused_precond(
        jd, jhi, jg, j_schur.schur_s_diag(jd, jhi, jg), precond, 64)
    tpre = fp.build_fused_precond(
        td, thi, tg, schur.schur_s_diag(td, thi, tg), precond, 64)
    assert tpre.cinv is None and tpre.rmat is None
    for name in ("alphas", "gammas", "binv"):
        assert _rel(getattr(tpre, name), getattr(jpre, name)) < 1e-5, name


@pytest.mark.parametrize(
    "precond", ["jacobi", "tridiag", "jacobi+coarse", "tridiag+coarse"])
def test_plain_fused_pcg_matches_jax_kernel(precond, main_graph):
    jg, tg = main_graph
    jd, jhi, td, thi = _damped(jg, tg)
    jop = j_fp.build_fused_operator(jd, jhi, jg)
    jpre = j_fp.build_fused_precond(
        jd, jhi, jg, j_schur.schur_s_diag(jd, jhi, jg), precond, 64)
    rhs = -jd.bp + j_schur.hpl_matvec(
        jd, jg.lm_edges.pose, jg.lm_edges.lm, j_bm.mv(jhi, jd.bl),
        jg.num_poses, None, jg.plan)
    jres = j_fp.fused_pcg(jop, jpre, rhs.T, 1e-6, 200, 16, 64)
    top = fp.build_fused_operator(td, thi, tg)
    tpre = fp.build_fused_precond(
        td, thi, tg, schur.schur_s_diag(td, thi, tg), precond, 64)
    tres = fp.fused_pcg(top, tpre, _t(rhs.T).contiguous(), 1e-6, 200, 16, 64)
    assert _rel(tres.x, jres.x) < 1e-3
    assert abs(int(tres.iterations) - int(jres.iterations)) <= 16
    assert int(tres.iterations) < 200


def _tiny_system(sign=1.0, seed=0, np_=16, mw=8):
    """A small SPD (or, with sign=-1, negative definite) system in the
    kernel layout, with block-Jacobi preconditioning."""
    rng = np.random.default_rng(seed)
    u = rng.normal(0.0, 0.05, (3, np_, mw)).astype(np.float32)
    eye = np.broadcast_to(np.eye(3, dtype=np.float32)[..., None], (3, 3, np_))
    tdiag = sign * 4.0 * eye
    up = np.zeros((3, 3, np_), np.float32)
    up[:, :, :-1] = -0.5 * np.eye(3, dtype=np.float32)[..., None]
    lo = np.roll(up.transpose(1, 0, 2), 1, axis=-1)
    binv = (sign / 4.0) * eye
    al = np.zeros((0, 3, 3, np_), np.float32)
    rhs = rng.normal(size=(3, np_)).astype(np.float32)
    op = (u, np.ascontiguousarray(tdiag), up, lo)
    pre = (al, al, np.ascontiguousarray(binv), None, None)
    return op, pre, rhs


@pytest.mark.parametrize("case", ["maxit_masks", "breakdown_stops",
                                  "carried_chunks"])
def test_chunk_control_matches_jax_kernel(case):
    sign = -1.0 if case == "breakdown_stops" else 1.0
    op, pre, rhs = _tiny_system(sign)
    max_iters, chunk = {"maxit_masks": (5, 16), "breakdown_stops": (16, 16),
                        "carried_chunks": (40, 3)}[case]
    jres = j_fp.fused_pcg(
        j_fp.FusedOperator(*(jnp.asarray(a) for a in op)),
        j_fp.FusedPrecond(*(None if a is None else jnp.asarray(a)
                            for a in pre)),
        jnp.asarray(rhs), 1e-7, max_iters, chunk, restart_every=6)
    tres = fp.fused_pcg(fp.FusedOperator(*(_t(a) for a in op)),
                        fp.FusedPrecond(*(_t(a) for a in pre)),
                        _t(rhs), 1e-7, max_iters, chunk, restart_every=6)
    assert int(tres.iterations) == int(jres.iterations)
    if case == "breakdown_stops":
        assert int(tres.iterations) == 0
        assert float(tres.x.abs().max()) == float(jnp.abs(jres.x).max()) == 0
    else:
        assert _rel(tres.x, jres.x) < 1e-5
    assert abs(float(tres.residual_norm) - float(jres.residual_norm)) <= \
        1e-4 * float(np.linalg.norm(rhs))


def test_fused_schur_solve_matches_jax(main_graph):
    jg, tg = main_graph
    js = j_schur.assemble_blocks(jg, 1.5)
    ts = schur.assemble_blocks(tg, 1.5)
    jdp, jdl, jst = j_fp.fused_schur_solve(
        js, jg, jnp.float32(LAM), 1e-6, 200, "tridiag", 64, 16, 64)
    tdp, tdl, tst = fp.fused_schur_solve(
        ts, tg, torch.tensor(LAM), 1e-6, 200, "tridiag", 64, 16, 64)
    assert _rel(tdp, jdp) < 1e-3 and _rel(tdl, jdl) < 1e-3
    assert abs(int(tst.pcg_iters) - int(jst.pcg_iters)) <= 16
    # the coarse level is built by the port itself now
    jdp, jdl, jst = j_fp.fused_schur_solve(
        js, jg, jnp.float32(LAM), 1e-6, 200, "tridiag+coarse", 64, 16, 64)
    tdp, tdl, tst = fp.fused_schur_solve(
        ts, tg, torch.tensor(LAM), 1e-6, 200, "tridiag+coarse", 64, 16, 64)
    assert _rel(tdp, jdp) < 1e-3 and _rel(tdl, jdl) < 1e-3
    assert abs(int(tst.pcg_iters) - int(jst.pcg_iters)) <= 16


def test_gate(main_graph):
    _, tg = main_graph
    cfg = OptimizerConfig(solver="schur", pcg_precond="tridiag")
    assert fp.fused_mode(cfg, tg) == "resident"
    # the JAX gate agrees on the main path
    jg, _ = main_graph
    assert j_fp.fused_mode(JOpt(solver="schur", pcg_precond="tridiag"), jg,
                           None) == "resident"
    for change, match in [
        ({"pcg_backend": "xla"}, "pcg_backend"),
        ({"pcg_precond": "chunk"}, "chunk"),
        ({"pcg_precond": "tridiag+coarse", "pcg_coarse_group": 7},
         "pcg_coarse_group"),
    ]:
        with pytest.raises(NotImplementedError, match=match):
            fp.fused_mode(dataclasses.replace(cfg, **change), tg)
    with pytest.raises(ValueError, match="attach_plan"):
        fp.fused_mode(cfg, dataclasses.replace(tg, plan=None))

    class Huge:
        num_poses, num_landmarks, plan = 20_000, 20_000, tg.plan

    # past the resident budget without a band layout: the reference's
    # plain PCG loop, not ported
    with pytest.raises(NotImplementedError, match="plan.band"):
        fp.fused_mode(cfg, Huge())
    solve = schur.schur_linearize_solve(
        dataclasses.replace(cfg, pcg_precond_refresh=0))
    assert solve.stateful and callable(solve.init_state)
