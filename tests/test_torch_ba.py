"""The SE(3) bundle-adjustment path of the PyTorch port against the JAX
package, on small seeded graphs.

* ``make_ba_problem`` gives the JAX package's graph bit for bit;
* ``assemble_blocks_3d`` (either odometry Jacobians) at 1e-5 of each
  block's scale, and ``total_error_3d``;
* the dp=6 fused operator (build and matvec) at 1e-5 relative against the
  JAX build and its ``schur_matvec`` oracle;
* a band dp=6 solve on a 192-pose graph (where ``attach_plan`` builds the
  (6, 3) layout) against the port's own resident solve at 2e-3 of max|dx|
  (tests/test_band_fused.py's bar);
* the gate's choice at the three BA sizes of the reference's records
  (64x256 and 128x512 resident, 512x4096 band) against the JAX gate.

The solves and Gauss-Newton runs against the JAX package's are in
test_torch_ba_solve.py.

Run as a script, ``python tests/test_torch_ba.py``, it prints the JAX
package's f32 plain-PCG values of the BA configurations that chip_smoke.py
holds the port to, then those of the BA rows of
``toyslam_torch.scripts.bench_suite`` (see :func:`jax_reference`).
"""

import dataclasses
import functools
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
from toyslam_tpu.ops import schur as j_schur
from toyslam_tpu.ops import schur3d as j_schur3d
from toyslam_tpu.ops.gather_plan import attach_plan as j_attach_plan
from toyslam_tpu.optimizer import GaussNewton as JGN
from toyslam_tpu.sim import synthetic3d as j_syn3
from toyslam_torch.config import OptimizerConfig
from toyslam_torch.ops import fused_pcg as fp
from toyslam_torch.ops import schur
from toyslam_torch.ops import schur3d
from toyslam_torch.ops.gather_plan import attach_plan
from toyslam_torch.sim import synthetic3d

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
LAM = 1e-3


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _rel(port, ref):
    port, ref = _np(port).astype(np.float64), _np(ref).astype(np.float64)
    assert port.shape == ref.shape
    return float(np.abs(port - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def small():
    """The 96-pose, 300-point graph of tests/test_fused_pcg.py, through
    both packages' own gather plans."""
    jg = j_attach_plan(j_syn3.make_ba_problem(96, 300, seed=0)[0])
    tg = attach_plan(synthetic3d.make_ba_problem(96, 300, seed=0)[0])
    return jg, tg


@pytest.mark.parametrize("size", [(64, 256), (96, 300)])
def test_make_ba_problem_is_bit_identical(size):
    jg, jgt, jlm = j_syn3.make_ba_problem(*size, seed=0)
    tg, tgt, tlm = synthetic3d.make_ba_problem(*size, seed=0)
    np.testing.assert_array_equal(tgt, jgt)
    np.testing.assert_array_equal(tlm, jlm)
    pairs = [("poses", tg.poses, jg.poses),
             ("landmarks", tg.landmarks, jg.landmarks),
             ("intrinsics", tg.intrinsics, jg.intrinsics)]
    for f in ("pose_mask", "lm_mask", "pose_fixed", "lm_fixed"):
        pairs.append((f, getattr(tg, f), getattr(jg, f)))
    for grp in ("odom", "lm_edges"):
        for f in dataclasses.fields(getattr(jg, grp)):
            pairs.append((f"{grp}.{f.name}", getattr(getattr(tg, grp), f.name),
                          getattr(getattr(jg, grp), f.name)))
    for name, t, j in pairs:
        j = np.asarray(j)
        assert t.dtype == (torch.int64 if j.dtype.kind == "i"
                           else torch.float32), name
        np.testing.assert_array_equal(_np(t), j, err_msg=name)


def _j_assemble(jg, exact):
    """The JAX assembly, compiled as one program (op-by-op dispatch would
    compile every primitive on its own)."""
    return jax.jit(functools.partial(
        j_schur3d.assemble_blocks_3d, huber_delta=1.5,
        exact_odom_jacobians=exact))(jg)


@pytest.mark.parametrize("exact", [False, True])
def test_assemble_blocks_3d_matches_jax(small, exact):
    jg, tg = small
    js = _j_assemble(jg, exact)
    ts = schur3d.assemble_blocks_3d(tg, 1.5, exact_odom_jacobians=exact)
    assert tuple(ts.hpp_diag.shape) == (128, 6, 6)
    assert tuple(ts.hll.shape[1:]) == (3, 3)
    assert tuple(ts.hpl.shape[1:]) == (6, 3)
    for name in js._fields:
        p, r = _np(getattr(ts, name)), np.asarray(getattr(js, name))
        assert p.dtype == np.float32, name
        if p.ndim >= 3:   # each block at its own scale
            scale = np.abs(r).max(axis=(-2, -1), keepdims=True)
        elif p.ndim == 2:
            scale = np.abs(r).max(axis=-1, keepdims=True)
        else:
            scale = np.abs(r)
        err = np.abs(p - r) / np.maximum(scale, 1e-6)
        assert float(err.max()) < 1e-5, (name, float(err.max()))
    assert np.isclose(float(schur3d.total_error_3d(tg, 1.5)),
                      float(j_schur3d.total_error_3d(jg, 1.5)), rtol=1e-6)


def _damped(jg, tg):
    jd = j_schur.damp(_j_assemble(jg, True), jnp.float32(LAM))
    td = schur.damp(schur3d.assemble_blocks_3d(
        tg, 1.5, exact_odom_jacobians=True), torch.tensor(LAM))
    return jd, j_schur.inv_blocks(jd.hll), td, schur.inv_blocks(td.hll)


def test_fused_operator_dp6_matches_jax_and_schur_matvec(small):
    jg, tg = small
    jd, jhi, td, thi = _damped(jg, tg)
    jop = j_fp.build_fused_operator(jd, jhi, jg)
    top = fp.build_fused_operator(td, thi, tg)
    assert top.u.shape == (6, 128, 3 * tg.num_landmarks)
    for name in jop._fields:
        assert _rel(getattr(top, name), getattr(jop, name)) < 1e-5, name
    x = np.random.default_rng(0).normal(size=(128, 6)).astype(np.float32)
    y_ref = j_schur.schur_matvec(jd, jhi, jg, jnp.asarray(x))
    y = fp.fused_matvec_ref(top, torch.as_tensor(x).T.contiguous()).T
    assert _rel(y, y_ref) < 1e-5


def test_fused_precond_dp6_matches_jax(small):
    jg, tg = small
    jd, jhi, td, thi = _damped(jg, tg)
    jpre = j_fp.build_fused_precond(
        jd, jhi, jg, j_schur.schur_s_diag(jd, jhi, jg), "tridiag", 64)
    tpre = fp.build_fused_precond(
        td, thi, tg, schur.schur_s_diag(td, thi, tg), "tridiag", 64)
    assert tuple(tpre.alphas.shape) == (7, 6, 6, 128)
    for name in ("alphas", "gammas", "binv"):
        assert _rel(getattr(tpre, name), getattr(jpre, name)) < 1e-4, name


def test_band_dp6_solve_matches_resident_solve():
    tg = attach_plan(synthetic3d.make_ba_problem(192, 600, 16, seed=3)[0])
    band = tg.plan.band
    assert band is not None and (band.dp, band.dl) == (6, 3)
    sys_b = schur3d.assemble_blocks_3d(tg, 4.0, exact_odom_jacobians=True)
    lam = torch.tensor(LAM)
    args = (sys_b, tg, lam, 1e-9, 600, "tridiag", 64, 8, 64)
    dx_b, dxl_b, _ = fp.fused_schur_solve(*args, mode="band")
    dx_r, dxl_r, _ = fp.fused_schur_solve(*args, mode="resident")
    ref = float(dx_r.abs().max())
    assert float((dx_b - dx_r).abs().max()) <= 2e-3 * ref
    assert bool(torch.isfinite(dxl_b).all())


@pytest.mark.parametrize("size,mode", [
    ((64, 256), "resident"), ((128, 512), "resident"),
    ((512, 4096), "band"),
])
def test_gate_at_the_ba_sizes_agrees_with_jax(size, mode):
    """The port's gate and band search against the JAX gate and band
    search, each on its own package's graph (built bit for bit alike)."""
    kw = dict(solver="schur3d", exact_odom_jacobians=True,
              pcg_precond="tridiag", pcg_fused_chunk=16)
    tg = attach_plan(synthetic3d.make_ba_problem(*size, 24, seed=0)[0])
    jg = j_attach_plan(j_syn3.make_ba_problem(*size, 24, seed=0)[0])
    assert fp.fused_mode(OptimizerConfig(**kw), tg) == mode
    assert j_fp.fused_mode(JOpt(**kw), jg, None) == mode
    if mode == "band":
        tb, jb = tg.plan.band, jg.plan.band
        for f in ("chunk_b", "k_windows", "w_row", "n_chunks", "n_wide",
                  "dp", "dl"):
            assert getattr(tb, f) == getattr(jb, f), f
        np.testing.assert_array_equal(_np(tb.win_off), np.asarray(jb.win_off))
        # the V slabs of the resident layout are past its budget
        assert 4 * 6 * tg.num_poses * 3 * tg.num_landmarks \
            > fp.SLAB_BUDGET_BYTES


# --- the reference values of chip_smoke.py --------------------------------


def jax_reference(case: str, poses=None, landmarks=None, kw=None) -> dict:
    """The JAX package's f32 plain-PCG (``pcg_backend="xla"``) run of one
    of chip_smoke.py's BA configurations (or of ``poses`` x ``landmarks``
    with the OptimizerConfig fields ``kw``) on the CPU: chi^2 per GN
    iteration, PCG iterations, initial and final ATE."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    if kw is None:
        poses, landmarks, kw = chip_smoke.BA_CASES[case]
    jg, gt, _ = j_syn3.make_ba_problem(poses, landmarks, 24, seed=0)
    r = JGN(JOpt(**kw, pcg_backend="xla")).optimize(jg)
    it = int(r.iterations_run)
    return {
        "case": case,
        "chi2": np.asarray(r.errors)[:it].tolist(),
        "pcg_iters": np.asarray(r.pcg_iters)[:it].tolist(),
        "ate_initial": j_syn3.pose_ate_rmse(np.asarray(jg.poses)[:poses], gt),
        "ate_final": j_syn3.pose_ate_rmse(
            np.asarray(r.graph.poses)[:poses], gt),
    }


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    for case in chip_smoke.BA_CASES:
        print(json.dumps(jax_reference(case)), flush=True)
    # the BA rows of toyslam_torch.scripts.bench_suite (its BA_REF)
    from toyslam_torch.scripts import bench_suite

    for kw in (bench_suite.BA_OPT, bench_suite.BA_MATCHED_OPT):
        print(json.dumps(jax_reference("ba3d-128x512", 128, 512, kw)),
              flush=True)
