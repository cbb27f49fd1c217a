"""Smoke test of the PyTorch port on one CUDA GPU (an H100 for sm_90a).

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each of which must pass:

1. environment: the card (nvidia-smi name and power limit), torch and CUDA
   versions, and the build of the hand-written kernels from
   toyslam_torch/csrc, one nvcc each, started together (build times and
   ptxas reports);
2. the resident kernel (B1) vs plain PyTorch on the card: one chunk launch
   from the same state at (dp=3, Np=192, Mw=768, L=8), the same with L=0,
   the same with a coarse level (nc=3) and at Np=2048, each a fresh and a
   carried chunk — ``it`` and ``stop`` equal, x within 1e-4 of max|x|,
   r_true and rr within 1e-4 of max|rhs| and ||rhs||^2, and a second
   launch from the same state giving the same bits (see compare_chunks) —
   and both timed;
3. the main path: the 150-pose seeded simulation, the graph build and
   ``GaussNewton(...).optimize`` on the card through B1, checked against
   the reference values of the JAX package (ATE 0.7552 within 2e-3,
   dead-reckoning ATE 6.5673, chi^2 first 228733.5 at rtol 1e-4 and final
   27524.9 at rtol 1e-3) with the launch counts;
4. timing, fenced with torch.cuda.synchronize(): GN-iter/s as the median of
   5 rounds x 20 optimize() calls; the time of each layer of one GN
   iteration; one chunk of B1 vs the plain version and its bound (CUDA
   events), on a cluster of 8 and of 16 blocks, and B1's per-phase
   clock64 split;
5. a shape check at robot_steps=2000 (Np=2048): chi^2 decreases and the
   optimized ATE beats dead reckoning, through B1;
6. the band kernel (B2) vs plain PyTorch on the card, a fresh and a
   carried chunk each, held as in phase 2, on seeded systems built so CG
   is far from converged after a chunk: one on the 10k-pose scale path's
   layout and shapes (tile stack [39, 2, 3, 512, 512], one wide landmark,
   L=14, coarse nc=64) and a small one (K=3, wide columns, L=0); B2 and
   its plain version timed on the scale path's own iteration-0 operands
   and on the small system; B2's bound, its per-phase clock64 split and
   the cost of one grid barrier alone (line ``band_phase_split``);
7. the scale path: ``make_large_problem(10_000, 10_000, 6, seed=0)`` and
   ``GaussNewton(...).optimize`` with the JAX package's band-10k-cg160
   config on the card through B2 (B1 launched no time), checked against
   the JAX package's f32 plain-PCG values (chi^2 first 10942542 at rtol
   1e-4; final chi^2 6649.81 and ATE 8.7954 within 1 %; dead-reckoning ATE
   53.9930; 80 PCG iterations in each of 15 GN iterations, 120 launches);
8. its timing: GN-iter/s as the median of 2 optimize() rounds, the ms of
   each layer, the host set-up seconds and the device time;
9. both kernels at dp=6 (SE(3) BA) vs their plain versions, held as in
   phase 2 on seeded systems of the BA paths' shapes: B1 at (Np=128,
   Mw=1536, L=7) and (Np=64, Mw=768, L=6), B2 on the band layout of the
   512 x 4096 graph; each timed against its plain version and its bound,
   with the per-phase clock64 split (lines ``ba_b1_phase_split``,
   ``ba_band_phase_split``);
10. the BA path: ``make_ba_problem(128, 512, 24, seed=0)`` with the bench
   suite's fused row through B1, and ``python -m toyslam_torch ba3d`` at
   its defaults (in process, U in shared memory), checked against the JAX
   package's f32 plain-PCG values (``BA_REF``);
11. its timing: GN-iter/s as the median of 3 optimize() rounds, the ms of
   each layer and the device time;
12. the BA scale path: ``make_ba_problem(512, 4096, 24, seed=0)`` with the
   exp_ba512 fused row and its matched-budget row through B2 (B1 launched
   no time), checked against ``BA_REF``;
13. their timing, as in phase 11;
14. the plain PCG loop (``pcg_backend="xla"``) on the main path (PCG
   iterations 35, 35, 34, 33, 33, 32, 32, 32, 31, 31 and the phase-3
   values), the 10k scale path (the phase-7 values: they are the JAX
   package's plain-loop ones) and the ba128 BA row (``BA_REF``), each with
   no kernel launch and its GN-iter/s beside the kernel path's;
15. ``python -m toyslam_torch run --solver dense`` in process (ATE 0.7552,
   chi^2 228733.53 -> 27524.9, no launch) and the dense GN-iter/s;
16. the bench suite's two 10k ``schur_grid`` rows (``GRID_CASES``), each
   under pcg_backend "auto" (the gate's decision printed), "fused" (B2
   launched, B1 not) and "xla" (no launch), held to the JAX package's
   plain-loop values (``GRID_REF``) and timed;
17. B2 on the grid path: timed on the 10k row's own operands (coarse level
   nc=320) against its plain version and its bound, with its per-phase
   split, and held against its plain version on a seeded system of that
   layout and shapes (fresh, carried, rerun bits);
18. the data of the band-vs-grid cost model (line ``grid_gate_fit``): the
   band operator's build, B2's cost per trip and the plain grid loop's per
   iteration at three layouts, beside the model's prediction.

The line before the last is ``{"kernels": [...]}`` (per kernel: launches on
its path, largest difference from the plain version, ms, plain_ms,
bound_ms, bound_by, library_ms; the same for B1 and B2 at dp=6 and for B2
on the grid path); the last line is ``{"ok": true,
"device": {...}}``, printed only when every phase passed.
Without a CUDA device the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNELS = {
    "fused_pcg_chunk": {
        "name": "fused_pcg_chunk",
        "route": "cuda",
        "source": "toyslam_torch/csrc/fused_pcg_chunk.cu",
        "replaces": "toyslam_tpu/ops/fused_pcg.py:344",
    },
    "band_fused_pcg_chunk": {
        "name": "band_fused_pcg_chunk",
        "route": "cuda",
        "source": "toyslam_torch/csrc/band_fused_pcg_chunk.cu",
        "replaces": "toyslam_tpu/ops/fused_pcg.py:524",
    },
}
REL_TOL = 1e-4
# H100 SXM peaks (NVIDIA's data sheet, at 700 W): HBM3 bytes/s and f32
# FLOP/s outside the tensor cores
PEAK_BYTES_S, PEAK_F32_FLOPS = 3.35e12, 67e12
ATE_REF, ATE_TOL = 0.7552, 2e-3
ATE_DR_REF = 6.5673
CHI2_FIRST, CHI2_FINAL = 228733.5, 27524.9
# the scale path: the JAX package's f32 plain-PCG (pcg_backend="xla") run of
# the same config on the same seeded graph.  1 % on the final chi^2 and the
# ATE: truncated PCG (tol 1e-2, cap 80) carries f32 summation-order
# differences into the steps
SCALE_CHI2_FIRST = 10942542.0
SCALE_CHI2_FINAL, SCALE_ATE, SCALE_REL = 6649.81, 8.7954, 1e-2
SCALE_ATE_DR = 53.9930
SCALE_GN_ITERS, SCALE_PCG_ITERS, SCALE_LAUNCHES = 15, 80, 120

# The SE(3) BA paths: (poses, landmarks, OptimizerConfig fields), 24
# observations per pose, seed 0.  "ba3d_defaults" is the ba3d subcommand's
# config; "ba128" the bench suite's fused row (scripts/bench_suite.py);
# "ba512_policy" and "ba512_matched" the rows of scripts/exp_ba512.py.
_BA_BENCH = dict(
    iterations=20, lr=1.0, solver="schur3d", exact_odom_jacobians=True,
    huber_delta=4.0, pcg_tol=1e-6, pcg_max_iters=200, convergence_eps=1e-8,
    reject_worse_steps=True, pcg_precond="tridiag", pcg_fused_chunk=16,
)
BA_CASES = {
    "ba3d_defaults": (64, 256, dict(
        iterations=25, lr=1.0, solver="schur3d", exact_odom_jacobians=True,
        huber_delta=1e9, pcg_tol=1e-8, pcg_max_iters=400,
        convergence_eps=1e-8, reject_worse_steps=True)),
    "ba128": (128, 512, _BA_BENCH),
    "ba512_policy": (512, 4096, _BA_BENCH),
    "ba512_matched": (512, 4096, dict(
        _BA_BENCH, pcg_tol=0.0, pcg_max_iters=64, pcg_restart_every=64)),
}
# Their references: the JAX package's f32 plain-PCG (pcg_backend="xla") run
# of each on the CPU (``python tests/test_torch_ba.py``): chi^2 at GN
# iteration 0 and at the last, ATE before and after (the JAX package's
# fused path on the CPU beside it where measured).  These runs are chaotic
# in f32: the JAX package's own fused and plain paths differ by up to 76 %
# in chi^2 per iteration on ba3d_defaults, and the end states sit in a flat
# valley (on ba3d_defaults their float64 cost agrees to 1e-6 while the ATE
# spans 0.27-0.39; at 512 x 4096 the port's own CPU runs end at ATE
# 0.40-3.10 with final chi^2 within 1.3 %).  So the port is held to chi^2
# at iteration 0 (rtol 1e-4: the same graph), chi^2 never rising (LM step
# rejection), the final chi^2 (rtol ``final_rtol``: 1e-4 where the JAX
# package's two paths agree to 1e-6, 2 % at 512 x 4096) and, where the
# valley allows it, an ATE below half the initial one.
BA_REF = {
    "ba3d_defaults": dict(chi2=(9062292.0, 2295.708984375),
                          ate_initial=1.2834193706512451,
                          ate_final=0.28841283917427063,
                          fused_chi2_final=2295.70654296875,
                          fused_ate_final=0.27208057045936584,
                          final_rtol=1e-4, ate_below=1.2834193706512451 / 2),
    "ba128": dict(chi2=(1744823.875, 4624.5419921875),
                  ate_initial=1.5134034156799316,
                  ate_final=0.16697615385055542,
                  fused_chi2_final=4624.5380859375,
                  fused_ate_final=0.14810003340244293,
                  final_rtol=1e-4, ate_below=1.5134034156799316 / 2),
    "ba512_policy": dict(chi2=(20788476.0, 13488.2568359375),
                         ate_initial=3.9674267768859863,
                         ate_final=0.9365894198417664, final_rtol=2e-2),
    "ba512_matched": dict(chi2=(20788476.0, 13470.5),
                          ate_initial=3.9674267768859863,
                          ate_final=0.4009546637535095, final_rtol=2e-2),
}


# The plain PCG loop on the main path: the JAX package's iteration counts
# (pcg_backend="xla", the same as its fused path's)
MAIN_PCG_ITERS = [35, 35, 34, 33, 33, 32, 32, 32, 31, 31]
DENSE_CHI2_FIRST, DENSE_CHI2_FINAL = 228733.53, 27524.9

# The bench suite's two 10k grid rows (scripts/bench_suite.py:274-325):
# make_large_problem's arguments and the OptimizerConfig fields over
# GRID_BENCH.  Each runs under pcg_backend "auto", "fused" and "xla".
GRID_BENCH = dict(
    iterations=15, lr=1.0, solver="schur_grid", exact_odom_jacobians=True,
    pcg_tol=1e-2, pcg_max_iters=15, pcg_restart_every=15,
    pcg_precond="tridiag+coarse", pcg_coarse_group=32, pcg_precond_refresh=5,
    pcg_backend="auto", pcg_fused_chunk=15,
)
GRID_CASES = {
    "large-sparse-10k": (dict(num_poses=10_000, num_landmarks=10_000,
                              obs_per_pose=6, seed=0), {}),
    "large-sparse-10k-revisit": (dict(num_poses=10_000, num_landmarks=5_000,
                                      obs_per_pose=6, seed=0, laps=2),
                                 dict(iterations=20)),
}
# Their references: the JAX package's f32 schur_grid run with
# pcg_backend="xla" on the CPU (``python tests/test_torch_grid_schur.py``):
# chi^2 at the first and last GN iteration, the final and the
# dead-reckoning ATE; 15 PCG iterations (the cap) in every GN iteration.
# Held: chi^2 first at rtol 1e-4, final chi^2 within 1 %, the ATE within
# 5 % on the revisit row (the row without revisits has no observable
# ATE: it drifts with the map).
GRID_REF = {
    "large-sparse-10k": dict(chi2=(10942544.0, 6652.3388671875),
                             ate=10.063098907470703,
                             ate_dr=53.99301528930664),
    "large-sparse-10k-revisit": dict(chi2=(27641242.0, 6861.9853515625),
                                     ate=1.4336570501327515,
                                     ate_dr=40.60987854003906),
}


def log(msg: str) -> None:
    print(msg, flush=True)


# --- phase 2: the kernel against its plain version ----------------------


def synthetic_system(np_, mw, nlevels, nc, eps, seed, device, dp=3):
    """A seeded SPD system in the kernel's layout whose CG is slow.

    ``T`` is a diagonally dominant block chain with block Cholesky factor
    ``F`` (``T = F F^T``, ``F`` block lower bidiagonal), and ``V = F W``
    with ``W`` Gaussian scaled to ``||W|| = sqrt(1 - eps)``.  Then
    ``S = T - V V^T = F (I - W W^T) F^T`` is SPD, and against a
    preconditioner exact on ``T`` its spectrum spreads over ``[eps, 1]``,
    so a 16-iteration chunk ends well short of the tolerance.  The
    preconditioner is PCR on ``T`` (or its block diagonal); the coarse
    level is the exact Galerkin inverse of ``S`` over groups of Np/nc
    poses.
    """
    import numpy as np
    import torch

    from toyslam_torch.ops import fused_pcg as fp
    from toyslam_torch.ops import schur

    rng = np.random.default_rng(seed)
    upper = -np.eye(dp)[None] + 0.05 * rng.normal(size=(np_, dp, dp))
    upper[-1] = 0.0
    up_norm = np.linalg.norm(upper, 2, axis=(1, 2))
    diag = np.zeros((np_, dp, dp))
    for p in range(np_):
        a = rng.normal(size=(dp, dp)) * 0.05
        near = up_norm[p] + (up_norm[p - 1] if p else 0.0)
        diag[p] = (near + 0.5) * np.eye(dp) + a @ a.T
    lower = np.concatenate([np.zeros((1, dp, dp)),
                            upper[:-1].transpose(0, 2, 1)])
    f_diag = np.zeros_like(diag)     # F[p, p]
    f_sub = np.zeros_like(diag)      # F[p, p-1]
    for p in range(np_):
        f_diag[p] = np.linalg.cholesky(
            diag[p] - (f_sub[p] @ f_sub[p].T if p else 0.0))
        if p + 1 < np_:
            f_sub[p + 1] = np.linalg.solve(f_diag[p], upper[p]).T
    w = rng.normal(size=(np_, dp, mw))
    w *= math.sqrt(1.0 - eps) / np.linalg.norm(w.reshape(np_ * dp, mw), 2)
    vb = np.einsum("pab,pbm->pam", f_diag, w)
    vb[1:] += np.einsum("pab,pbm->pam", f_sub[1:], w[:-1])
    u = vb.transpose(1, 0, 2)                        # [dp, Np, Mw]
    v = u.reshape(dp * np_, mw)

    def t32(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=device)

    op = fp.FusedOperator(
        u=t32(u), tdiag=t32(diag.transpose(1, 2, 0)),
        tupper=t32(upper.transpose(1, 2, 0)),
        tlower=t32(lower.transpose(1, 2, 0)),
    )
    if nlevels:
        al, ga, binv = schur.build_tridiag_planes(
            torch.as_tensor(diag.transpose(1, 2, 0)),
            torch.as_tensor(upper.transpose(1, 2, 0)),
        )
        al, ga, binv = al[:nlevels], ga[:nlevels], binv
    else:
        al = ga = torch.zeros((0, dp, dp, np_), dtype=torch.float64)
        binv = torch.as_tensor(np.linalg.inv(diag).transpose(1, 2, 0))
    cinv = rmat = None
    if nc:
        dense = np.zeros((dp * np_, dp * np_))
        idx = np.arange(np_)
        for a in range(dp):
            for b in range(dp):
                dense[a * np_ + idx, b * np_ + idx] = diag[:, a, b]
                dense[a * np_ + idx[:-1], b * np_ + idx[:-1] + 1] = \
                    upper[:-1, a, b]
                dense[b * np_ + idx[:-1] + 1, a * np_ + idx[:-1]] = \
                    upper[:-1, a, b]
        s = dense - v @ v.T
        r = (idx[:, None] // (np_ // nc) == np.arange(nc)[None]).astype(float)
        rk = np.kron(np.eye(dp), r)                      # [dp*Np, dp*nc]
        sc_inv = np.linalg.inv(rk.T @ s @ rk)
        cinv = t32(sc_inv.reshape(dp, nc, dp, nc).transpose(0, 2, 1, 3))
        rmat = t32(r)
    pre = fp.FusedPrecond(t32(al.numpy()), t32(ga.numpy()),
                          t32(binv.numpy()), cinv, rmat)
    rhs = t32(rng.normal(size=(dp, np_)))
    return op, pre, rhs


def fresh_state(rhs):
    import torch

    from toyslam_torch.ops import fused_pcg as fp

    z = torch.zeros_like(rhs)
    return fp.ChunkState(
        x=z, r=z, p=z, rt=rhs.clone(),
        it=torch.zeros(1, dtype=torch.int32, device=rhs.device),
        rz=torch.zeros(1, device=rhs.device),
        stop=torch.zeros(1, dtype=torch.int32, device=rhs.device),
        rr=(rhs * rhs).sum().reshape(1),
    )


def chunk_fns(kernel):
    """(kernel wrapper, plain version) of a kernel's chunk."""
    from toyslam_torch.ops import fused_pcg as fp

    return {
        "fused_pcg_chunk": (fp.fused_pcg_chunk, fp.fused_pcg_chunk_ref),
        "band_fused_pcg_chunk": (fp.band_fused_pcg_chunk,
                                 fp.band_fused_pcg_chunk_ref),
    }[kernel]


def reset_counts():
    from toyslam_torch.ops import fused_pcg as fp

    fp.fused_pcg_chunk.launches = 0
    fp.band_fused_pcg_chunk.launches = 0


def read_counts():
    from toyslam_torch.ops import fused_pcg as fp

    return {"fused_pcg_chunk": fp.fused_pcg_chunk.launches,
            "band_fused_pcg_chunk": fp.band_fused_pcg_chunk.launches}


def compare_chunks(case, op, pre, rhs, chunk=16, maxit=200, tol=1e-6,
                   kernel="fused_pcg_chunk"):
    """Kernel vs plain version from the same state: a fresh first chunk
    (restart) and a second chunk carrying the recurrence (no restart).
    Each kernel launch is repeated from the same state and must give the
    same bits.

    ``x`` is compared at its own scale.  ``r_true = rhs - S x`` and ``rr``
    are compared at the scale of ``rhs`` and ``||rhs||^2``: near the f32
    floor ``r_true`` is rounding noise of that size, so its own scale
    would compare noise with noise.  Both readings are printed."""
    import torch

    from toyslam_torch.ops import fused_pcg as fp

    ker_fn, ref_fn = chunk_fns(kernel)
    rhs2 = float((rhs * rhs).sum())
    rhs_max = float(rhs.abs().max())
    atol2 = ((tol ** 2) * (rhs * rhs).sum()).reshape(1)
    st = fresh_state(rhs)
    results = []
    for restart in (True, False):
        ref = ref_fn(op, pre, rhs, st, atol2, maxit, restart, chunk)
        ker = ker_fn(op, pre, rhs, st, atol2, maxit, restart, chunk)
        again = ker_fn(op, pre, rhs, st, atol2, maxit, restart, chunk)
        torch.cuda.synchronize()
        rerun_same = all(torch.equal(getattr(ker, f), getattr(again, f))
                         for f in fp.ChunkState._fields)
        dx = float((ker.x - ref.x).abs().max())
        drt = float((ker.rt - ref.rt).abs().max())
        drr = abs(float(ker.rr) - float(ref.rr))
        errs = {
            "x": dx / float(ref.x.abs().max()),
            "r_true": drt / rhs_max,
            "rr": drr / rhs2,
        }
        own = {
            "r_true": drt / float(ref.rt.abs().max()),
            "rr": drr / float(ref.rr),
        }
        same = (int(ker.it) == int(ref.it)) and \
            (int(ker.stop) == int(ref.stop))
        ok = same and rerun_same and all(
            e <= REL_TOL for e in errs.values()) and all(
            bool(torch.isfinite(t).all()) for t in (ker.x, ker.rt, ker.rr)
        )
        results.append({
            "case": case, "restart": restart, "ok": ok,
            "it": [int(ker.it), int(ref.it)],
            "stop": [int(ker.stop), int(ref.stop)],
            "rerun_identical": rerun_same, "rel": errs,
            "rel_own_scale": own, "max_abs_err": max(dx, drt),
            "rr_over_rhs2": float(ref.rr) / rhs2,
        })
        st = ref
    return results


def phase_kernels(device):
    # (name, Np, Mw, PCR levels, coarse groups, eps): eps sets how slowly CG
    # converges; the Np=2048 system is kept better conditioned because its
    # V^T x sums run over 6144 terms
    cases = [
        ("Np192_Mw768_L8", 192, 768, 8, 0, 1e-2),
        ("Np192_Mw768_jacobi", 192, 768, 0, 0, 1e-2),
        ("Np192_Mw768_L8_coarse3", 192, 768, 8, 3, 1e-2),
        ("Np2048_Mw768_L11", 2048, 768, 11, 0, 1e-1),
    ]
    out, times = [], {}
    for i, (name, np_, mw, nl, nc, eps) in enumerate(cases):
        op, pre, rhs = synthetic_system(np_, mw, nl, nc, eps, seed=i,
                                        device=device)
        out += compare_chunks(name, op, pre, rhs)
        times[name] = chunk_times(op, pre, rhs)
    for r in out:
        log("kernel_check " + json.dumps(r))
    log("kernel_chunk_ms " + json.dumps(times))
    bad = [r for r in out if not r["ok"]]
    if bad:
        raise AssertionError(f"kernel disagrees with plain version: {bad}")
    return max(r["max_abs_err"] for r in out)


def chunk_bound(op, pre, rhs, chunk, restart=True):
    """The least time the card could take for one chunk launch on these
    operands: every input read once and every output written once at the
    HBM rate, or the f32 operations of the plain version (chunk + 1
    matvecs, one preconditioner apply per iteration plus the restart's,
    dot products) at the f32 peak, whichever is larger."""
    import torch

    from toyslam_torch.ops import fused_pcg as fp

    dp, n = rhs.shape
    tensors = [t for t in (*op, *pre, rhs) if torch.is_tensor(t)]
    vec = rhs.numel() * rhs.element_size()
    nbytes = sum(t.numel() * t.element_size() for t in tensors) \
        + 8 * vec + 32   # x r p rt in and out, four scalars each way
    if isinstance(op, fp.BandOperator):
        mv = 4 * op.tiles.numel() + (0 if op.u is None else 4 * op.u.numel())
    else:
        mv = 4 * op.u.numel()
    mv += 6 * dp * dp * n
    pc = (4 * pre.alphas.shape[0] + 2) * dp * dp * n
    if pre.cinv is not None:
        nc = pre.rmat.shape[1]
        pc += 4 * dp * n * nc + 2 * (dp * nc) ** 2
    flops = (chunk + 1) * (mv + 10 * dp * n) + (chunk + int(restart)) * pc
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOPS
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


# --- phase 3: the main path ---------------------------------------------


def main_config(steps=150, **change):
    from toyslam_torch.config import OptimizerConfig, SimConfig, SlamConfig

    return SlamConfig(
        sim=SimConfig(robot_steps=steps, seed=0),
        optimizer=OptimizerConfig(**dict(
            dict(iterations=10, lr=0.2, solver="schur",
                 pcg_precond="tridiag"), **change)),
    )


def run_path(steps, device, **change):
    """The main path's simulation, graph and optimize() on the card with
    the launch counts set to 0 just before and read just after; ``change``
    overrides OptimizerConfig fields."""
    import numpy as np

    from toyslam_torch.optimizer import GaussNewton
    from toyslam_torch.sim import frontend

    cfg = main_config(steps, **change)
    t0 = time.perf_counter()
    sim = frontend.simulate(cfg.sim)
    graph, _ = frontend.build_graph(sim, cfg)
    host_s = time.perf_counter() - t0
    gn = GaussNewton(cfg.optimizer)
    gdev = graph.to(device)
    reset_counts()
    res = gn.optimize(gdev)
    est = res.graph.poses.cpu().numpy()
    launches = read_counts()
    n = sim.poses_gt.shape[0]
    errors = res.errors.cpu().numpy()[: res.iterations_run]
    metrics = {
        "steps": steps,
        "poses_padded": graph.num_poses,
        "landmarks": int(graph.lm_mask.sum()),
        "lm_edges": int(graph.lm_edges.mask.sum()),
        "host_sim_build_s": host_s,
        "iterations_run": res.iterations_run,
        "chi2": errors.tolist(),
        "pcg_iters": res.pcg_iters[: res.iterations_run].tolist(),
        "ate_rmse": frontend.ate_rmse(est[:n], sim.poses_gt),
        "ate_dead_reckoning": frontend.ate_rmse(sim.poses_dr, sim.poses_gt),
        "kernel_launches": launches,
        "finite": bool(np.isfinite(est).all() and np.isfinite(errors).all()),
    }
    # the start state with the gather plan optimize() attached, for timing
    return metrics, gn, res.graph.with_state(gdev.poses, gdev.landmarks)


def phase_main_path(device):
    m, gn, gdev = run_path(150, device)
    log("main_path " + json.dumps(m))
    checks = {
        "B1 launches > 0": m["kernel_launches"]["fused_pcg_chunk"] > 0,
        "B2 not launched": m["kernel_launches"]["band_fused_pcg_chunk"] == 0,
        "finite": m["finite"],
        "ate": abs(m["ate_rmse"] - ATE_REF) <= ATE_TOL,
        "ate_dr": abs(m["ate_dead_reckoning"] - ATE_DR_REF) <= 1e-4,
        "chi2_first": math.isclose(m["chi2"][0], CHI2_FIRST, rel_tol=1e-4),
        "chi2_final": math.isclose(m["chi2"][-1], CHI2_FINAL, rel_tol=1e-3),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"main path checks failed: {failed}")
    return m, gn, gdev


# --- phase 4: timing ------------------------------------------------------


def layer_system(gn, graph, mode="resident"):
    """The GN-iteration-0 solve of a path split into its layers: the main
    path, or (``solver="schur3d"``) a BA path through the resident or the
    band operator."""
    import torch

    from toyslam_torch.ops import blockmath as bm
    from toyslam_torch.ops import fused_pcg as fp
    from toyslam_torch.ops import schur, schur3d

    cfg = gn.config
    lam = torch.tensor(cfg.lambda_init, device=graph.device)
    plan = graph.plan
    state = {}
    band = mode == "band"

    def assemble():
        if cfg.solver == "schur3d":
            state["sys"] = schur3d.assemble_blocks_3d(
                graph, cfg.huber_delta, cfg.fixed_prior,
                exact_odom_jacobians=cfg.exact_odom_jacobians)
        else:
            state["sys"] = schur.assemble_blocks(graph, cfg.huber_delta,
                                                 cfg.fixed_prior)

    def eliminate():
        d = schur.damp(state["sys"], lam)
        hll_inv = schur.inv_blocks(d.hll)
        rhs = -d.bp + schur.hpl_matvec(d, graph.lm_edges.lm,
                                       bm.mv(hll_inv, d.bl), plan)
        state.update(d=d, hll_inv=hll_inv, rhs2=rhs.T.contiguous(),
                     s_diag=schur.schur_s_diag(d, hll_inv, graph))

    def precond():
        state["pre"] = fp.build_fused_precond(
            state["d"], state["hll_inv"], graph, state["s_diag"],
            cfg.pcg_precond, cfg.pcg_coarse_group)

    def operator():
        build = fp.build_band_operator if band else fp.build_fused_operator
        state["op"] = build(state["d"], state["hll_inv"], graph)

    def pcg():
        run = fp.band_fused_pcg if band else fp.fused_pcg
        state["res"] = run(state["op"], state["pre"], state["rhs2"],
                           cfg.pcg_tol, cfg.pcg_max_iters,
                           cfg.pcg_fused_chunk, cfg.pcg_restart_every)

    def backsub():
        d = state["d"]
        u = schur.hlp_matvec(d, graph.lm_edges.pose, state["res"].x.T, plan)
        state["dx_l"] = bm.mv(state["hll_inv"], -d.bl - u)

    return state, [("assemble_blocks", assemble),
                   ("damp_eliminate_rhs_sdiag", eliminate),
                   ("build_fused_precond", precond),
                   ("build_band_operator" if band else "build_fused_operator",
                    operator),
                   ("band_fused_pcg" if band else "fused_pcg", pcg),
                   ("back_substitution", backsub)]


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def chunk_times(op, pre, rhs, chunk=16, kernel="fused_pcg_chunk", reps=50):
    """One fresh chunk, kernel and plain version in turns (plain, kernel,
    kernel, plain), CUDA events."""
    ker_fn, ref_fn = chunk_fns(kernel)
    st = fresh_state(rhs)
    atol2 = ((1e-6 ** 2) * (rhs * rhs).sum()).reshape(1)

    def ker():
        ker_fn(op, pre, rhs, st, atol2, 200, True, chunk)

    def plain():
        ref_fn(op, pre, rhs, st, atol2, 200, True, chunk)

    p1, k1, k2, p2 = (cuda_ms(plain, max(1, reps // 5)), cuda_ms(ker, reps),
                      cuda_ms(ker, reps), cuda_ms(plain, max(1, reps // 5)))
    return {"kernel": [k1, k2], "plain": [p1, p2]}


def cluster_times(op, pre, rhs, chunk, reps=50):
    """One fresh B1 chunk on a cluster of 8 (portable) and of 16 blocks, in
    turns (8, 16, 16, 8), CUDA events."""
    from toyslam_torch.ops import fused_pcg as fp

    st = fresh_state(rhs)
    atol2 = ((1e-6 ** 2) * (rhs * rhs).sum()).reshape(1)
    ms = {8: [], 16: []}
    for c in (8, 16, 16, 8):
        ms[c].append(cuda_ms(lambda: fp._launch(
            op, pre, rhs, st, atol2, 200, True, chunk, cluster=c), reps))
    return {f"cluster{c}": v for c, v in ms.items()} | {
        "resident_at_16": fp.b1_schedule(rhs.device.index or 0, *rhs.shape,
                                         op.u.shape[-1], 0).resident}


def b1_phase_split(op, pre, rhs, chunk, chunk_ms):
    """Where one B1 chunk's time goes: block 0's clock64 cycles per phase
    kind (``B1_TIMERS``: its V^T v columns, its partial V urow, the cluster
    exchange with its two cluster barriers, the preconditioner, the rest)
    as shares of the
    launch, scaled by the measured chunk time."""
    import torch

    from toyslam_torch.ops import fused_pcg as fp

    timing = torch.zeros(len(fp.B1_TIMERS), dtype=torch.int64,
                         device=rhs.device)
    st = fresh_state(rhs)
    atol2 = ((1e-6 ** 2) * (rhs * rhs).sum()).reshape(1)
    fp._launch(op, pre, rhs, st, atol2, 200, True, chunk, timing=timing)
    torch.cuda.synchronize()
    cycles = dict(zip(fp.B1_TIMERS, timing.tolist()))
    total = sum(cycles.values())
    return {"cycles": cycles,
            "share": {k: v / total for k, v in cycles.items()},
            "ms": {k: chunk_ms * v / total for k, v in cycles.items()}}


def phase_timing(gn, gdev):
    import torch

    out = {}
    iters = gn.optimize(gdev).iterations_run
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            r = gn.optimize(gdev)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / 20)
    out["optimize_s_rounds"] = times
    out["optimize_s_median"] = statistics.median(times)
    out["gn_iter_per_s"] = iters / statistics.median(times)
    out["iterations_run"] = r.iterations_run

    state, layers = layer_system(gn, gdev)
    out["layer_ms"] = {name: cuda_ms(fn, 20) for name, fn in layers}
    out["pcg_iters_iter0"] = int(state["res"].iterations)

    chunk = gn.config.pcg_fused_chunk
    out["chunk_ms"] = chunk_times(state["op"], state["pre"], state["rhs2"],
                                  chunk)
    out["chunk_bound"] = chunk_bound(state["op"], state["pre"],
                                     state["rhs2"], chunk)
    out["cluster_ms"] = cluster_times(state["op"], state["pre"],
                                      state["rhs2"], chunk)
    out["phase_split"] = b1_phase_split(
        state["op"], state["pre"], state["rhs2"], chunk,
        statistics.mean(out["chunk_ms"]["kernel"]))
    out["device"] = device_time(gn, gdev, out["optimize_s_median"])
    return out


def device_time(gn, gdev, optimize_s, reps=5):
    """Kernel time on the card per optimize() from torch.profiler, by
    kernel name, and its share of the untraced optimize() wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            gn.optimize(gdev)
        torch.cuda.synchronize()
    per_kernel = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[e.key] = e.self_device_time_total / reps / 1e3  # ms
    busy_ms = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {
        "kernel_ms_per_optimize": busy_ms,
        "busy_share": busy_ms / (optimize_s * 1e3),
        "kernels_launched": len(per_kernel),
        "top_ms": dict(top),
    }


# --- phase 5: shape check -------------------------------------------------


def phase_shape(device):
    m, _, _ = run_path(2000, device)
    log("shape_check " + json.dumps(m))
    checks = {
        "B1 launches > 0": m["kernel_launches"]["fused_pcg_chunk"] > 0,
        "B2 not launched": m["kernel_launches"]["band_fused_pcg_chunk"] == 0,
        "finite": m["finite"],
        "chi2 decreases": m["chi2"][-1] < m["chi2"][0],
        "ate < dead reckoning": m["ate_rmse"] < m["ate_dead_reckoning"],
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"shape check failed: {failed}")
    return m


# --- phases 6-8: the band kernel and the scale path -----------------------


def scale_config():
    """The JAX package's band-10k-cg160 config (scripts/exp_band10k.py)."""
    from toyslam_torch.config import OptimizerConfig

    return OptimizerConfig(
        solver="schur", pcg_backend="auto", iterations=SCALE_GN_ITERS,
        lr=1.0, exact_odom_jacobians=True, pcg_tol=1e-2,
        pcg_max_iters=SCALE_PCG_ITERS, pcg_restart_every=40,
        pcg_precond="tridiag+coarse", pcg_coarse_group=160,
        pcg_precond_refresh=5, pcg_fused_chunk=10,
    )


def random_windows(np_, n_chunks, k_win, seed):
    """Window anchors at random multiples of 128, the last one at the last
    multiple below Np, so a window runs past the end of the graph."""
    import numpy as np

    anchors = np.arange(0, np_, 128)
    win_off = np.random.default_rng(seed).choice(anchors,
                                                 size=(n_chunks, k_win))
    win_off[-1, -1] = anchors[-1]
    return win_off.astype(np.int32)


def synthetic_band_system(np_, win_off, w_row, b_dl, mw, nlevels, group,
                          eps, seed, device, dp=3):
    """A seeded SPD system in the band kernel's layout whose CG is slow.

    ``T`` is a diagonally dominant block chain.  ``V`` is a tile stack on
    the windows ``win_off`` (zero on rows past Np) whose columns are
    orthonormal within each chunk with norms spread so that the
    eigenvalues of ``T^-1 V V^T`` spread, plus ``mw`` Gaussian wide
    columns, scaled so that the largest is ``(1 - eps) / 1.02`` (power
    iteration).  Then ``S = T - V V^T`` is SPD,
    and against a preconditioner exact on ``T`` its spectrum spreads over
    ``[~eps, 1]``, so a chunk ends well short of the tolerance.  The
    preconditioner is ``nlevels`` PCR levels on ``T`` (L=0: its block
    diagonal) and, with ``group``, the exact Galerkin coarse level of ``S``
    over groups of ``group`` poses (``R^T S R`` from one float64 plain
    matvec per coarse column)."""
    import numpy as np
    import torch

    from toyslam_torch.ops import band_plan
    from toyslam_torch.ops import fused_pcg as fp
    from toyslam_torch.ops import schur

    rng = np.random.default_rng(seed)
    upper = 0.05 * rng.normal(size=(np_, dp, dp))
    upper[-1] = 0.0
    up_norm = np.linalg.norm(upper, 2, axis=(1, 2))
    a = rng.normal(size=(np_, dp, dp)) * 0.05
    near = up_norm + np.concatenate([[0.0], up_norm[:-1]])
    diag = (near + 1.0)[:, None, None] * np.eye(dp) + a @ a.transpose(0, 2, 1)
    lower = np.concatenate([np.zeros((1, dp, dp)),
                            upper[:-1].transpose(0, 2, 1)])
    n_chunks, k_win = win_off.shape
    cover = band_plan._window_cover(win_off, np_, w_row, dp)

    def dev_t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), device=device,
                               dtype=dtype)

    # each chunk's columns orthonormal (QR of a Gaussian block, zero on
    # rows past Np), then scaled so that the eigenvalues of V V^T spread
    # evenly over [0, 1]: CG has many distinct eigenvalues of S to resolve
    shape = (n_chunks, k_win, dp, w_row, b_dl)
    live = dev_t((win_off[..., None] + np.arange(w_row)) < np_,
                 torch.float64)[:, :, None, :, None]
    g = dev_t(rng.standard_normal(size=shape, dtype=np.float32),
              torch.float64) * live
    q = torch.linalg.qr(g.reshape(n_chunks, -1, b_dl))[0].reshape(shape)
    col = torch.linspace(1.0, 1e-3, b_dl, dtype=torch.float64,
                         device=device)
    tiles = (q * live * col.sqrt()).float().contiguous()
    del g, q
    u = rng.standard_normal(size=(dp, mw, np_))
    u *= np.sqrt(0.5) / np.linalg.norm(u, axis=(0, 2), keepdims=True)

    tplanes = [dev_t(b.transpose(1, 2, 0)) for b in (diag, upper, lower)]
    al, ga, binv = schur.build_tridiag_planes(
        torch.as_tensor(diag.transpose(1, 2, 0)),
        torch.as_tensor(upper.transpose(1, 2, 0)),
    )
    tinv = fp.FusedPrecond(dev_t(al), dev_t(ga), dev_t(binv), None, None)
    zero = dev_t(np.zeros((dp, dp, np_)))
    vop = fp.BandOperator(tiles, dev_t(win_off, torch.int32),
                          dev_t(cover, torch.int32), dev_t(u),
                          zero, zero, zero)           # x -> -V V^T x
    # power iteration on T^-1 V V^T (PCR with all levels is T^-1) with the
    # Rayleigh quotient x^T V V^T x / x^T T x: its top eigenvalue
    x = dev_t(rng.normal(size=(dp, np_)))
    lam = 1.0
    for _ in range(300):
        ax = -fp.band_matvec_ref(vop, x)
        tx = (fp._bmv(tplanes[0], x) + fp._bmv(tplanes[1], fp._shift(x, -1))
              + fp._bmv(tplanes[2], fp._shift(x, 1)))
        lam = float((x * ax).sum() / (x * tx).sum())
        x = fp._precond_ref(tinv, ax)
        x = x / x.norm()
    scale = math.sqrt((1.0 - eps) / (1.02 * lam))
    op = fp.BandOperator(
        tiles=vop.tiles * scale, win_off=vop.win_off, cover=vop.cover,
        u=vop.u * scale, tdiag=tplanes[0], tupper=tplanes[1],
        tlower=tplanes[2],
    )
    del vop, tinv
    if nlevels:
        al, ga = al[:nlevels], ga[:nlevels]
    else:
        al = ga = torch.zeros((0, dp, dp, np_), dtype=torch.float64)
        binv = torch.as_tensor(np.linalg.inv(diag).transpose(1, 2, 0))
    cinv = rmat = None
    if group:
        nc = -(-np_ // group)
        gid = torch.arange(np_, device=device) // group
        rmat64 = (gid[:, None] == torch.arange(nc, device=device)).double()
        op64 = op._replace(**{f: getattr(op, f).double() for f in (
            "tiles", "u", "tdiag", "tupper", "tlower")})
        sc = torch.zeros((dp, nc, dp, nc), dtype=torch.float64,
                         device=device)
        for b in range(dp):
            for g in range(nc):
                e = torch.zeros((dp, np_), dtype=torch.float64,
                                device=device)
                e[b] = rmat64[:, g]
                sc[:, :, b, g] = fp.band_matvec_ref(op64, e) @ rmat64
        del op64
        sc_inv = torch.linalg.inv(sc.reshape(dp * nc, dp * nc))
        cinv = sc_inv.reshape(dp, nc, dp, nc).permute(0, 2, 1, 3).float()
        cinv, rmat = cinv.contiguous(), rmat64.float()
    pre = fp.FusedPrecond(dev_t(al), dev_t(ga), dev_t(binv), cinv, rmat)
    rhs = dev_t(rng.normal(size=(dp, np_)))
    return op, pre, rhs


def scale_layer_system(gn, graph):
    """The GN-iteration-0 solve of the scale path split into its layers."""
    import torch

    from toyslam_torch.ops import blockmath as bm
    from toyslam_torch.ops import fused_pcg as fp
    from toyslam_torch.ops import schur

    cfg = gn.config
    lam = torch.tensor(cfg.lambda_init, device=graph.device)
    plan = graph.plan
    state = {}

    def assemble():
        state["sys"] = schur.assemble_blocks(
            graph, cfg.huber_delta, cfg.fixed_prior,
            exact_odom_jacobians=cfg.exact_odom_jacobians)

    def eliminate():
        d = schur.damp(state["sys"], lam)
        hll_inv = schur.inv_blocks(d.hll)
        rhs = -d.bp + schur.hpl_matvec(d, graph.lm_edges.lm,
                                       bm.mv(hll_inv, d.bl), plan)
        state.update(d=d, hll_inv=hll_inv, rhs2=rhs.T.contiguous(),
                     s_diag=schur.schur_s_diag(d, hll_inv, graph))

    def coarse():
        state["cinv"] = schur.build_coarse_precond(
            state["d"], state["hll_inv"], graph, cfg.pcg_coarse_group)

    def pcr():
        state["pcr"] = fp.build_fused_precond(
            state["d"], state["hll_inv"], graph, state["s_diag"],
            cfg.pcg_precond.partition("+")[0], cfg.pcg_coarse_group)

    def operator():
        state["op"] = fp.build_band_operator(state["d"], state["hll_inv"],
                                             graph)

    def pcg():
        state["res"] = fp.band_fused_pcg(
            state["op"], state["pre"], state["rhs2"], cfg.pcg_tol,
            cfg.pcg_max_iters, cfg.pcg_fused_chunk, cfg.pcg_restart_every)

    def backsub():
        d = state["d"]
        u = schur.hlp_matvec(d, graph.lm_edges.pose, state["res"].x.T, plan)
        state["dx_l"] = bm.mv(state["hll_inv"], -d.bl - u)

    def full_precond():
        state["pre"] = fp.build_fused_precond(
            state["d"], state["hll_inv"], graph, state["s_diag"],
            cfg.pcg_precond, cfg.pcg_coarse_group)

    layers = [("assemble_blocks", assemble),
              ("damp_eliminate_rhs_sdiag", eliminate),
              ("build_coarse_precond", coarse),
              ("pcr_build", pcr),
              ("build_band_operator", operator),
              ("band_fused_pcg", pcg),
              ("back_substitution", backsub)]
    return state, layers, full_precond


def phase_scale_path(device):
    import numpy as np

    from toyslam_torch.ops.gather_plan import attach_plan
    from toyslam_torch.optimizer import GaussNewton
    from toyslam_torch.sim import frontend, synthetic

    t0 = time.perf_counter()
    graph, poses_gt, _ = synthetic.make_large_problem(
        num_poses=10_000, num_landmarks=10_000, obs_per_pose=6, seed=0)
    t1 = time.perf_counter()
    graph = attach_plan(graph)
    t2 = time.perf_counter()
    band = graph.plan.band
    gn = GaussNewton(scale_config())
    gdev = graph.to(device)
    reset_counts()
    t3 = time.perf_counter()
    res = gn.optimize(gdev)
    est = res.graph.poses.cpu().numpy()
    optimize_s = time.perf_counter() - t3
    launches = read_counts()
    n = poses_gt.shape[0]
    errors = res.errors.cpu().numpy()[: res.iterations_run]
    pcg = res.pcg_iters[: res.iterations_run].tolist()
    m = {
        "poses_padded": graph.num_poses,
        "landmarks_padded": graph.num_landmarks,
        "lm_edges": int(graph.lm_edges.mask.sum()),
        "layout": {"chunk_b": band.chunk_b, "k_windows": band.k_windows,
                   "w_row": band.w_row, "n_chunks": band.n_chunks,
                   "n_wide": band.n_wide, "tile_bytes": band.tile_bytes,
                   "cover_cap": int(band.cover.shape[-1])},
        "host_graph_build_s": t1 - t0,
        "host_band_search_s": t2 - t1,
        "first_optimize_s": optimize_s,
        "iterations_run": res.iterations_run,
        "chi2": errors.tolist(),
        "pcg_iters": pcg,
        "ate_rmse": frontend.ate_rmse(est[:n], poses_gt),
        "ate_dead_reckoning": frontend.ate_rmse(graph.poses[:n], poses_gt),
        "kernel_launches": launches,
        "finite": bool(np.isfinite(est).all() and np.isfinite(errors).all()),
    }
    log("scale_path " + json.dumps(m))
    checks = {
        "B2 launches": launches["band_fused_pcg_chunk"] == SCALE_LAUNCHES,
        "B1 not launched": launches["fused_pcg_chunk"] == 0,
        "finite": m["finite"],
        "iterations": m["iterations_run"] == SCALE_GN_ITERS,
        "pcg iterations": pcg == [SCALE_PCG_ITERS] * SCALE_GN_ITERS,
        "chi2_first": math.isclose(m["chi2"][0], SCALE_CHI2_FIRST,
                                   rel_tol=1e-4),
        "chi2_final": math.isclose(m["chi2"][-1], SCALE_CHI2_FINAL,
                                   rel_tol=SCALE_REL),
        "ate": math.isclose(m["ate_rmse"], SCALE_ATE, rel_tol=SCALE_REL),
        "ate_dr": abs(m["ate_dead_reckoning"] - SCALE_ATE_DR) <= 1e-4,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"scale path checks failed: {failed}")
    return m, gn, gdev, poses_gt


def phase_band_kernels(gn, gdev):
    """B2 against its plain version at the scale path's shapes and on a
    small synthetic layout with K=3, wide columns and L=0."""
    import torch

    cfg = gn.config
    chunk = cfg.pcg_fused_chunk
    # timed on the scale path's own iteration-0 operands
    state, layers, full_precond = scale_layer_system(gn, gdev)
    for name, fn in layers[:2] + layers[4:5]:
        fn()
    full_precond()
    op, pre, rhs2 = state["op"], state["pre"], state["rhs2"]
    shapes = {"tiles": list(op.tiles.shape), "u": list(op.u.shape),
              "pcr_levels": pre.alphas.shape[0], "nc": pre.cinv.shape[-1]}
    log("band_kernel_shapes " + json.dumps(shapes))
    times = {"scale10k_L14_coarse64": chunk_times(
        op, pre, rhs2, chunk, kernel="band_fused_pcg_chunk", reps=10)}
    bound = chunk_bound(op, pre, rhs2, chunk)
    split = band_phase_split(op, pre, rhs2, chunk,
                             statistics.mean(
                                 times["scale10k_L14_coarse64"]["kernel"]))
    log("band_phase_split " + json.dumps(split))
    # held against the plain version on systems of the same shapes built
    # so that CG is far from converged after a chunk: the scale path's
    # own system carries the 1e6 gauge prior of pose 0, where r_true is
    # 1e6 times an f32 difference of x
    band = gdev.plan.band
    win_off = band.win_off.cpu().numpy()
    del state, op, pre
    sop, spre, srhs = synthetic_band_system(
        gdev.num_poses, win_off, band.w_row, band.chunk_b * 2,
        2 * band.n_wide, shapes["pcr_levels"], cfg.pcg_coarse_group, 2e-2,
        seed=4, device=gdev.device)
    assert (list(sop.tiles.shape), spre.cinv.shape[-1]) == \
        (shapes["tiles"], shapes["nc"])
    out = compare_chunks("scale10k_L14_coarse64", sop, spre, srhs,
                         chunk=chunk, kernel="band_fused_pcg_chunk")
    del sop, spre, srhs
    torch.cuda.empty_cache()
    sop, spre, srhs = synthetic_band_system(
        1000, random_windows(1000, 6, 3, seed=5), 256, 128, 4, 0, 0, 2e-2,
        seed=5, device=gdev.device)
    out += compare_chunks("synthetic_K3_wide4_jacobi", sop, spre, srhs,
                          kernel="band_fused_pcg_chunk")
    times["synthetic_K3_wide4_jacobi"] = chunk_times(
        sop, spre, srhs, kernel="band_fused_pcg_chunk")
    for r in out:
        log("band_kernel_check " + json.dumps(r))
    log("band_kernel_chunk_ms " + json.dumps(times))
    bad = [r for r in out if not r["ok"]]
    if bad:
        raise AssertionError(
            f"band kernel disagrees with plain version: {bad}")
    return {"max_abs": max(r["max_abs_err"] for r in out),
            "chunk_ms": times["scale10k_L14_coarse64"], "bound": bound,
            "split": split}


def band_phase_split(op, pre, rhs, chunk, chunk_ms, probe_iters=2000):
    """Where one B2 chunk's time goes: the blocks' mean clock64 cycles (and
    their min and max) per kind (``BAND_TIMERS``: the slab phase's steps,
    the gather, preconditioner work, grid barriers including the wait for
    the slowest block, the rest) as shares of the launch, scaled by the
    measured chunk time; and the cost of one grid barrier alone on the same
    grid (``probe_iters`` barriers, CUDA events)."""
    import torch

    from toyslam_torch.ops import fused_pcg as fp

    dev = rhs.device
    grid, plan = fp.band_schedule(dev.index or 0, *op.tiles.shape[:2],
                                  rhs.shape[0], *op.tiles.shape[3:],
                                  0 if op.u is None else op.u.shape[1])
    timing = torch.zeros((grid, len(fp.BAND_TIMERS)), dtype=torch.int64,
                         device=dev)
    st = fresh_state(rhs)
    atol2 = ((1e-6 ** 2) * (rhs * rhs).sum()).reshape(1)
    fp._band_launch(op, pre, rhs, st, atol2, 200, True, chunk, timing=timing)
    torch.cuda.synchronize()
    per_block = timing.double()
    mean = per_block.mean(0).tolist()
    cycles = dict(zip(fp.BAND_TIMERS, mean))
    spread = {k: [float(per_block[:, i].min()), float(per_block[:, i].max())]
              for i, k in enumerate(fp.BAND_TIMERS)}
    total = sum(cycles.values())
    sync_ms = cuda_ms(lambda: fp.band_grid_sync_probe(dev, probe_iters), 3)
    # the kernel's precond_phases: two PCR levels per phase
    nph = max(-(-pre.alphas.shape[0] // 2), 4 if pre.cinv is not None else 1)
    return {
        "grid": grid, "slab_rows": plan.rows, "slab_cols": plan.cols,
        "slabs_per_chunk": plan.slabs_per_chunk,
        "slabs_per_block": plan.slabs_per_block,
        "smem_bytes": plan.smem_bytes,
        "grid_sync_us": sync_ms / probe_iters * 1e3,
        "barriers_per_trip": 3 + nph,
        "cycles": cycles, "cycles_min_max_over_blocks": spread,
        "share": {k: v / total for k, v in cycles.items()},
        "ms": {k: chunk_ms * v / total for k, v in cycles.items()},
    }


def phase_scale_timing(gn, gdev):
    # 2 rounds (3 before the BA phases lengthened the smoke)
    out = gn_rate(gn, gdev, 2)
    state, layers, full_precond = scale_layer_system(gn, gdev)
    for name, fn in layers[:2]:
        fn()
    full_precond()
    out["layer_ms"] = {name: cuda_ms(fn, 3) for name, fn in layers}
    out["pcg_iters_iter0"] = int(state["res"].iterations)
    out["device"] = device_time(gn, gdev, out["optimize_s_median"], reps=1)
    return out



# --- phases 9-13: the SE(3) BA paths at dp=6 -------------------------------


def phase_ba_kernels(device):
    """B1 and B2 at dp=6 against their plain versions on the card, on
    seeded systems of the BA paths' shapes where CG is far from converged
    after a chunk: B1 at (Np=128, Mw=1536, L=7), the bench row, and at
    (Np=64, Mw=768, L=6), the ba3d defaults; B2 on the tile-stack layout
    that the band search gives the 512-pose, 4096-point graph.  Each a
    fresh and a carried chunk, held as in phase 2; each timed against its
    plain version and its bound."""
    import torch

    from toyslam_torch.ops import fused_pcg as fp
    from toyslam_torch.ops.gather_plan import attach_plan
    from toyslam_torch.sim import synthetic3d

    out, times, bounds = [], {}, {}
    for i, (name, np_, mw, nl) in enumerate([
            ("dp6_Np128_Mw1536_L7", 128, 1536, 7),
            ("dp6_Np64_Mw768_L6", 64, 768, 6)]):
        op, pre, rhs = synthetic_system(np_, mw, nl, 0, 1e-2, seed=10 + i,
                                        device=device, dp=6)
        out += compare_chunks(name, op, pre, rhs)
        times[name] = chunk_times(op, pre, rhs)
        bounds[name] = chunk_bound(op, pre, rhs, 16)
        times[name]["resident"] = fp.b1_schedule(
            device.index or 0, 6, np_, mw, 0).resident
        log("ba_b1_phase_split " + json.dumps({name: b1_phase_split(
            op, pre, rhs, 16, statistics.mean(times[name]["kernel"]))}))
    graph = attach_plan(synthetic3d.make_ba_problem(512, 4096, 24,
                                                    seed=0)[0])
    band = graph.plan.band
    nlevels = max(1, (graph.num_poses - 1).bit_length())
    sop, spre, srhs = synthetic_band_system(
        graph.num_poses, band.win_off.cpu().numpy(), band.w_row,
        band.chunk_b * 3, 3 * band.n_wide, nlevels, 0, 2e-2, seed=12,
        device=device, dp=6)
    name = "dp6_ba512_band"
    out += compare_chunks(name, sop, spre, srhs, kernel="band_fused_pcg_chunk")
    times[name] = chunk_times(sop, spre, srhs, kernel="band_fused_pcg_chunk",
                              reps=10)
    bounds[name] = chunk_bound(sop, spre, srhs, 16)
    grid, plan = fp.band_schedule(device.index or 0, *sop.tiles.shape[:2], 6,
                                  *sop.tiles.shape[3:],
                                  0 if sop.u is None else sop.u.shape[1])
    # where a dp=6 chunk's time goes: B2's blocks, B1's block 0
    log("ba_band_phase_split " + json.dumps(band_phase_split(
        sop, spre, srhs, 16, statistics.mean(times[name]["kernel"]))))
    shapes = {"tiles": list(sop.tiles.shape), "n_wide": band.n_wide,
              "pcr_levels": nlevels, "grid": grid, "slab_rows": plan.rows,
              "slab_cols": plan.cols, "slabs_per_chunk": plan.slabs_per_chunk,
              "slabs_per_block": plan.slabs_per_block,
              "smem_bytes": plan.smem_bytes}
    del sop, spre, srhs
    torch.cuda.empty_cache()
    for r in out:
        log("ba_kernel_check " + json.dumps(r))
    log("ba_band_layout " + json.dumps(shapes))
    log("ba_kernel_chunk_ms " + json.dumps(times))
    log("ba_kernel_bound " + json.dumps(bounds))
    bad = [r for r in out if not r["ok"]]
    if bad:
        raise AssertionError(f"dp=6 kernel disagrees with plain version: {bad}")
    b1 = [r["max_abs_err"] for r in out if r["case"].startswith("dp6_Np")]
    b2 = [r["max_abs_err"] for r in out if r["case"] == name]
    return {"b1_max_abs": max(b1), "b2_max_abs": max(b2), "ms": times,
            "bound": bounds}


def ba_optimize(case, device, **change):
    """One BA path: the seeded graph, ``GaussNewton(...).optimize`` on the
    card with the launch counts set to 0 just before and read just after,
    and its metrics; ``change`` overrides OptimizerConfig fields (mode None:
    the plain PCG loop, no launch)."""
    import numpy as np

    from toyslam_torch.config import OptimizerConfig
    from toyslam_torch.ops import fused_pcg as fp
    from toyslam_torch.optimizer import GaussNewton
    from toyslam_torch.sim import synthetic3d

    poses, landmarks, kw = BA_CASES[case]
    t0 = time.perf_counter()
    graph, gt, _ = synthetic3d.make_ba_problem(poses, landmarks, 24, seed=0)
    gn = GaussNewton(OptimizerConfig(**dict(kw, **change)))
    graph = gn._prepare(graph)          # gather tables and band layout
    host_s = time.perf_counter() - t0
    gdev = graph.to(device)
    mode = fp.fused_mode(gn.config, gdev)
    reset_counts()
    t1 = time.perf_counter()
    res = gn.optimize(gdev)
    est = res.graph.poses.cpu().numpy()
    first_s = time.perf_counter() - t1
    launches = read_counts()
    it = res.iterations_run
    errors = res.errors.cpu().numpy()[:it]
    ref = BA_REF[case]
    m = {
        "case": case, "mode": mode, "poses_padded": graph.num_poses,
        "landmarks": int(graph.lm_mask.sum()),
        "reproj_edges": int(graph.lm_edges.mask.sum()),
        "host_graph_plan_s": host_s, "first_optimize_s": first_s,
        "iterations_run": it, "chi2": errors.tolist(),
        "pcg_iters": res.pcg_iters[:it].tolist(),
        "ate_initial": synthetic3d.pose_ate_rmse(
            graph.poses[:poses].numpy(), gt),
        "ate_final": synthetic3d.pose_ate_rmse(est[:poses], gt),
        "kernel_launches": launches,
        "finite": bool(np.isfinite(est).all() and np.isfinite(errors).all()),
        "reference": ref,
    }
    b1, b2 = (launches["fused_pcg_chunk"], launches["band_fused_pcg_chunk"])
    checks = {
        "kernel": (b1 > 0 and b2 == 0) if mode == "resident"
        else (b2 > 0 and b1 == 0) if mode == "band" else b1 == b2 == 0,
        "finite": m["finite"],
        "chi2_first": math.isclose(errors[0], ref["chi2"][0], rel_tol=1e-4),
        # LM with step rejection: chi^2 never rises
        "chi2 non-increasing": bool(np.all(np.diff(errors) <= 0.0)),
        "chi2_final": math.isclose(errors[-1], ref["chi2"][-1],
                                   rel_tol=ref["final_rtol"]),
    }
    if "ate_below" in ref:
        checks["ate_final"] = m["ate_final"] < ref["ate_below"]
    m["checks"] = checks
    log("ba_path " + json.dumps(m))
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"BA path {case} checks failed: {failed}")
    return m, gn, res.graph.with_state(gdev.poses, gdev.landmarks)


def phase_ba_path(device):
    """The bench row at 128 x 512 through B1, and ``python -m toyslam_torch
    ba3d`` at its defaults, in process, through B1 with U in shared
    memory."""
    import contextlib
    import io

    from toyslam_torch import app
    from toyslam_torch.ops import fused_pcg as fp

    m, gn, gdev = ba_optimize("ba128", device)
    assert m["mode"] == "resident"
    reset_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = app.main(["ba3d"])
    launches = read_counts()
    cli = json.loads(buf.getvalue().strip().splitlines()[-1])
    ref = BA_REF["ba3d_defaults"]
    cli["kernel_launches_by_kernel"] = launches
    cli["resident_u_in_smem"] = fp.b1_schedule(
        device.index or 0, 6, 64, 3 * cli["landmarks"], 0).resident
    checks = {
        "exit 0": code == 0,
        "device": cli["device"] == "cuda",
        "B1 only": launches["fused_pcg_chunk"] == cli["kernel_launches"] > 0
        and launches["band_fused_pcg_chunk"] == 0,
        "U in shared memory": cli["resident_u_in_smem"],
        "chi2_first": math.isclose(cli["chi2_first"], ref["chi2"][0],
                                   rel_tol=1e-4),
        "chi2_final": math.isclose(cli["chi2_final"], ref["chi2"][-1],
                                   rel_tol=ref["final_rtol"]),
        "ate_initial": abs(cli["ate_initial"] - ref["ate_initial"]) <= 1e-4,
        "ate_final": cli["ate_final"] < ref["ate_below"],
    }
    cli["checks"] = checks
    log("ba3d_cli " + json.dumps(cli))
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"ba3d CLI checks failed: {failed}")
    return {"ba128": m, "ba3d_defaults": cli}, gn, gdev


def phase_ba_scale_path(device):
    """512 poses x 4096 points through B2 (B1 at zero launches): the
    exp_ba512 fused row and its matched-budget row."""
    out = {}
    for case in ("ba512_policy", "ba512_matched"):
        m, gn, gdev = ba_optimize(case, device)
        assert m["mode"] == "band"
        out[case] = (m, gn, gdev)
    return out


def path_timing(gn, gdev, mode, rounds=3):
    """GN-iter/s as the median of ``rounds`` optimize() calls fenced with
    torch.cuda.synchronize(), the ms of each layer of the GN-iteration-0
    solve (CUDA events), and the device time from torch.profiler."""
    out = gn_rate(gn, gdev, rounds)
    state, layers = layer_system(gn, gdev, mode)
    out["layer_ms"] = {name: cuda_ms(fn, 3) for name, fn in layers}
    out["pcg_iters_iter0"] = int(state["res"].iterations)
    out["device"] = device_time(gn, gdev, out["optimize_s_median"], reps=1)
    return out


# --- phases 14-18: the plain PCG loop, the dense solver, schur_grid -------


def gn_rate(gn, gdev, rounds):
    """GN-iter/s: GN iterations over the median of ``rounds`` optimize()
    calls fenced with torch.cuda.synchronize()."""
    import torch

    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = gn.optimize(gdev)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return {"optimize_s_rounds": times,
            "optimize_s_median": statistics.median(times),
            "gn_iter_per_s": r.iterations_run / statistics.median(times),
            "iterations_run": r.iterations_run}


def failed_checks(name, checks):
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{name} checks failed: {failed}")


def phase_plain_loop(device, state):
    """The plain PCG loop (pcg_backend="xla") on the main path, the 10k
    scale path and the ba128 BA row, each held to its reference values with
    no kernel launch, and its GN-iter/s beside the kernel path's of the same
    call."""
    import dataclasses

    from toyslam_torch.optimizer import GaussNewton
    from toyslam_torch.sim import frontend

    out = {}
    m, gn, gdev = run_path(150, device, pcg_backend="xla")
    checks = {
        "no launch": sum(m["kernel_launches"].values()) == 0,
        "finite": m["finite"],
        "pcg iterations": m["pcg_iters"] == MAIN_PCG_ITERS,
        "ate": abs(m["ate_rmse"] - ATE_REF) <= ATE_TOL,
        "chi2_first": math.isclose(m["chi2"][0], CHI2_FIRST, rel_tol=1e-4),
        "chi2_final": math.isclose(m["chi2"][-1], CHI2_FINAL, rel_tol=1e-3),
    }
    m["rate"] = gn_rate(gn, gdev, 3)
    m["kernel_path_gn_iter_per_s"] = state["timing"]["gn_iter_per_s"]
    log("plain_main_path " + json.dumps(m))
    failed_checks("plain-loop main path", checks)
    out["main"] = m

    gn = GaussNewton(dataclasses.replace(scale_config(), pcg_backend="xla"))
    gdev = state["sgdev"]
    reset_counts()
    res = gn.optimize(gdev)
    est = res.graph.poses.cpu().numpy()
    launches = read_counts()
    it = res.iterations_run
    errors = res.errors.cpu().numpy()[:it]
    poses_gt = state["sgt"]
    n = poses_gt.shape[0]
    m = {"chi2": errors.tolist(), "pcg_iters": res.pcg_iters[:it].tolist(),
         "ate_rmse": frontend.ate_rmse(est[:n], poses_gt),
         "kernel_launches": launches}
    checks = {
        "no launch": sum(launches.values()) == 0,
        "iterations": it == SCALE_GN_ITERS,
        "pcg iterations": m["pcg_iters"] == [SCALE_PCG_ITERS] * SCALE_GN_ITERS,
        "chi2_first": math.isclose(errors[0], SCALE_CHI2_FIRST, rel_tol=1e-4),
        "chi2_final": math.isclose(errors[-1], SCALE_CHI2_FINAL,
                                   rel_tol=SCALE_REL),
        "ate": math.isclose(m["ate_rmse"], SCALE_ATE, rel_tol=SCALE_REL),
    }
    m["rate"] = gn_rate(gn, gdev, 2)
    m["kernel_path_gn_iter_per_s"] = state["scale_timing"]["gn_iter_per_s"]
    log("plain_scale_path " + json.dumps(m))
    failed_checks("plain-loop scale path", checks)
    out["scale"] = m

    m, gn, gdev = ba_optimize("ba128", device, pcg_backend="xla")
    assert m["mode"] is None
    m["rate"] = gn_rate(gn, gdev, 1)      # ~10 s an optimize() here
    m["kernel_path_gn_iter_per_s"] = state["ba_timing"]["gn_iter_per_s"]
    log("plain_ba128 " + json.dumps(m))
    out["ba128"] = m
    return out


def phase_dense(device, state):
    """``python -m toyslam_torch run --solver dense`` in process, held to
    the JAX package's dense values, and the dense GN-iter/s."""
    import contextlib
    import io

    from toyslam_torch import app
    from toyslam_torch.optimizer import GaussNewton
    from toyslam_torch.sim import frontend

    reset_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = app.main(["run", "--solver", "dense"])
    launches = read_counts()
    cli = json.loads(buf.getvalue().strip().splitlines()[-1])
    checks = {
        "exit 0": code == 0,
        "device": cli["device"] == "cuda",
        "no launch": cli["kernel_launches"] == 0
        and sum(launches.values()) == 0,
        "direct solves": cli["pcg_iters"] == [0] * cli["iterations_run"],
        "ate": abs(cli["ate_rmse"] - ATE_REF) <= ATE_TOL,
        "chi2_first": math.isclose(cli["chi2_first"], DENSE_CHI2_FIRST,
                                   rel_tol=1e-4),
        "chi2_final": math.isclose(cli["chi2_final"], DENSE_CHI2_FINAL,
                                   rel_tol=1e-3),
    }
    cfg = main_config(solver="dense")
    graph, _ = frontend.build_graph(frontend.simulate(cfg.sim), cfg)
    cli["rate"] = gn_rate(GaussNewton(cfg.optimizer), graph.to(device), 5)
    cli["kernel_path_gn_iter_per_s"] = state["timing"]["gn_iter_per_s"]
    log("dense_cli " + json.dumps(cli))
    failed_checks("dense", checks)
    return cli


def grid_config(case, backend):
    from toyslam_torch.config import OptimizerConfig

    return OptimizerConfig(**dict(GRID_BENCH, **GRID_CASES[case][1],
                                  pcg_backend=backend))


def phase_grid_paths(device):
    """The bench suite's two 10k rows through ``solver="schur_grid"``, each
    under pcg_backend "auto" (the gate's decision printed), "fused" (B2
    launched, B1 not) and "xla" (no launch), held to ``GRID_REF``; each
    timed (GN-iter/s, median of 2 rounds)."""
    import numpy as np

    from toyslam_torch.ops import grid_schur
    from toyslam_torch.optimizer import GaussNewton
    from toyslam_torch.sim import frontend, synthetic

    out, graphs = {}, {}
    for case, (graph_kw, _) in GRID_CASES.items():
        ref = GRID_REF[case]
        t0 = time.perf_counter()
        graph, poses_gt, _ = synthetic.make_large_problem(**graph_kw)
        t1 = time.perf_counter()
        graph = GaussNewton(grid_config(case, "fused"))._prepare(graph)
        t2 = time.perf_counter()
        gdev = graph.to(device)
        band = gdev.plan.band
        n = poses_gt.shape[0]
        decision = grid_schur._band_mode(grid_config(case, "auto"),
                                         gdev.plan, gdev.num_poses)
        row = {"poses_padded": gdev.num_poses,
               "landmarks_padded": gdev.num_landmarks,
               "kl_kp": [gdev.plan.L_pose.shape[0] // gdev.num_landmarks,
                         gdev.plan.P_pose.shape[0] // gdev.num_poses],
               "layout": {"chunk_b": band.chunk_b,
                          "k_windows": band.k_windows, "w_row": band.w_row,
                          "n_chunks": band.n_chunks, "n_wide": band.n_wide,
                          "tile_bytes": band.tile_bytes,
                          "cover_cap": int(band.cover.shape[-1])},
               "host_graph_build_s": t1 - t0, "host_grid_plan_s": t2 - t1,
               "auto_takes_band": decision, "runs": {}}
        failed = []
        for backend in ("auto", "fused", "xla"):
            gn = GaussNewton(grid_config(case, backend))
            reset_counts()
            res = gn.optimize(gdev)
            est = res.graph.poses.cpu().numpy()
            launches = read_counts()
            it = res.iterations_run
            errors = res.errors.cpu().numpy()[:it]
            b2 = launches["band_fused_pcg_chunk"]
            band_run = backend == "fused" or (backend == "auto" and decision)
            m = {"chi2": errors.tolist(),
                 "pcg_iters": res.pcg_iters[:it].tolist(),
                 "ate_rmse": frontend.ate_rmse(est[:n], poses_gt),
                 "ate_dead_reckoning": frontend.ate_rmse(
                     graph.poses[:n].numpy(), poses_gt),
                 "kernel_launches": launches}
            checks = {
                "launches": launches["fused_pcg_chunk"] == 0
                and ((b2 > 0) if band_run else (b2 == 0)),
                "finite": bool(np.isfinite(est).all()
                               and np.isfinite(errors).all()),
                "iterations": it == gn.config.iterations,
                "chi2_first": math.isclose(errors[0], ref["chi2"][0],
                                           rel_tol=1e-4),
                "chi2_final": math.isclose(errors[-1], ref["chi2"][-1],
                                           rel_tol=1e-2),
                "ate_dr": abs(m["ate_dead_reckoning"] - ref["ate_dr"]) <= 1e-4,
            }
            if case.endswith("revisit"):
                checks["ate"] = math.isclose(m["ate_rmse"], ref["ate"],
                                             rel_tol=5e-2)
            m["rate"] = gn_rate(gn, gdev, 2)
            m["checks"] = checks
            row["runs"][backend] = m
            failed += [f"{backend}: {k}" for k, ok in checks.items() if not ok]
        log("grid_path " + json.dumps({case: row}))
        out[case] = row
        graphs[case] = gdev
        if failed:
            raise AssertionError(f"grid row {case} checks failed: {failed}")
    return out, graphs


def grid_operands(gdev, cfg):
    """The grid solve's GN-iteration-0 operands: the preconditioner of
    ``cfg`` (a FusedPrecond in band mode, else ``(local, coarse)``), the
    band operator, the right-hand side (``[dp, Np]`` and ``[Np, dp]``),
    the plain loop's matvec and preconditioner apply, and a function that
    builds the band operator."""
    import torch

    from toyslam_torch.ops import blockmath as bm
    from toyslam_torch.ops import fused_pcg as fp
    from toyslam_torch.ops import grid_schur as gs
    from toyslam_torch.ops import schur

    gp, n, m = gdev.plan, gdev.num_poses, gdev.num_landmarks
    lam = torch.tensor(cfg.lambda_init, device=gdev.device)
    d = gs._damp(gs._assemble(gdev, gp, cfg), lam)
    hll_inv = schur.inv_blocks(d.hll)
    matvec, s_diag = gs._matvec_factory(d, hll_inv, gp, n, m)
    lm_p = gp.P_lm.reshape(n, d.kp)
    rhs = -d.bp + bm.mv(d.hpl_P, bm.mv(hll_inv, d.bl)[lm_p]).sum(1)
    pre = gs._build_precond(cfg, d, hll_inv, s_diag(), gdev, gp)

    def build():
        return fp.build_band_operator_grid(
            d.hll, d.hpl_P, lm_p, d.hpp_diag,
            d.tupper * gp.C_mask[:, None, None], gp.band, n)

    return dict(pre=pre, op=build(), rhs2=rhs.T.contiguous(), rhs=rhs,
                matvec=matvec, build=build, d=d)


def phase_grid_kernel(graphs):
    """B2 on the grid path: timed on the 10k row's own iteration-0
    operands (coarse level nc=320) against its plain version and its
    bound, with its per-phase split; held against its plain version
    (fresh, carried, rerun bits) on a seeded system of the same layout
    and shapes."""
    import torch

    gdev = graphs["large-sparse-10k"]
    cfg = grid_config("large-sparse-10k", "fused")
    chunk = cfg.pcg_fused_chunk
    ops = grid_operands(gdev, cfg)
    op, pre, rhs2 = ops["op"], ops["pre"], ops["rhs2"]
    shapes = {"tiles": list(op.tiles.shape), "u": list(op.u.shape),
              "pcr_levels": pre.alphas.shape[0], "nc": pre.cinv.shape[-1],
              "rmat": list(pre.rmat.shape), "cinv": list(pre.cinv.shape)}
    times = chunk_times(op, pre, rhs2, chunk, kernel="band_fused_pcg_chunk",
                        reps=10)
    bound = chunk_bound(op, pre, rhs2, chunk)
    split = band_phase_split(op, pre, rhs2, chunk,
                             statistics.mean(times["kernel"]))
    log("grid_band_phase_split " + json.dumps(split))
    band = gdev.plan.band
    win_off = band.win_off.cpu().numpy()
    del ops, op, pre
    torch.cuda.empty_cache()
    sop, spre, srhs = synthetic_band_system(
        gdev.num_poses, win_off, band.w_row, band.chunk_b * 2,
        2 * band.n_wide, shapes["pcr_levels"], cfg.pcg_coarse_group, 2e-2,
        seed=6, device=gdev.device)
    assert (list(sop.tiles.shape), spre.cinv.shape[-1]) == \
        (shapes["tiles"], shapes["nc"])
    out = compare_chunks("grid10k_L14_coarse320", sop, spre, srhs,
                         chunk=chunk, kernel="band_fused_pcg_chunk")
    del sop, spre, srhs
    torch.cuda.empty_cache()
    for r in out:
        log("grid_band_kernel_check " + json.dumps(r))
    log("grid_band_kernel " + json.dumps({"shapes": shapes,
                                          "chunk_ms": times,
                                          "bound": bound}))
    bad = [r for r in out if not r["ok"]]
    if bad:
        raise AssertionError(
            f"band kernel disagrees with plain version on the grid layout: "
            f"{bad}")
    return {"max_abs": max(r["max_abs_err"] for r in out),
            "chunk_ms": times, "bound": bound, "split": split}


def phase_grid_gate_fit(graphs, device):
    """The data of the band-vs-grid cost model (grid_schur._band_cost_wins)
    at three layouts (the two 10k rows and a 4096-pose graph): per GN
    iteration the band operator's build (tile write and slab-major copy),
    B2's cost per PCG trip and per launch (a 15- and a 5-iteration chunk),
    and the plain grid loop's cost per PCG iteration (15 and 5 iterations);
    the model's prediction and decision beside the measured costs."""
    import dataclasses

    import torch

    from toyslam_torch.ops import fused_pcg as fp
    from toyslam_torch.ops import grid_schur as gs
    from toyslam_torch.ops import schur
    from toyslam_torch.optimizer import GaussNewton
    from toyslam_torch.sim import synthetic

    small, _, _ = synthetic.make_large_problem(
        num_poses=4096, num_landmarks=4096, obs_per_pose=6, seed=0)
    cfg = grid_config("large-sparse-10k", "fused")
    layouts = dict(graphs)
    layouts["large-sparse-4k"] = GaussNewton(cfg)._prepare(small).to(device)
    out = {}
    for name, gdev in layouts.items():
        gp, n = gdev.plan, gdev.num_poses
        band = gp.band
        fused = grid_operands(gdev, cfg)
        plain = grid_operands(gdev, dataclasses.replace(cfg,
                                                        pcg_backend="xla"))
        op, pre, rhs2 = fused["op"], fused["pre"], fused["rhs2"]
        mw = 0 if op.u is None else op.u.shape[1]
        _, plan = fp.band_schedule(device.index or 0, band.n_chunks,
                                   band.k_windows, 3, band.w_row,
                                   band.chunk_b * 2, mw)
        st = fresh_state(rhs2)
        atol2 = torch.zeros(1, device=device)

        def launch(k):
            return lambda: fp.band_fused_pcg_chunk(op, pre, rhs2, st, atol2,
                                                   200, True, k)

        papply = gs._precond_apply(cfg, plain["pre"])

        def loop(k):
            return lambda: schur.pcg(plain["matvec"], papply, plain["rhs"],
                                     0.0, k, k)

        b15, b5 = cuda_ms(launch(15), 5), cuda_ms(launch(5), 5)
        g15, g5 = cuda_ms(loop(15), 3), cuda_ms(loop(5), 3)
        build = cuda_ms(lambda: fp._slab_major(fused["build"]().tiles,
                                               plan.cols), 3)
        rows = gp.L_pose.shape[0] + gp.P_pose.shape[0]
        model = dict(zip(("band_s", "grid_s"), gs._cost_model(cfg, gp)))
        out[name] = {
            "n": n, "rows": rows, "stack_bytes": band.tile_bytes,
            "windows": band.n_chunks * band.k_windows,
            "band_build_ms": build, "b2_chunk15_ms": b15, "b2_chunk5_ms": b5,
            "b2_trip_ms": (b15 - b5) / 10,
            "grid_pcg15_ms": g15, "grid_pcg5_ms": g5,
            "grid_iter_ms": (g15 - g5) / 10,
            "measured_band_ms": build + b15, "measured_grid_ms": g15,
            "model": model,
            "model_takes_band": gs._band_cost_wins(cfg, gp, n),
        }
        del fused, plain, op, pre
        torch.cuda.empty_cache()
    log("grid_gate_fit " + json.dumps(out))
    return out


def main() -> int:
    if not (ROOT / "toyslam_torch" / "csrc" / "fused_pcg_chunk.cu").exists():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(toyslam_torch/ not found beside it)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this smoke test runs only on "
              "the GPU", file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log("env " + json.dumps({
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
        "device": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }))

    from toyslam_torch import kernels

    t0 = time.perf_counter()
    libs = kernels.load_all(tuple(KERNELS))   # one nvcc each, in parallel
    load_s = time.perf_counter() - t0
    for name, kl in libs.items():
        log("build " + json.dumps({
            "kernel": name,
            "library": str(kl.path.relative_to(ROOT)),
            "nvcc_s": kl.build_seconds,
            "load_all_s": load_s,
        }))
        for line in kl.ptxas_log.splitlines():
            log("ptxas " + line.strip())

    failures = []
    state = {}
    phases = [
        ("kernels", lambda: state.update(max_abs=phase_kernels(device))),
        ("main_path", lambda: state.update(
            zip(("main", "gn", "gdev"), phase_main_path(device)))),
        ("timing", lambda: state.update(
            timing=phase_timing(state["gn"], state["gdev"]))),
        ("shape", lambda: state.update(shape=phase_shape(device))),
        ("scale_path", lambda: state.update(
            zip(("scale", "sgn", "sgdev", "sgt"), phase_scale_path(device)))),
        ("band_kernels", lambda: state.update(
            band=phase_band_kernels(state["sgn"], state["sgdev"]))),
        ("scale_timing", lambda: state.update(
            scale_timing=phase_scale_timing(state["sgn"], state["sgdev"]))),
        ("ba_kernels", lambda: state.update(
            ba_kernels=phase_ba_kernels(device))),
        ("ba_path", lambda: state.update(
            zip(("ba", "bgn", "bgdev"), phase_ba_path(device)))),
        ("ba_timing", lambda: state.update(ba_timing=path_timing(
            state["bgn"], state["bgdev"], "resident"))),
        ("ba_scale_path", lambda: state.update(
            ba_scale=phase_ba_scale_path(device))),
        ("ba_scale_timing", lambda: state.update(ba_scale_timing={
            case: path_timing(gn, gdev, "band")
            for case, (_, gn, gdev) in state["ba_scale"].items()})),
        ("plain_loop", lambda: state.update(
            plain=phase_plain_loop(device, state))),
        ("dense", lambda: state.update(dense=phase_dense(device, state))),
        ("grid_paths", lambda: state.update(
            zip(("grid", "ggraphs"), phase_grid_paths(device)))),
        ("grid_kernel", lambda: state.update(
            grid_kernel=phase_grid_kernel(state["ggraphs"]))),
        ("grid_gate_fit", lambda: state.update(
            grid_fit=phase_grid_gate_fit(state["ggraphs"], device))),
    ]
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
            log(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)")
        except Exception:  # report every phase, then fail as a whole
            failures.append(name)
            log(f"phase {name}: FAILED\n{traceback.format_exc()}")
    for key in ("timing", "scale_timing", "ba_timing", "ba_scale_timing"):
        if key in state:
            log(f"{key} " + json.dumps(state[key]))
    if failures:
        print(f"chip_smoke.py: failed phases: {failures}", file=sys.stderr)
        return 1

    # library_ms: no single PyTorch call computes a PCG chunk
    b1 = dict(KERNELS["fused_pcg_chunk"])
    b1.update(
        launches=state["main"]["kernel_launches"]["fused_pcg_chunk"],
        max_abs_err=state["max_abs"],
        ms=statistics.mean(state["timing"]["chunk_ms"]["kernel"]),
        plain_ms=statistics.mean(state["timing"]["chunk_ms"]["plain"]),
        bound_ms=state["timing"]["chunk_bound"]["bound_ms"],
        bound_by=state["timing"]["chunk_bound"]["bound_by"],
        library_ms=None,
    )
    b2 = dict(KERNELS["band_fused_pcg_chunk"])
    b2.update(
        launches=state["scale"]["kernel_launches"]["band_fused_pcg_chunk"],
        max_abs_err=state["band"]["max_abs"],
        ms=statistics.mean(state["band"]["chunk_ms"]["kernel"]),
        plain_ms=statistics.mean(state["band"]["chunk_ms"]["plain"]),
        bound_ms=state["band"]["bound"]["bound_ms"],
        bound_by=state["band"]["bound"]["bound_by"],
        library_ms=None,
    )
    # the dp=6 instances, on the BA paths: B1 on the bench row (128 x 512)
    # and the ba3d defaults, B2 on the two 512 x 4096 rows; timed at the
    # bench row's and at the 512 x 4096 layout's shapes
    bk = state["ba_kernels"]
    b1_case, b2_case = "dp6_Np128_Mw1536_L7", "dp6_ba512_band"
    ba_b1 = {"ba128": state["ba"]["ba128"]["kernel_launches"][
        "fused_pcg_chunk"],
        "ba3d_defaults": state["ba"]["ba3d_defaults"]["kernel_launches"]}
    ba_b2 = {case: m["kernel_launches"]["band_fused_pcg_chunk"]
             for case, (m, _, _) in state["ba_scale"].items()}
    b1["dp6"] = dict(
        launches=sum(ba_b1.values()), launches_by_path=ba_b1,
        max_abs_err=bk["b1_max_abs"],
        ms=statistics.mean(bk["ms"][b1_case]["kernel"]),
        plain_ms=statistics.mean(bk["ms"][b1_case]["plain"]),
        bound_ms=bk["bound"][b1_case]["bound_ms"],
        bound_by=bk["bound"][b1_case]["bound_by"], library_ms=None)
    b2["dp6"] = dict(
        launches=sum(ba_b2.values()), launches_by_path=ba_b2,
        max_abs_err=bk["b2_max_abs"],
        ms=statistics.mean(bk["ms"][b2_case]["kernel"]),
        plain_ms=statistics.mean(bk["ms"][b2_case]["plain"]),
        bound_ms=bk["bound"][b2_case]["bound_ms"],
        bound_by=bk["bound"][b2_case]["bound_by"], library_ms=None)
    # B2 on the schur_grid path: the launches of the "fused" and "auto" runs
    # of both 10k rows, timed on the 10k row's operands (nc=320)
    gk = state["grid_kernel"]
    b2["grid"] = dict(
        launches=sum(row["runs"][b]["kernel_launches"]["band_fused_pcg_chunk"]
                     for row in state["grid"].values()
                     for b in ("auto", "fused")),
        launches_by_path={
            f"{case}/{b}": row["runs"][b]["kernel_launches"][
                "band_fused_pcg_chunk"]
            for case, row in state["grid"].items() for b in ("auto", "fused")},
        max_abs_err=gk["max_abs"],
        ms=statistics.mean(gk["chunk_ms"]["kernel"]),
        plain_ms=statistics.mean(gk["chunk_ms"]["plain"]),
        bound_ms=gk["bound"]["bound_ms"], bound_by=gk["bound"]["bound_by"],
        library_ms=None)
    log(json.dumps({"kernels": [b1, b2]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
