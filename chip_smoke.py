"""Smoke test of the PyTorch port on one CUDA GPU (an H100 for sm_90a).

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each of which must pass:

1. environment: the card (nvidia-smi name and power limit), torch and CUDA
   versions, and the build of the hand-written kernel from
   toyslam_torch/csrc (its build time and ptxas report);
2. kernel vs plain PyTorch on the card: one chunk launch from the same state
   at (dp=3, Np=192, Mw=768, L=8), the same with L=0, the same with a
   coarse level (nc=3) and at Np=2048, each a fresh and a carried chunk —
   ``it`` and ``stop`` equal, x within 1e-4 of max|x|, r_true and rr within
   1e-4 of max|rhs| and ||rhs||^2 (see compare_chunks) — and both timed;
3. the main path: the 150-pose seeded simulation, the graph build and
   ``GaussNewton(...).optimize`` on the card through the kernel, checked
   against the reference values of the JAX package (ATE 0.7552 within
   2e-3, dead-reckoning ATE 6.5673, chi^2 first 228733.5 at rtol 1e-4 and
   final 27524.9 at rtol 1e-3) with the kernel's launch count;
4. timing, fenced with torch.cuda.synchronize(): GN-iter/s as the median of
   5 rounds x 20 optimize() calls; the time of each layer of one GN
   iteration; one chunk of the kernel vs the plain version (CUDA events);
5. a shape check at robot_steps=2000 (Np=2048): chi^2 decreases and the
   optimized ATE beats dead reckoning.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``, printed only when every phase passed.
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
KERNEL = {
    "name": "fused_pcg_chunk",
    "route": "cuda",
    "source": "toyslam_torch/csrc/fused_pcg_chunk.cu",
    "replaces": "toyslam_tpu/ops/fused_pcg.py:344",
}
REL_TOL = 1e-4
ATE_REF, ATE_TOL = 0.7552, 2e-3
ATE_DR_REF = 6.5673
CHI2_FIRST, CHI2_FINAL = 228733.5, 27524.9


def log(msg: str) -> None:
    print(msg, flush=True)


# --- phase 2: the kernel against its plain version ----------------------


def synthetic_system(np_, mw, nlevels, nc, eps, seed, device):
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

    dp = 3
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


def compare_chunks(case, op, pre, rhs, chunk=16, maxit=200, tol=1e-6):
    """Kernel vs plain version from the same state: a fresh first chunk
    (restart) and a second chunk carrying the recurrence (no restart).

    ``x`` is compared at its own scale.  ``r_true = rhs - S x`` and ``rr``
    are compared at the scale of ``rhs`` and ``||rhs||^2``: near the f32
    floor ``r_true`` is rounding noise of that size, so its own scale
    would compare noise with noise.  Both readings are printed."""
    import torch

    from toyslam_torch.ops import fused_pcg as fp

    rhs2 = float((rhs * rhs).sum())
    rhs_max = float(rhs.abs().max())
    atol2 = ((tol ** 2) * (rhs * rhs).sum()).reshape(1)
    st = fresh_state(rhs)
    results = []
    for restart in (True, False):
        ref = fp.fused_pcg_chunk_ref(op, pre, rhs, st, atol2, maxit, restart,
                                     chunk)
        ker = fp.fused_pcg_chunk(op, pre, rhs, st, atol2, maxit, restart, chunk)
        torch.cuda.synchronize()
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
        ok = same and all(e <= REL_TOL for e in errs.values()) and all(
            bool(torch.isfinite(t).all()) for t in (ker.x, ker.rt, ker.rr)
        )
        results.append({
            "case": case, "restart": restart, "ok": ok,
            "it": [int(ker.it), int(ref.it)],
            "stop": [int(ker.stop), int(ref.stop)],
            "rel": errs, "rel_own_scale": own, "max_abs_err": max(dx, drt),
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


# --- phase 3: the main path ---------------------------------------------


def main_config(steps=150):
    from toyslam_torch.config import OptimizerConfig, SimConfig, SlamConfig

    return SlamConfig(
        sim=SimConfig(robot_steps=steps, seed=0),
        optimizer=OptimizerConfig(
            iterations=10, lr=0.2, solver="schur", pcg_precond="tridiag",
        ),
    )


def run_path(steps, device):
    import numpy as np

    from toyslam_torch.ops import fused_pcg as fp
    from toyslam_torch.optimizer import GaussNewton
    from toyslam_torch.sim import frontend

    cfg = main_config(steps)
    t0 = time.perf_counter()
    sim = frontend.simulate(cfg.sim)
    graph, _ = frontend.build_graph(sim, cfg)
    host_s = time.perf_counter() - t0
    gn = GaussNewton(cfg.optimizer)
    gdev = graph.to(device)
    fp.fused_pcg_chunk.launches = 0
    res = gn.optimize(gdev)
    est = res.graph.poses.cpu().numpy()
    launches = fp.fused_pcg_chunk.launches
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
        "launches > 0": m["kernel_launches"] > 0,
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


def layer_system(gn, graph):
    """The GN-iteration-0 solve of the main path split into its layers."""
    import torch

    from toyslam_torch.ops import blockmath as bm
    from toyslam_torch.ops import fused_pcg as fp
    from toyslam_torch.ops import schur

    cfg = gn.config
    lam = torch.tensor(cfg.lambda_init, device=graph.device)
    plan = graph.plan
    state = {}

    def assemble():
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
        state["op"] = fp.build_fused_operator(state["d"], state["hll_inv"],
                                              graph)

    def pcg():
        state["res"] = fp.fused_pcg(state["op"], state["pre"], state["rhs2"],
                                    cfg.pcg_tol, cfg.pcg_max_iters,
                                    cfg.pcg_fused_chunk,
                                    cfg.pcg_restart_every)

    def backsub():
        d = state["d"]
        u = schur.hlp_matvec(d, graph.lm_edges.pose, state["res"].x.T, plan)
        state["dx_l"] = bm.mv(state["hll_inv"], -d.bl - u)

    return state, [("assemble_blocks", assemble),
                   ("damp_eliminate_rhs_sdiag", eliminate),
                   ("build_fused_precond", precond),
                   ("build_fused_operator", operator),
                   ("fused_pcg", pcg),
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


def chunk_times(op, pre, rhs, chunk=16):
    """One fresh chunk, kernel and plain version in turns (plain, kernel,
    kernel, plain), CUDA events."""
    from toyslam_torch.ops import fused_pcg as fp

    st = fresh_state(rhs)
    atol2 = ((1e-6 ** 2) * (rhs * rhs).sum()).reshape(1)

    def ker():
        fp.fused_pcg_chunk(op, pre, rhs, st, atol2, 200, True, chunk)

    def plain():
        fp.fused_pcg_chunk_ref(op, pre, rhs, st, atol2, 200, True, chunk)

    p1, k1, k2, p2 = (cuda_ms(plain, 10), cuda_ms(ker, 50),
                      cuda_ms(ker, 50), cuda_ms(plain, 10))
    return {"kernel": [k1, k2], "plain": [p1, p2]}


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

    out["chunk_ms"] = chunk_times(state["op"], state["pre"], state["rhs2"],
                                  gn.config.pcg_fused_chunk)
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
        "launches > 0": m["kernel_launches"] > 0,
        "finite": m["finite"],
        "chi2 decreases": m["chi2"][-1] < m["chi2"][0],
        "ate < dead reckoning": m["ate_rmse"] < m["ate_dead_reckoning"],
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"shape check failed: {failed}")
    return m


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
    kl = kernels.load("fused_pcg_chunk")
    log("build " + json.dumps({
        "library": str(kl.path.relative_to(ROOT)),
        "nvcc_s": kl.build_seconds,
        "load_s": time.perf_counter() - t0,
    }))
    for line in kl.ptxas_log.splitlines():
        log("ptxas " + line.strip())

    failures = []
    kernel = dict(KERNEL)
    state = {}
    phases = [
        ("kernels", lambda: state.update(max_abs=phase_kernels(device))),
        ("main_path", lambda: state.update(
            zip(("main", "gn", "gdev"), phase_main_path(device)))),
        ("timing", lambda: state.update(
            timing=phase_timing(state["gn"], state["gdev"]))),
        ("shape", lambda: state.update(shape=phase_shape(device))),
    ]
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
            log(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)")
        except Exception:  # report every phase, then fail as a whole
            failures.append(name)
            log(f"phase {name}: FAILED\n{traceback.format_exc()}")
    if "timing" in state:
        log("timing " + json.dumps(state["timing"]))
    if failures:
        print(f"chip_smoke.py: failed phases: {failures}", file=sys.stderr)
        return 1

    t = state["timing"]
    kernel.update(
        launches=state["main"]["kernel_launches"],
        max_abs_err=state["max_abs"],
        ms=statistics.mean(t["chunk_ms"]["kernel"]),
        plain_ms=statistics.mean(t["chunk_ms"]["plain"]),
    )
    log(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
