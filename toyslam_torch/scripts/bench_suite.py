"""The port's benchmark suite: the JAX package's scale matrix, row by row.

    python -m toyslam_torch.scripts.bench_suite [--device cuda|cpu]
        [--rows r1,r2] [--quick] [--out PATH]

Counterpart of the JAX package's ``scripts/bench_suite.py`` (``bench_one``,
``_flop_byte_model_10k``, ``bench_ba3d``, ``main``): the same eight rows,
by name, in its order, with its graphs and its ``OptimizerConfig`` fields:

0. ``reference-150``: the 150-pose seeded simulation (B1 on the card);
1. ``multi-loop-1k``: 1050 poses driven around a 150-step circuit seven
   times, exact odometry Jacobians, PCG cap 300 (B1 at Np=1088);
2. ``large-sparse-10k`` and 3. ``large-sparse-10k-revisit``:
   ``make_large_problem`` at 10k poses through ``solver="schur_grid"``,
   whose ``auto`` gate takes the streamed band kernel (B2);
4-7. ``ba3d-128x512-{fused,xla}`` and their ``-matched64`` twins (both
   legs at tol 0 and a fixed budget of 64 PCG iterations): SE(3) bundle
   adjustment through B1 at dp=6, or the plain PCG loop.

Per row: the graph is laid out and moved to the device once; one warm-up
optimize, whose kernel launches are counted and whose result the row's
gate holds; then ``rounds`` rounds of ``reps`` optimizes, each fenced
with ``torch.cuda.synchronize()`` (``toyslam_torch.bench``).  Each row
prints one JSON line with the JAX row's keys (less ``edge_backend``, not
ported), the rate's IQR, ``kernel_launches`` and ``gate`` (each check and
``ok``).  The 10k row carries the same FLOP/byte model, divided by the
H100's peaks (``f32_peak_fraction`` where the JAX row has
``vpu_peak_fraction``).

The gates: the main path's values (ATE 0.7552 within 2e-3, chi^2 228733.5
at rtol 1e-4 and 27524.9 at 1e-3); multi-loop-1k the JAX package's TPU
record (``BENCH_SUITE.json``: chi^2 2449381.8 at rtol 1e-4, 2859.7 at
1e-3, ATE 0.0683 within 2e-3); the 10k rows and the BA rows the JAX
package's f32 plain-PCG runs on the CPU (``GRID_REF``, ``BA_REF``); and
on the card each row's kernel (``KERNEL``) launched, the other not.

``--quick`` runs one timed round of one optimize per row.  A row whose
gate fails makes the run exit 1 after every row has printed.  Nothing is
written unless ``--out`` is given.  ``--device cuda`` (the default) exits
2 without a GPU; ``--device cpu`` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time

import numpy as np
import torch

from toyslam_torch.app import resolve_device
from toyslam_torch.bench import (
    device_fields,
    launches,
    rate,
    reset_launches,
    timed_rounds,
)

# H100 SXM peaks (NVIDIA's data sheet, at 700 W): HBM3 bytes/s and f32
# FLOP/s outside the tensor cores
H100_HBM_BYTES_S = 3.35e12
H100_F32_FLOPS = 67e12

# the 10k rows' config (scripts/bench_suite.py:291-297)
GRID_OPT = dict(
    iterations=15, lr=1.0, solver="schur_grid", exact_odom_jacobians=True,
    pcg_tol=1e-2, pcg_max_iters=15, pcg_restart_every=15,
    pcg_precond="tridiag+coarse", pcg_coarse_group=32, pcg_precond_refresh=5,
    pcg_backend="auto", pcg_fused_chunk=15,
)
# the BA rows' configs (scripts/bench_suite.py:185-199): the convergence
# policy, and the matched budget that pins both legs to 64 iterations
BA_OPT = dict(
    iterations=20, lr=1.0, solver="schur3d", exact_odom_jacobians=True,
    huber_delta=4.0, pcg_tol=1e-6, pcg_max_iters=200, convergence_eps=1e-8,
    reject_worse_steps=True, pcg_precond="tridiag", pcg_fused_chunk=16,
)
BA_MATCHED_OPT = dict(BA_OPT, pcg_tol=0.0, pcg_max_iters=64,
                      pcg_restart_every=64)

# Gates.  The 2D simulation rows: (chi^2 first, chi^2 final, ATE, the
# dead-reckoning ATE), chi^2 at rtol 1e-4 / 1e-3, the ATE within 2e-3.
SIM_REF = {
    "reference-150": dict(chi2=(228733.5, 27524.9), ate=0.7552,
                          ate_dr=6.5673),
    "multi-loop-1k": dict(chi2=(2449381.8, 2859.7), ate=0.0683,
                          ate_dr=7.6996),
}
# The 10k rows: the JAX package's f32 schur_grid run with
# pcg_backend="xla" on the CPU.  chi^2 first at rtol 1e-4, final within
# 1 %, the ATE within 5 % on the revisit row (the other's drifts with the
# map).
GRID_REF = {
    "large-sparse-10k": dict(chi2=(10942544.0, 6652.3388671875),
                             ate=10.063098907470703,
                             ate_dr=53.99301528930664),
    "large-sparse-10k-revisit": dict(chi2=(27641242.0, 6861.9853515625),
                                     ate=1.4336570501327515,
                                     ate_dr=40.60987854003906),
}
# The BA rows: the JAX package's f32 plain-PCG run of each config on the
# CPU.  BA in f32 is chaotic (the trajectory and the ATE move with the
# summation order), so chi^2 is held: at iteration 0 (rtol 1e-4), never
# rising, and at the end (rtol 1e-4: the JAX package's fused and plain
# legs end within 1e-6 of each other), with the final ATE below half the
# initial one.
BA_REF = {
    "policy": dict(chi2=(1744823.875, 4624.5419921875),
                   ate_initial=1.5134034156799316, final_rtol=1e-4),
    "matched64": dict(chi2=(1744823.875, 4624.53857421875),
                      ate_initial=1.5134034156799316, final_rtol=1e-4),
}
# the kernel each row's solve takes on the card (None: the plain loop)
KERNEL = {
    "reference-150": "fused_pcg_chunk",
    "multi-loop-1k": "fused_pcg_chunk",
    "large-sparse-10k": "band_fused_pcg_chunk",
    "large-sparse-10k-revisit": "band_fused_pcg_chunk",
    "ba3d-128x512-fused": "fused_pcg_chunk",
    "ba3d-128x512-xla": None,
    "ba3d-128x512-fused-matched64": "fused_pcg_chunk",
    "ba3d-128x512-xla-matched64": None,
}
ROWS = tuple(KERNEL)
# optimizes per timed round, 3 rounds each (the JAX suite's reps)
REPS = {"reference-150": 20, "multi-loop-1k": 10, "large-sparse-10k": 3,
        "large-sparse-10k-revisit": 3}
BA_REPS, ROUNDS = 5, 3


def optimizer_config(name: str):
    """The row's ``OptimizerConfig``, field for field the JAX suite's."""
    from toyslam_torch.config import OptimizerConfig

    if name == "reference-150":
        return OptimizerConfig(iterations=10, lr=0.2, solver="schur")
    if name == "multi-loop-1k":
        return OptimizerConfig(iterations=15, lr=0.5, solver="schur",
                               exact_odom_jacobians=True, pcg_max_iters=300)
    if name == "large-sparse-10k":
        return OptimizerConfig(**GRID_OPT)
    if name == "large-sparse-10k-revisit":
        return OptimizerConfig(**dict(GRID_OPT, iterations=20))
    backend = "fused" if "-fused" in name else "xla"
    kw = BA_MATCHED_OPT if name.endswith("-matched64") else BA_OPT
    return OptimizerConfig(**dict(kw, pcg_backend=backend))


def row_graph(name: str):
    """The row's graph (on the host), its ground-truth poses and its
    number of real poses."""
    from toyslam_torch.config import SimConfig, SlamConfig
    from toyslam_torch.sim import frontend, synthetic, synthetic3d

    if name.startswith("ba3d-"):
        graph, gt, _ = synthetic3d.make_ba_problem(
            num_poses=128, num_landmarks=512, obs_per_pose=24, seed=0)
        return graph, gt, gt.shape[0]
    if name == "large-sparse-10k":
        graph, gt, _ = synthetic.make_large_problem(
            num_poses=10_000, num_landmarks=10_000, obs_per_pose=6, seed=0)
        return graph, gt, 10_000
    if name == "large-sparse-10k-revisit":
        graph, gt, _ = synthetic.make_large_problem(
            num_poses=10_000, num_landmarks=5_000, obs_per_pose=6, seed=0,
            laps=2)
        return graph, gt, gt.shape[0]
    steps = {"reference-150": 150, "multi-loop-1k": 1050}[name]
    cfg = SlamConfig(sim=SimConfig(robot_steps=steps, seed=0))
    controls = (synthetic.multi_loop_controls(1049, loop_steps=150)
                if name == "multi-loop-1k" else None)
    sim = frontend.simulate(cfg.sim, controls=controls)
    graph, _ = frontend.build_graph(sim, cfg)
    return graph, sim.poses_gt, steps


def flop_byte_model_10k(n, m, e1, e2, pcg_iters, levels=14, nc=320):
    """Rough per-GN-iteration FLOP / HBM-byte model of the Schur path (the
    JAX suite's): linearization ~350 FLOPs an edge; per PCG iteration the
    matvec, the PCR apply (levels x 2 block matvecs), the coarse solve and
    ~6 vector passes; the bytes re-read per PCG iteration."""
    lin = 350 * (e1 + e2)
    matvec = 48 * 2 * e2 + 8 * m + 18 * n + 36 * e1
    tri = levels * 40 * n
    coarse = 2 * (3 * nc) ** 2
    axpy = 8 * 3 * n
    flops = lin + pcg_iters * (matvec + tri + coarse + axpy)

    grids = (e2 * 6 * 2 + n * 9 + m * 4 + e1 * 9 * 2) * 4
    pcr = (2 * levels + 1) * n * 9 * 4
    coarse_b = (3 * nc) ** 2 * 4
    state = 6 * n * 3 * 4
    bytes_ = (e1 + e2) * 30 * 4 + pcg_iters * (
        grids + pcr + coarse_b + state
    )
    return flops, bytes_


def _reproj_rmse(g) -> float:
    from toyslam_torch.ops import residuals3d

    ev = residuals3d.eval_reproj_edges(
        g.poses, g.landmarks, g.intrinsics, g.lm_edges.pose, g.lm_edges.lm,
        g.lm_edges.meas, g.lm_edges.info, g.lm_edges.mask, huber_delta=1e9)
    r2 = (ev.r.double() ** 2).sum(-1)
    return float(torch.sqrt(r2[g.lm_edges.mask > 0].mean()))


def gate(name: str, row: dict, chi2: np.ndarray, on_card: bool) -> dict:
    """The row's checks, each True or False."""
    ok = {"finite": row["finite"]}
    if name in SIM_REF or name in GRID_REF:
        ref = SIM_REF.get(name) or GRID_REF[name]
        final_rtol = 1e-3 if name in SIM_REF else 1e-2
        ok["chi2_first"] = math.isclose(chi2[0], ref["chi2"][0], rel_tol=1e-4)
        ok["chi2_final"] = math.isclose(chi2[-1], ref["chi2"][1],
                                        rel_tol=final_rtol)
        ok["ate_dr"] = abs(row["ate_dead_reckoning"] - ref["ate_dr"]) <= 1e-4
        if name in SIM_REF:
            ok["ate"] = abs(row["ate_rmse"] - ref["ate"]) <= 2e-3
        else:
            ok["iterations"] = row["iters_run"] == optimizer_config(
                name).iterations
            if name.endswith("revisit"):
                ok["ate"] = math.isclose(row["ate_rmse"], ref["ate"],
                                         rel_tol=5e-2)
    else:
        ref = BA_REF["matched64" if name.endswith("-matched64")
                     else "policy"]
        ok["chi2_first"] = math.isclose(chi2[0], ref["chi2"][0], rel_tol=1e-4)
        # LM with step rejection: chi^2 never rises
        ok["chi2 non-increasing"] = bool(np.all(np.diff(chi2) <= 0.0))
        ok["chi2_final"] = math.isclose(chi2[-1], ref["chi2"][1],
                                        rel_tol=ref["final_rtol"])
        ok["ate_initial"] = abs(row["ate_initial"]
                                - ref["ate_initial"]) <= 1e-4
        ok["ate_final"] = row["ate_rmse"] < ref["ate_initial"] / 2
    counts = row["kernel_launches"]
    want = KERNEL[name] if on_card else None
    ok["launches"] = all((n > 0) == (k == want) for k, n in counts.items())
    return ok


def capped(cfg, iterations: int | None):
    """``cfg`` with its GN iterations capped at ``iterations`` (None: as
    it is); the scale entry points' ``--iterations``."""
    if iterations is None:
        return cfg
    return dataclasses.replace(cfg, iterations=min(cfg.iterations,
                                                   iterations))


def solver_mode(cfg, gdev) -> str | None:
    """The kernel route the gate takes for a laid-out graph: "resident"
    (B1), "band" (B2) or None (the plain PCG loop, or the dense solve)."""
    from toyslam_torch.ops import fused_pcg as fp
    from toyslam_torch.ops import grid_schur

    if cfg.solver == "dense":
        return None
    if cfg.solver == "schur_grid":
        return "band" if grid_schur._band_mode(cfg, gdev.plan,
                                               gdev.num_poses) else None
    return fp.fused_mode(cfg, gdev)


def bench_one(name: str, graph, gt, cfg, n_real: int, device: torch.device,
              reps: int, rounds: int, flops: float | None = None,
              bytes_: float | None = None, gdev=None):
    """One benchmark row (the JAX suite's ``bench_one``): the graph laid
    out and moved to ``device`` once (or ``gdev``, laid out already), one
    warm-up optimize whose kernel launches are counted, then ``rounds``
    rounds of ``reps`` optimizes.  Returns the row (the JAX row's keys,
    the SE(3) ATE and reprojection RMSE on a ``schur3d`` row, the FLOP/byte
    model's rates where ``flops`` and ``bytes_`` are given) and the
    warm-up's chi^2 per GN iteration."""
    from toyslam_torch.optimizer import GaussNewton
    from toyslam_torch.sim import frontend, synthetic3d

    gn = GaussNewton(cfg)
    if gdev is None:
        gdev = gn._prepare(graph).to(device)
    mode = solver_mode(cfg, gdev)

    reset_launches()
    res = gn.optimize(gdev)
    est = res.graph.poses[:n_real].cpu().numpy()       # fence
    counts = launches()
    iters = res.iterations_run
    times = timed_rounds(lambda: gn.optimize(gdev), device, rounds, reps)

    errs = res.errors.cpu().numpy()
    chi2 = errs[~np.isnan(errs)]
    row = {
        "config": name,
        "poses": n_real,
        "landmarks": int(graph.lm_mask.sum()),
        "lm_edges": int(graph.lm_edges.mask.sum()),
        **rate(iters, times),
        "iters_run": iters,
    }
    if cfg.solver == "schur3d":
        row["ate_rmse"] = synthetic3d.pose_ate_rmse(est, gt)
        row["ate_initial"] = synthetic3d.pose_ate_rmse(
            graph.poses[:n_real].numpy(), gt)
        row["reproj_rmse_px"] = _reproj_rmse(res.graph)
    else:
        row["ate_rmse"] = frontend.ate_rmse(est, gt)
        row["ate_dead_reckoning"] = frontend.ate_rmse(
            graph.poses[:n_real].numpy(), gt)
    row.update(
        chi2_first=float(chi2[0]) if chi2.size else None,
        chi2_last=float(chi2[-1]) if chi2.size else None,
        pcg_iters=res.pcg_iters[:iters].tolist(),
        solver_mode=mode,
        kernel_launches=counts,
        finite=bool(np.isfinite(est).all() and np.isfinite(chi2).all()),
        **device_fields(device),
    )
    if flops:
        t_iter = row["wall_s"] / iters
        row.update(
            flops_per_gn_iter_model=flops,
            achieved_gflops=flops / t_iter / 1e9,
            f32_peak_fraction=flops / t_iter / H100_F32_FLOPS,
            hbm_bytes_per_gn_iter_model=bytes_,
            achieved_gbps=bytes_ / t_iter / 1e9,
            hbm_peak_fraction=bytes_ / t_iter / H100_HBM_BYTES_S,
        )
    return row, chi2


def bench_row(name: str, device: torch.device, rounds: int,
              reps: int | None = None) -> dict:
    """One row: its JSON object (printed)."""
    graph, gt, n = row_graph(name)
    cfg = optimizer_config(name)
    if reps is None:
        reps = BA_REPS if name.startswith("ba3d-") else REPS[name]
    flops = bytes_ = None
    if name == "large-sparse-10k":
        flops, bytes_ = flop_byte_model_10k(
            graph.num_poses, graph.num_landmarks, graph.odom.count,
            graph.lm_edges.count, pcg_iters=cfg.pcg_max_iters,
            nc=graph.num_poses // cfg.pcg_coarse_group)
    row, chi2 = bench_one(name, graph, gt, cfg, n, device, reps, rounds,
                          flops, bytes_)
    checks = gate(name, row, chi2, device.type == "cuda")
    row["gate"] = {"checks": checks, "ok": all(checks.values())}
    print(json.dumps(row), flush=True)
    return row


def run(device: torch.device, names=ROWS, quick: bool = False) -> list:
    """Every named row in the suite's order; their JSON objects."""
    return [bench_row(name, device, 1 if quick else ROUNDS,
                      1 if quick else None)
            for name in ROWS if name in names]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--rows", default=None,
                    help="comma-separated row names (default: all eight)")
    ap.add_argument("--quick", action="store_true",
                    help="one timed round of one optimize per row")
    ap.add_argument("--out", default=None,
                    help="write the rows to this JSON file")
    args = ap.parse_args(argv)
    names = ROWS if args.rows is None else tuple(args.rows.split(","))
    unknown = sorted(set(names) - set(ROWS))
    if unknown:
        ap.error(f"unknown rows: {unknown}; rows: {', '.join(ROWS)}")
    device = resolve_device(args.device)
    if device is None:
        return 2
    results = run(device, names, args.quick)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"measured_at": time.strftime("%Y-%m-%d %H:%M:%S"),
                       **device_fields(device),
                       "note": "median-of-rounds headline, every round "
                               "recorded; rounds fenced with "
                               "torch.cuda.synchronize()",
                       "configs": results}, f, indent=2)
    failed = [r["config"] for r in results if not r["gate"]["ok"]]
    if failed:
        print(f"gates failed: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
