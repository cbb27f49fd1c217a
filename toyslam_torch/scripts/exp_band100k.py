"""The 100k A/B: the streamed band kernel (B2) against the plain grid loop
with the same preconditioner and PCG budget on both sides.

    python -m toyslam_torch.scripts.exp_band100k [--device cuda|cpu]
        [--scale S] [--iterations N] [--rows r1,r2] [--reps N] [--rounds N]
        [--out PATH]

Counterpart of the JAX package's ``scripts/exp_band100k.py`` (``bench``,
``main``): the low-noise 100k-pose revisit graph (the converging one) and
its six rows, in its order, with its ``OptimizerConfig`` fields:

* ``grid-100k-jacobi-cg128``: ``schur_grid``, ``jacobi+coarse`` (group
  128: nc=784), cap 60, 10 GN iterations, the plain grid loop
  (``pcg_backend="xla"``);
* ``band-100k-jacobi-cg128``: the same through B2 (``pcg_backend="fused"``
  forces it; ``auto`` declines stacks above 250 MB), chunk ``BAND_CHUNK``
  (environment variable, default 15);
* the budget scan through B2: ``-cap30`` (chunk 15, 20 GN iterations),
  ``-cap20`` (chunk 10, 24) and ``-cap40`` (chunk 20, 14);
* ``grid-100k-tridiag-cg128``: the plain grid loop with ``tridiag+coarse``.

The graph is built once and laid out once (its grid plan carries the band
layout, which the plain rows ignore) and moved to the device once.  Per row
(``toyslam_torch.scripts.bench_suite.bench_one``): one warm-up optimize
whose launches are counted, then ``rounds`` rounds of ``reps`` optimizes
(the JAX script's 3 x 1).  Before the first row the band gate of the
port's own budgets (``grid_schur._band_mode``: the band tile plan and
``fused_pcg.BAND_BUDGET_BYTES``, not TPU VMEM) must take the band rows;
``band_layout`` gives the JAX formula's ``tile_stack_gb`` (the f32 stack
at dl=2) beside what the port holds: the stack, which B2 reads as built
(``port_stack_bytes``), and all the band solve's operands
(``band_device_bytes``).  The summary line has ``chi2_match_rel`` (the
final chi^2 of the two cap-60 jacobi rows), ``speedup_vs_grid_jacobi``
and ``speedup_vs_grid_tridiag`` (the band row over each plain row).

Each row is held to the JAX package's recorded chi^2 (``BAND100K_REF``
of ``chip_smoke.py``: first at rtol 1e-4, final within 1 %), the cap in
every GN iteration and its kernel's launches; ``chi2_match_rel`` to 1e-3.
A failed gate makes the run exit 1.  ``--scale`` multiplies the graph's
poses and landmarks and ``--iterations`` caps each row's GN iterations
(development on the CPU; the references hold at full size only).  Nothing is written unless ``--out`` is given.  ``--device
cuda`` (the default) exits 2 without a GPU; ``--device cpu`` runs the
kernels' plain versions.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time

import numpy as np

from toyslam_torch.app import resolve_device
from toyslam_torch.bench import device_fields
from toyslam_torch.scripts.bench_suite import bench_one, capped

# the JAX script's graph (scripts/exp_band100k.py:77-83) and configs
# (:90-142)
GRAPH = dict(num_poses=100_000, num_landmarks=50_000, obs_per_pose=6,
             seed=0, laps=2, pose_bucket=1024, landmark_bucket=1024,
             edge_bucket=8192)
LOW_NOISE = dict(position_std=0.05, orientation_std=math.radians(0.2))
COMMON = dict(
    iterations=10, lr=1.0, exact_odom_jacobians=True,
    pcg_tol=1e-3, pcg_max_iters=60, pcg_restart_every=30,
    pcg_precond="jacobi+coarse", pcg_coarse_group=128,
    pcg_precond_refresh=5,
)
# the budget scan: (PCG cap = restart, chunk, GN iterations)
SCAN = {"cap30": (30, 15, 20), "cap20": (20, 10, 24), "cap40": (40, 20, 14)}
ROWS = ("grid-100k-jacobi-cg128", "band-100k-jacobi-cg128",
        "band-100k-jacobi-cg128-cap30", "band-100k-jacobi-cg128-cap20",
        "band-100k-jacobi-cg128-cap40", "grid-100k-tridiag-cg128")
REPS, ROUNDS = 1, 3
# The JAX package's recorded chi^2 on this graph (BENCH_BAND100K.json; the
# same as chip_smoke.BAND100K_REF): at GN iteration 0 (rtol 1e-4), and the
# plateau every row reaches (within 1 %)
REF = dict(chi2_first=4245268.0, chi2_final=23301.2, final_rtol=1e-2)
CHI2_MATCH_MAX = 1e-3


def band_chunk() -> int:
    """The band rows' chunk, as the JAX script reads it."""
    return int(os.environ.get("BAND_CHUNK", "15"))


def optimizer_config(name: str):
    """The row's ``OptimizerConfig``, field for field the JAX script's."""
    from toyslam_torch.config import OptimizerConfig

    if name == "grid-100k-jacobi-cg128":
        return OptimizerConfig(solver="schur_grid", pcg_backend="xla",
                               **COMMON)
    if name == "grid-100k-tridiag-cg128":
        return OptimizerConfig(solver="schur_grid", pcg_backend="xla",
                               **dict(COMMON, pcg_precond="tridiag+coarse"))
    band = OptimizerConfig(solver="schur_grid", pcg_backend="fused",
                           pcg_fused_chunk=band_chunk(), **COMMON)
    suffix = name.rsplit("-", 1)[-1]
    if suffix in SCAN:
        cap, chunk, iterations = SCAN[suffix]
        return dataclasses.replace(band, pcg_max_iters=cap,
                                   pcg_restart_every=cap,
                                   pcg_fused_chunk=chunk,
                                   iterations=iterations)
    return band


def build_graph(scale: float = 1.0):
    """The low-noise revisit graph, poses and landmarks times ``scale``:
    ``(graph, poses_gt, landmarks_gt)``."""
    from toyslam_torch.config import NoiseConfig
    from toyslam_torch.sim import synthetic

    kw = dict(GRAPH, num_poses=int(GRAPH["num_poses"] * scale),
              num_landmarks=int(GRAPH["num_landmarks"] * scale))
    return synthetic.make_large_problem(noise=NoiseConfig(**LOW_NOISE), **kw)


def band_layout(gdev, cfg) -> dict:
    """The band layout, the JAX formula's stack size and the bytes the
    port holds for it on the card."""
    from toyslam_torch.ops import fused_pcg as fp

    b = gdev.plan.band
    n_pad = gdev.num_poses
    stack_gb = (b.n_chunks * b.k_windows * 3 * b.w_row * b.chunk_b * 2
                * 4) / 1e9
    return {"chunk_b": b.chunk_b, "k_windows": b.k_windows,
            "w_row": b.w_row, "n_wide": b.n_wide, "n_chunks": b.n_chunks,
            "tile_stack_gb": stack_gb,
            "port_stack_bytes": b.tile_bytes,
            "band_device_bytes": fp.band_device_bytes(
                3, n_pad, b, 2 * b.n_wide, 0,
                n_pad // cfg.pcg_coarse_group)}


def gate(name: str, row: dict, chi2: np.ndarray, on_card: bool,
         full_size: bool, iterations: int | None = None) -> dict:
    """The row's checks, each True or False."""
    cfg = capped(optimizer_config(name), iterations)
    ok = {"finite": row["finite"],
          "iterations": row["iters_run"] == cfg.iterations,
          "chi2 below the start": bool(chi2[-1] < chi2[0])}
    if cfg.pcg_precond == "jacobi+coarse":
        # as recorded: the cap in every GN iteration (the tridiag row
        # stopped at 59 once)
        ok["pcg cap in every GN iteration"] = (
            row["pcg_iters"] == [cfg.pcg_max_iters] * row["iters_run"])
    if full_size:
        ok["chi2_first"] = math.isclose(chi2[0], REF["chi2_first"],
                                        rel_tol=1e-4)
        ok["chi2_final"] = math.isclose(chi2[-1], REF["chi2_final"],
                                        rel_tol=REF["final_rtol"])
    want = ("band_fused_pcg_chunk" if on_card and name.startswith("band-")
            else None)
    ok["launches"] = all((n > 0) == (k == want)
                         for k, n in row["kernel_launches"].items())
    ok["route"] = row["solver_mode"] == (
        "band" if name.startswith("band-") else None)
    return ok


def run(device, names=ROWS, scale: float = 1.0, reps: int = REPS,
        rounds: int = ROUNDS, graph=None,
        iterations: int | None = None) -> dict:
    """The named rows on one graph (built here unless ``graph``, a
    ``(graph, poses_gt, landmarks_gt)`` triple or a laid-out one, is
    given); the summary object.  Raises ``AssertionError`` where the JAX
    script asserts: no band layout, or the gate declines the band rows."""
    from toyslam_torch.ops import grid_schur
    from toyslam_torch.optimizer import GaussNewton

    graph, poses_gt, _ = graph if graph is not None else build_graph(scale)
    n_real = poses_gt.shape[0]
    band_cfg = optimizer_config("band-100k-jacobi-cg128")
    t0 = time.perf_counter()
    laid = GaussNewton(band_cfg)._prepare(graph)    # grid plan + band search
    plan_s = time.perf_counter() - t0
    if laid.plan.band is None:
        raise AssertionError(f"no band layout found at {n_real} poses")
    gdev = laid.to(device)
    if not grid_schur._band_mode(band_cfg, gdev.plan, gdev.num_poses):
        raise AssertionError("the band gate declined jacobi+coarse")
    layout = band_layout(gdev, band_cfg)
    print(json.dumps({"band_layout": layout, "host_grid_plan_s": plan_s}),
          flush=True)

    rows = {}
    for name in ROWS:
        if name not in names:
            continue
        cfg = capped(optimizer_config(name), iterations)
        row, chi2 = bench_one(name, laid, poses_gt, cfg, n_real, device,
                              reps, rounds, gdev=gdev)
        # the JAX row's names for two of bench_one's keys
        row.update(iters=row["iters_run"], ate=row["ate_rmse"],
                   chi2_curve=chi2.tolist())
        checks = gate(name, row, chi2, device.type == "cuda",
                      scale == 1.0 and iterations is None, iterations)
        row["gate"] = {"checks": checks, "ok": all(checks.values())}
        print(json.dumps(row), flush=True)
        rows[name] = row

    def ratio(a, b):
        return rows[a]["iters_per_s"] / rows[b]["iters_per_s"] \
            if a in rows and b in rows else None

    grid, band = rows.get(ROWS[0]), rows.get(ROWS[1])
    out = {
        "band_layout": layout,
        "chi2_match_rel": abs(grid["chi2_last"] - band["chi2_last"])
        / max(grid["chi2_last"], 1.0) if grid and band else None,
        "speedup_vs_grid_jacobi": ratio(ROWS[1], ROWS[0]),
        "speedup_vs_grid_tridiag": ratio(ROWS[1], ROWS[5]),
        **device_fields(device),
        "configs": list(rows.values()),
    }
    out["ok"] = all(r["gate"]["ok"] for r in rows.values()) and (
        out["chi2_match_rel"] is None
        or out["chi2_match_rel"] <= CHI2_MATCH_MAX)
    print(json.dumps({k: v for k, v in out.items() if k != "configs"}),
          flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="multiply the graph's poses and landmarks")
    ap.add_argument("--rows", default=None,
                    help="comma-separated row names (default: all six)")
    ap.add_argument("--iterations", type=int, default=None,
                    help="cap every row's GN iterations")
    ap.add_argument("--reps", type=int, default=REPS,
                    help=f"optimizes per timed round (default {REPS})")
    ap.add_argument("--rounds", type=int, default=ROUNDS,
                    help=f"timed rounds (default {ROUNDS})")
    ap.add_argument("--out", default=None,
                    help="write the summary and the rows to this JSON file")
    args = ap.parse_args(argv)
    names = ROWS if args.rows is None else tuple(args.rows.split(","))
    unknown = sorted(set(names) - set(ROWS))
    if unknown:
        ap.error(f"unknown rows: {unknown}; rows: {', '.join(ROWS)}")
    device = resolve_device(args.device)
    if device is None:
        return 2
    out = run(device, names, args.scale, args.reps, args.rounds,
              iterations=args.iterations)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"measured_at": time.strftime("%Y-%m-%d %H:%M:%S"),
                       **out}, f, indent=1)
    if not out["ok"]:
        print("gates failed", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
