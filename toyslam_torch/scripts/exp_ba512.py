"""SE(3) bundle adjustment at 512 cameras x 4096 points: the streamed band
kernel (B2 at dp=6) against the plain PCG loop.

    python -m toyslam_torch.scripts.exp_ba512 [--device cuda|cpu]
        [--scale S] [--iterations N] [--rows r1,r2] [--reps N]
        [--rounds N] [--out PATH]

Counterpart of the JAX package's ``scripts/exp_ba512.py`` (``bench``,
``main``): ``make_ba_problem(512, 4096, 24, seed=0)``, whose dense V
slabs are too large for the resident kernel, so the gate
(``fused_pcg.fused_mode``) takes the band layout (one full-height window,
landmark-chunked columns); the JAX script asserts it, and so does this one
at that size.  Four rows, in its order, with its ``OptimizerConfig``
fields: ``ba3d-512x4096-{fused,xla}`` (the convergence policy: tol 1e-6,
cap 200) and their ``-matched64`` twins (tol 0, 64 PCG iterations on both
sides).

The graph is built and laid out once and moved to the device once.  Per
row (``toyslam_torch.scripts.bench_suite.bench_one``): one warm-up
optimize whose launches are counted, then ``rounds`` rounds of ``reps``
optimizes (the JAX script's 3 x 3).  The summary line has ``band_layout``,
``speedup_matched`` and ``speedup_policy`` (fused over xla).  Each row is
held to ``BA_REF``'s rule of ``chip_smoke.py`` (the JAX package's f32
plain-PCG runs of these configs on the CPU): chi^2 at GN iteration 0 at
rtol 1e-4, never rising, the final chi^2 within 2 %, the initial ATE;
and on the card the
fused rows launch B2 only, the xla rows nothing.  A failed gate makes the
run exit 1.  ``--scale`` multiplies the cameras and points and
``--iterations`` caps each row's GN iterations (development on the CPU;
smaller graphs take the resident route, and the references hold at full
size only).  Nothing is written unless ``--out`` is given.
``--device cuda`` (the default) exits 2 without a GPU; ``--device cpu``
runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np

from toyslam_torch.app import resolve_device
from toyslam_torch.bench import device_fields
from toyslam_torch.scripts.bench_suite import bench_one, capped

# the JAX script's graph (scripts/exp_ba512.py:179-181) and configs
# (:186-215)
GRAPH = dict(num_poses=512, num_landmarks=4096, obs_per_pose=24, seed=0)
PROBE = dict(solver="schur3d", exact_odom_jacobians=True,
             pcg_precond="tridiag", pcg_backend="auto", pcg_fused_chunk=16)
POLICY = dict(
    iterations=20, lr=1.0, solver="schur3d", exact_odom_jacobians=True,
    huber_delta=4.0, pcg_tol=1e-6, pcg_max_iters=200, convergence_eps=1e-8,
    reject_worse_steps=True, pcg_precond="tridiag", pcg_fused_chunk=16,
)
MATCHED = dict(POLICY, pcg_tol=0.0, pcg_max_iters=64, pcg_restart_every=64)
ROWS = ("ba3d-512x4096-fused", "ba3d-512x4096-xla",
        "ba3d-512x4096-fused-matched64", "ba3d-512x4096-xla-matched64")
REPS, ROUNDS = 3, 3
# The JAX package's f32 plain-PCG runs of both configs on the CPU
# (chip_smoke.BA_REF["ba512_policy"] / ["ba512_matched"]): chi^2 at GN
# iteration 0 and at the end.  BA in f32 is chaotic here (the port's own
# CPU runs end within 1.3 % of each other and at ATE 0.40-3.10), so the
# final chi^2 is held within 2 % and the ATE is reported, not held.
REF = {"policy": (20788476.0, 13488.2568359375),
       "matched64": (20788476.0, 13470.5)}
FINAL_RTOL = 2e-2
ATE_INITIAL = 3.9674267768859863


def optimizer_config(name: str):
    """The row's ``OptimizerConfig``, field for field the JAX script's."""
    from toyslam_torch.config import OptimizerConfig

    kw = MATCHED if name.endswith("-matched64") else POLICY
    backend = "fused" if "-fused" in name else "xla"
    return OptimizerConfig(**dict(kw, pcg_backend=backend))


def graph_args(scale: float = 1.0) -> dict:
    return dict(GRAPH, num_poses=int(GRAPH["num_poses"] * scale),
                num_landmarks=int(GRAPH["num_landmarks"] * scale))


def gate(name: str, row: dict, chi2: np.ndarray, on_card: bool,
         full_size: bool) -> dict:
    """The row's checks, each True or False."""
    ok = {"finite": row["finite"],
          "chi2 non-increasing": bool(np.all(np.diff(chi2) <= 0.0)),
          "chi2 below the start": bool(chi2[-1] < chi2[0])}
    if full_size:
        first, final = REF["matched64" if name.endswith("-matched64")
                           else "policy"]
        ok["chi2_first"] = math.isclose(chi2[0], first, rel_tol=1e-4)
        ok["chi2_final"] = math.isclose(chi2[-1], final, rel_tol=FINAL_RTOL)
        ok["ate_initial"] = abs(row["ate_initial"] - ATE_INITIAL) <= 1e-4
    fused = "-fused" in name
    want = (("band_fused_pcg_chunk" if row["solver_mode"] == "band"
             else "fused_pcg_chunk") if on_card and fused else None)
    ok["launches"] = all((n > 0) == (k == want)
                         for k, n in row["kernel_launches"].items())
    if full_size:
        ok["route"] = row["solver_mode"] == ("band" if fused else None)
    return ok


def run(device, reps: int = REPS, rounds: int = ROUNDS,
        scale: float = 1.0, names=ROWS,
        iterations: int | None = None) -> dict:
    """The named rows; the summary object.  Raises ``AssertionError`` where
    the JAX script asserts: at its size the graph must carry a dp=6 band
    layout that the gate takes."""
    from toyslam_torch.config import OptimizerConfig
    from toyslam_torch.ops import fused_pcg
    from toyslam_torch.ops.gather_plan import attach_plan
    from toyslam_torch.sim import synthetic3d

    graph, poses_gt, _ = synthetic3d.make_ba_problem(**graph_args(scale))
    n = poses_gt.shape[0]
    laid = attach_plan(graph)
    b = laid.plan.band
    mode = fused_pcg.fused_mode(OptimizerConfig(**PROBE), laid, None)
    layout = None if b is None else {
        "chunk_b": b.chunk_b, "k_windows": b.k_windows, "w_row": b.w_row,
        "n_chunks": b.n_chunks, "tile_mb": b.tile_bytes / 1e6,
        "dp": b.dp, "dl": b.dl}
    print(json.dumps({"band_layout": layout, "mode": mode}), flush=True)
    if scale == 1.0 and (b is None or (b.dp, b.dl) != (6, 3)
                         or mode != "band"):
        raise AssertionError(f"512 x 4096: no dp=6 band route ({mode})")
    gdev = laid.to(device)

    rows = {}
    for name in ROWS:
        if name not in names:
            continue
        cfg = capped(optimizer_config(name), iterations)
        row, chi2 = bench_one(name, laid, poses_gt, cfg, n, device, reps,
                              rounds, gdev=gdev)
        row["chi2_curve"] = chi2.tolist()
        checks = gate(name, row, chi2, device.type == "cuda",
                      scale == 1.0 and iterations is None)
        row["gate"] = {"checks": checks, "ok": all(checks.values())}
        print(json.dumps(row), flush=True)
        rows[name] = row

    def speedup(fused, xla):
        return rows[fused]["iters_per_s"] / rows[xla]["iters_per_s"] \
            if fused in rows and xla in rows else None

    out = {"band_layout": layout,
           "speedup_matched": speedup(ROWS[2], ROWS[3]),
           "speedup_policy": speedup(ROWS[0], ROWS[1]),
           **device_fields(device),
           "ok": all(r["gate"]["ok"] for r in rows.values())}
    print(json.dumps(out), flush=True)
    out["configs"] = list(rows.values())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="multiply the cameras and points")
    ap.add_argument("--rows", default=None,
                    help="comma-separated row names (default: all four)")
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
    out = run(device, args.reps, args.rounds, args.scale, names,
              args.iterations)
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
