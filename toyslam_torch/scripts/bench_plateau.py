"""Scale results at a stated quality: the 10k and 100k workloads run to a
chi^2 plateau.

    python -m toyslam_torch.scripts.bench_plateau [10k|100k|incr]
        [--device cuda|cpu] [--scale S] [--iterations N] [--out PATH]

Counterpart of the JAX package's ``scripts/bench_plateau.py``
(``run_to_plateau``, ``run_10k``, ``run_100k``, ``run_100k_incr``,
``main``): the same five rows, with its graphs and its ``OptimizerConfig``
fields.  Each row records the convergence curve, the iterations to the
plateau (the first GN iteration whose chi^2 is within 0.1 % of the final
one), the wall time to it (``wall_to_plateau_s``: the users' time to a
stated quality), chi^2 at the ground-truth state (the quality floor of the
drift-limited single-lap graphs) and the ATE against dead reckoning.

* ``plateau-10k`` and ``plateau-10k-revisit``: ``make_large_problem`` at
  10k poses (one lap, or two over 5k landmarks), 60 ``schur_grid``
  iterations under ``pcg_backend="auto"``, which on the card takes the
  streamed band kernel (B2);
* ``plateau-100k-revisit``: 100k poses over two laps, default noise,
  40 iterations from dead reckoning, which lies outside the Gauss-Newton
  basin at this scale (an initialisation limit, not a solver one);
* ``plateau-100k-revisit-incr-init``: the same graph put inside the basin
  by ``incremental_init(window=4096, iters_per_prefix=5)``, then 80
  iterations in one optimize (the JAX script chains two optimizes of 40
  only because long programs crashed its remote TPU worker);
* ``plateau-100k-revisit-lownoise``: the low-noise graph, which dead
  reckoning leaves inside the basin.

The configs restart PCG every 30 iterations and take the default chunk of
16, so a kernel solve restarts its direction at every chunk, as the JAX
package's does (``_chunked_pcg``).

Per row: the graph is built once per entry point and laid out once,
moved to the device, optimized once (kernel launches counted, the first
call's seconds kept) and once more, timed (``toyslam_torch.bench``).  Each
row prints one JSON line with the JAX row's keys (``platform`` with the
card's name and power limit), ``solver_mode`` ("band": B2; None: the plain
grid loop), the launches per optimize and ``gate``; a failed gate makes
the run exit 1 after the last row.  ``--scale`` multiplies every graph's
poses and landmarks and ``--iterations`` caps each row's GN iterations
(development on the CPU; the references hold at full size only).  Nothing
is written unless ``--out`` is given.  ``--device cuda`` (the default) exits 2 without a
GPU; ``--device cpu`` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
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
    reset_launches,
    timed_rounds,
)
from toyslam_torch.scripts.bench_suite import capped, solver_mode

# the JAX script's configs (scripts/bench_plateau.py:143-149, 189-195)
OPT_10K = dict(
    iterations=60, lr=1.0, solver="schur_grid", exact_odom_jacobians=True,
    pcg_tol=1e-3, pcg_max_iters=60, pcg_restart_every=30,
    pcg_precond="tridiag+coarse", pcg_coarse_group=32,
    pcg_precond_refresh=5, convergence_eps=1e-4,
)
OPT_100K = dict(OPT_10K, iterations=40, pcg_coarse_group=64)
# the initialisation's solver (:247-250)
INIT_OPT = dict(pcg_max_iters=30, pcg_restart_every=30, pcg_precond_refresh=0)
INCR_ITERATIONS = 80
# make_large_problem's arguments per row
GRAPH = {
    "plateau-10k": dict(num_poses=10_000, num_landmarks=10_000,
                        obs_per_pose=6, seed=0),
    "plateau-10k-revisit": dict(num_poses=10_000, num_landmarks=5_000,
                                obs_per_pose=6, seed=0, laps=2),
    "plateau-100k-revisit": dict(num_poses=100_000, num_landmarks=50_000,
                                 obs_per_pose=6, seed=0, laps=2,
                                 pose_bucket=1024, landmark_bucket=1024,
                                 edge_bucket=8192),
}
GRAPH["plateau-100k-revisit-incr-init"] = GRAPH["plateau-100k-revisit"]
GRAPH["plateau-100k-revisit-lownoise"] = GRAPH["plateau-100k-revisit"]
LOW_NOISE = dict(position_std=0.05, orientation_std=math.radians(0.2))
ROWS = tuple(GRAPH)

# Gates.  chi^2 at the ground truth is the same f32 sum of the same
# residuals in every package (rtol 1e-4 of the JAX package's recorded
# value); the final chi^2 within 1 % of the JAX package's record
# (BENCH_PLATEAU.json, a run through its band kernel with the same chunk
# and restart cadence as B2's); the dead-reckoning ATE within 1e-4 (the
# same graph).  The 10k ATE at the plateau: the single lap's within 5 % of
# the record (10.4909; the JAX package's f32 plain-loop run of the config
# on the CPU ends at 10.8227); the revisit row's lies in a flat valley,
# where the JAX package's own two runs end at 2.1611 (record) and 4.0791
# (CPU plain loop), so it is held below the larger plus 5 %.
REF = {
    "plateau-10k": dict(chi2_final=6650.1, chi2_gt=7937.2,
                        ate_dr=53.99301528930664, ate=10.4909),
    "plateau-10k-revisit": dict(chi2_final=6859.3, chi2_gt=7911.2,
                                ate_dr=40.60987854003906,
                                ate_below=1.05 * 4.0791),
    # init-limited: a local minimum, reached through damped steps that
    # raise chi^2 on the way (12 times in the record's 40 iterations), so
    # held to the fall the record shows (5.3e9 to 5.3e6)
    "plateau-100k-revisit": dict(chi2_gt=78324.2, fall_below=1e-2),
    # one optimize where the record chains two: held to 1.5 times the
    # record's final chi^2, as chip_smoke.py's incr100k phase holds it
    "plateau-100k-revisit-incr-init": dict(
        chi2_gt=78324.2, chi2_after_init_below=1e-2, chi2_final_jax=233443.7),
    "plateau-100k-revisit-lownoise": dict(chi2_final=23300.9,
                                          chi2_gt=27500.4),
}


def optimizer_config(name: str):
    """The row's ``OptimizerConfig``, field for field the JAX script's (the
    incr-init row's 80 iterations in one optimize)."""
    from toyslam_torch.config import OptimizerConfig

    if name.startswith("plateau-10k"):
        return OptimizerConfig(**OPT_10K)
    if name == "plateau-100k-revisit-incr-init":
        return OptimizerConfig(**dict(OPT_100K, iterations=INCR_ITERATIONS))
    return OptimizerConfig(**OPT_100K)


def graph_args(name: str, scale: float = 1.0) -> dict:
    """``make_large_problem``'s arguments for the row, poses and landmarks
    multiplied by ``scale``."""
    from toyslam_torch.config import NoiseConfig

    kw = dict(GRAPH[name])
    kw["num_poses"] = max(64, int(kw["num_poses"] * scale))
    kw["num_landmarks"] = max(64, int(kw["num_landmarks"] * scale))
    if name.endswith("-lownoise"):
        kw["noise"] = NoiseConfig(**LOW_NOISE)
    return kw


def incr_init():
    """The incr-init row's initialisation (the JAX script's ``_init``)."""
    from toyslam_torch.config import OptimizerConfig
    from toyslam_torch.optimizer.coarse_init import incremental_init

    init_cfg = OptimizerConfig(**dict(OPT_100K, **INIT_OPT))
    return lambda g: incremental_init(g, window=4096, iters_per_prefix=5,
                                      solver_cfg=init_cfg)


def run_to_plateau(name, make_graph, opt, n_real, device,
                   plateau_rtol=1e-3, init=None) -> dict:
    """The JAX script's ``run_to_plateau`` in one optimize per run (no
    chaining): its JSON object, with ``solver_mode`` and the launches per
    optimize."""
    from toyslam_torch.ops import assemble
    from toyslam_torch.optimizer import GaussNewton
    from toyslam_torch.sim import frontend

    def chi2(g) -> float:
        return float(assemble.total_error(
            g, huber_delta=opt.huber_delta,
            exact_odom_jacobians=opt.exact_odom_jacobians))

    graph, poses_gt, lms_gt = make_graph()
    ate_dr = frontend.ate_rmse(graph.poses[:n_real].numpy(), poses_gt)
    gn = GaussNewton(opt)
    gdev = graph.to(device)
    extra = {}
    if init is not None:
        chi2_dr = chi2(gdev)
        reset_launches()
        t0 = time.perf_counter()
        gdev = init(gdev)
        est0 = gdev.poses[:n_real].cpu().numpy()     # fence
        extra = {"init_wall_s": time.perf_counter() - t0,
                 "ate_after_init": frontend.ate_rmse(est0, poses_gt),
                 "init_kernel_launches": launches(),
                 "chi2_dead_reckoning": chi2_dr,
                 "chi2_after_init": chi2(gdev)}
    gdev = gn._prepare(gdev)
    mode = solver_mode(opt, gdev)

    out = {}

    def optimize():
        out["r"] = gn.optimize(gdev)

    reset_launches()
    (wall0,) = timed_rounds(optimize, device, 1, 1)
    counts = launches()
    (wall,) = timed_rounds(optimize, device, 1, 1)
    r = out["r"]
    iters = r.iterations_run
    est = r.graph.poses[:n_real].cpu().numpy()
    errs = r.errors.cpu().numpy()
    valid = errs[~np.isnan(errs)]
    final = float(valid[-1])
    reach = int(np.argmax(valid <= final * (1.0 + plateau_rtol))) + 1

    # chi^2 at the ground truth: real entries overwrite the padded state,
    # the padding stays masked
    pp = gdev.poses.clone()
    pp[:n_real] = torch.as_tensor(poses_gt, dtype=pp.dtype)
    ll = gdev.landmarks.clone()
    ll[:len(lms_gt)] = torch.as_tensor(lms_gt, dtype=ll.dtype)
    chi2_gt = chi2(gdev.with_state(pp, ll))

    row = {
        "config": name,
        "poses": n_real,
        "landmarks": int(graph.lm_mask.sum()),
        "lm_edges": int(graph.lm_edges.mask.sum()),
        "iterations_run": iters,
        "iters_per_s": iters / wall,
        "wall_s": wall,
        "wall_first_incl_compile_s": wall0,
        "converged": bool(r.converged),
        "iters_to_plateau": reach,
        "wall_to_plateau_s": reach * wall / iters,
        "chi2_curve": valid.tolist(),
        "chi2_final": final,
        "chi2_at_ground_truth": chi2_gt,
        "ate_rmse": frontend.ate_rmse(est, poses_gt),
        "ate_dead_reckoning": ate_dr,
        "pcg_iters": r.pcg_iters[:iters].tolist(),
        **device_fields(device),
        **extra,
        "solver_mode": mode,
        "kernel_launches": counts,
        "finite": bool(np.isfinite(est).all() and np.isfinite(valid).all()),
    }
    return row


def gate(name: str, row: dict, on_card: bool, full_size: bool) -> dict:
    """The row's checks, each True or False.  The references hold at full
    size; a scaled run keeps the checks that hold at any size."""
    incr = name.endswith("-incr-init")
    chi2 = np.asarray(row["chi2_curve"])
    ok = {"finite": row["finite"],
          "iterations": row["iterations_run"] <= optimizer_config(
              name).iterations}
    if not incr:
        ok["chi2 below the start"] = bool(chi2[-1] < chi2[0])
    if full_size:
        ref = REF[name]
        ok["chi2_at_ground_truth"] = math.isclose(
            row["chi2_at_ground_truth"], ref["chi2_gt"], rel_tol=1e-4)
        if "ate_dr" in ref:
            ok["ate_dr"] = abs(row["ate_dead_reckoning"]
                               - ref["ate_dr"]) <= 1e-4
        if "chi2_final" in ref:
            ok["chi2_final"] = math.isclose(row["chi2_final"],
                                            ref["chi2_final"], rel_tol=1e-2)
        if "ate" in ref:
            ok["ate"] = math.isclose(row["ate_rmse"], ref["ate"],
                                     rel_tol=5e-2)
        if "ate_below" in ref:
            ok["ate"] = row["ate_rmse"] < ref["ate_below"]
        if "fall_below" in ref:
            ok["chi2 falls 100x"] = bool(chi2[-1]
                                         < ref["fall_below"] * chi2[0])
        if incr:
            ok["init inside the basin"] = (
                row["chi2_after_init"]
                < ref["chi2_after_init_below"] * row["chi2_dead_reckoning"])
            ok["final chi2 within 1.5x of the JAX package's"] = (
                row["chi2_final"] < 1.5 * ref["chi2_final_jax"])
        else:
            ok["ate below dead reckoning"] = (row["ate_rmse"]
                                              < row["ate_dead_reckoning"])
    want = ("band_fused_pcg_chunk" if on_card and row["solver_mode"] == "band"
            else None)
    ok["launches"] = all((n > 0) == (k == want)
                         for k, n in row["kernel_launches"].items())
    return ok


def run_rows(names, device, scale: float = 1.0,
             iterations: int | None = None) -> list:
    """The named rows in the JAX script's order, each graph built once;
    their JSON objects (printed)."""
    from toyslam_torch.sim import synthetic

    built = {}

    def make(name):
        key = repr(graph_args(name, scale))
        if key not in built:
            built.clear()           # one large graph on the host at a time
            built[key] = synthetic.make_large_problem(
                **graph_args(name, scale))
        return built[key]

    out = []
    for name in ROWS:
        if name not in names:
            continue
        cfg = capped(optimizer_config(name), iterations)
        n_real = graph_args(name, scale)["num_poses"]
        init = incr_init() if name.endswith("-incr-init") else None
        row = run_to_plateau(name, lambda n=name: make(n), cfg, n_real,
                             device, init=init)
        checks = gate(name, row, device.type == "cuda",
                      scale == 1.0 and iterations is None)
        row["gate"] = {"checks": checks, "ok": all(checks.values())}
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


SUBSETS = {
    "10k": ("plateau-10k", "plateau-10k-revisit"),
    "100k": ("plateau-100k-revisit", "plateau-100k-revisit-incr-init",
             "plateau-100k-revisit-lownoise"),
    "incr": ("plateau-100k-revisit-incr-init",),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("only", nargs="?", choices=tuple(SUBSETS),
                    help="run one group of rows (default: all five)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="multiply every graph's poses and landmarks")
    ap.add_argument("--iterations", type=int, default=None,
                    help="cap every row's GN iterations")
    ap.add_argument("--out", default=None,
                    help="write the rows to this JSON file")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device is None:
        return 2
    names = SUBSETS[args.only] if args.only else ROWS
    rows = run_rows(names, device, args.scale, args.iterations)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"measured_at": time.strftime("%Y-%m-%d %H:%M:%S"),
                       **device_fields(device),
                       "note": "runs to a chi^2 plateau (iters_to_plateau = "
                               "first iteration within 0.1% of final), one "
                               "optimize per run; rounds fenced with "
                               "torch.cuda.synchronize()",
                       "configs": rows}, f, indent=2)
    failed = [r["config"] for r in rows if not r["gate"]["ok"]]
    if failed:
        print(f"gates failed: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
