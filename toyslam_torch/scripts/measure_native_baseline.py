"""The CPU comparator on the card's own host: the native C++ dense
Gauss-Newton engine on the 150-pose headline graph.

    python -m toyslam_torch.scripts.measure_native_baseline
        [--device cuda|cpu] [--rounds N] [--out PATH]

Counterpart of the JAX package's ``scripts/measure_native_baseline.py``
(``main``): the seeded 150-pose simulation and its graph, built by the
port's ``sim.frontend``, optimized by ``io.native.native_optimize``
(``native/src/optimizer.cpp``: dense GN with lambda damping, a double
Cholesky and a thread-pooled assembly; built on demand by
``native/build.sh``) at 1 thread and at all threads: one warm-up, then the
best of ``rounds`` timed calls (the JAX script's 5).

It prints one JSON line per thread setting and then the ``native_cpu``
object, with the host's CPU count and, where the run is on the card's
host (``--device cuda``, the default), the card's name and power limit:
the comparator taken on the same host as the port's headline
(``python -m toyslam_torch.bench``, whose ``vs_native_cpu`` divides by
``BASELINE_MEASURED.json``'s rate, measured on another machine).  Each
setting is held to 10 GN iterations and the main path's ATE (0.7552
within 2e-3); a failed check makes the run exit 1.  The object is written
to ``--out`` only; ``BASELINE_MEASURED.json`` is never touched.
``--device cuda`` exits 2 without a GPU (the measurement is the card's
host's); ``--device cpu`` measures any host.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from toyslam_torch.app import resolve_device
from toyslam_torch.bench import device_fields

ROUNDS = 5
ATE_REF, ATE_TOL = 0.7552, 2e-3
PIPELINE = ("native C++ engine (dense GN, double Cholesky, pooled "
            "assembly), the CPU comparator standing in for the upstream "
            "server's Eigen CPU solver")


def slam_config():
    """The JAX script's ``SlamConfig``, field for field."""
    from toyslam_torch.config import OptimizerConfig, SimConfig, SlamConfig

    return SlamConfig(sim=SimConfig(robot_steps=150, seed=0),
                      optimizer=OptimizerConfig(iterations=10, lr=0.2))


def measure(rounds: int = ROUNDS) -> dict:
    """Both thread settings: ``{label: result}`` (each printed)."""
    from toyslam_torch.io import native
    from toyslam_torch.sim import frontend

    cfg = slam_config()
    sim = frontend.simulate(cfg.sim)
    graph, _ = frontend.build_graph(sim, cfg)
    gt = sim.poses_gt
    results = {}
    for threads in (1, 0):                  # 0 = hardware_concurrency
        label = "1_thread" if threads == 1 else "all_threads"
        native.native_optimize(graph, num_threads=threads)      # warm-up
        best = float("inf")
        for _ in range(rounds):
            t0 = time.perf_counter()
            g_opt, stats = native.native_optimize(graph,
                                                  num_threads=threads)
            best = min(best, time.perf_counter() - t0)
        iters = int(stats.iterations_run)
        ate = frontend.ate_rmse(g_opt.poses[:gt.shape[0]].numpy(), gt)
        results[label] = {
            "wall_s": best,
            "iters_per_s": iters / best,
            "iterations_run": iters,
            "final_ate_rmse": ate,
            "ok": iters == cfg.optimizer.iterations
            and abs(ate - ATE_REF) <= ATE_TOL,
        }
        print(json.dumps({"threads": label, **results[label]}), flush=True)
    return results


def native_cpu(results: dict, device) -> dict:
    """The ``native_cpu`` object of ``BASELINE_MEASURED.json``'s form."""
    best = max(results, key=lambda k: results[k]["iters_per_s"])
    return {
        "pipeline": PIPELINE,
        "host_cpus": os.cpu_count(),
        **results,
        "iters_per_s": results[best]["iters_per_s"],
        "measured_at": time.strftime("%Y-%m-%d %H:%M:%S"),
        **device_fields(device),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--rounds", type=int, default=ROUNDS,
                    help=f"timed calls per thread setting (default {ROUNDS})")
    ap.add_argument("--out", default=None,
                    help="write the native_cpu object to this JSON file")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device is None:
        return 2
    results = measure(args.rounds)
    out = native_cpu(results, device)
    print(json.dumps({"native_cpu": out}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"native_cpu": out}, f, indent=2)
    if not all(r["ok"] for r in results.values()):
        print("native baseline checks failed", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
