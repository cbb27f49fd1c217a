"""Headline benchmark of the port: GN iterations/s on the main path.

    python -m toyslam_torch.bench [--device cuda|cpu] [--reps N] [--rounds N]

Counterpart of the JAX package's ``bench.py`` (its ``worker``): the seeded
150-pose 2D LiDAR simulation and its graph, optimized by damped
Gauss-Newton (``solver="schur"``, ``pcg_precond="tridiag"``, 10 iterations
at lr 0.2, ``pcg_backend="auto"``), which on the card solves through the
resident fused-PCG kernel (B1, ``csrc/fused_pcg_chunk.cu``).

Method: the graph is laid out and moved to the device once; one warm-up
optimize (its launches are counted, its trajectory gives the ATE); then
``rounds`` rounds of ``reps`` optimizes, each round fenced with
``torch.cuda.synchronize()``.  The headline is GN iterations over the
median round's seconds per optimize, with the best round, the IQR and
every round, one single-call latency, the ATE and the dead-reckoning ATE.
It prints one JSON line.  ``vs_baseline`` and ``vs_native_cpu`` divide by
``BASELINE_MEASURED.json``'s reference-Python and native-C++ rates: CPU
comparators, quoted, not measured again.

``--device cuda`` (the default) exits 2 without a GPU; ``--device cpu``
runs the kernels' plain versions.  The timing, the rate summary, the
launch counters and the card's name and power limit here are shared with
``toyslam_torch.scripts.bench_suite``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from toyslam_torch.app import resolve_device

BASELINE = Path(__file__).resolve().parent.parent / "BASELINE_MEASURED.json"
METRIC = ("BA iterations/s (sim 2D LiDAR, 150 poses, damped GN, Schur/PCG; "
          "the resident fused-PCG CUDA kernel on the GPU)")


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def device_fields(device: torch.device) -> dict:
    """The platform, the device's name and, on the card, nvidia-smi's name
    and power limit."""
    if device.type == "cuda":
        return {"platform": "gpu",
                "device": torch.cuda.get_device_name(device),
                "card": card()}
    return {"platform": "cpu", "device": "cpu", "card": None}


def reset_launches() -> None:
    """Set both solver kernels' launch counts to 0."""
    from toyslam_torch.ops import fused_pcg as fp

    fp.fused_pcg_chunk.launches = 0
    fp.band_fused_pcg_chunk.launches = 0


def launches() -> dict:
    """Launches of B1 and B2 since :func:`reset_launches`."""
    from toyslam_torch.ops import fused_pcg as fp

    return {"fused_pcg_chunk": fp.fused_pcg_chunk.launches,
            "band_fused_pcg_chunk": fp.band_fused_pcg_chunk.launches}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_rounds(fn, device: torch.device, rounds: int, reps: int):
    """Seconds per call of ``rounds`` rounds of ``reps`` calls of ``fn``,
    each round fenced with a synchronize."""
    times = []
    for _ in range(rounds):
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        _sync(device)
        times.append((time.perf_counter() - t0) / reps)
    return times


def rate(iters: int, times: list[float]) -> dict:
    """GN iterations/s over the median round (the headline), the best
    round and the IQR (``[q1, q3]`` of the rate), with the seconds per
    call."""
    med = statistics.median(times)
    q = statistics.quantiles(times, n=4) if len(times) >= 2 else None
    return {"iters_per_s": iters / med,
            "iters_per_s_best": iters / min(times),
            "iters_per_s_iqr": [iters / q[2], iters / q[0]] if q else None,
            "headline_stat": "median of rounds",
            "wall_s": med, "wall_s_rounds": times}


def main_config():
    """The headline workload: ``bench.py``'s config."""
    from toyslam_torch.config import OptimizerConfig, SimConfig, SlamConfig

    return SlamConfig(
        sim=SimConfig(robot_steps=150, seed=0),
        optimizer=OptimizerConfig(iterations=10, lr=0.2, solver="schur",
                                  pcg_precond="tridiag"),
    )


def run(device: torch.device, reps: int, rounds: int) -> dict:
    """The measurement; its JSON object."""
    from toyslam_torch.optimizer import GaussNewton
    from toyslam_torch.sim import frontend

    cfg = main_config()
    sim = frontend.simulate(cfg.sim)
    graph, _ = frontend.build_graph(sim, cfg)
    n = sim.poses_gt.shape[0]
    gn = GaussNewton(cfg.optimizer)
    gdev = gn._prepare(graph).to(device)

    reset_launches()
    res = gn.optimize(gdev)
    est = res.graph.poses[:n].cpu().numpy()   # fence
    per_opt = launches()
    iters = res.iterations_run

    times = timed_rounds(lambda: gn.optimize(gdev), device, rounds, reps)
    r = rate(iters, times)
    _sync(device)
    t0 = time.perf_counter()
    gn.optimize(gdev).graph.poses.cpu()
    latency = time.perf_counter() - t0

    baseline = json.loads(BASELINE.read_text()) if BASELINE.exists() else {}
    ref_rate = baseline.get("iters_per_s")
    native_rate = baseline.get("native_cpu", {}).get("iters_per_s")
    return {
        "metric": METRIC,
        "value": r["iters_per_s"],
        "unit": "iter/s",
        "headline_stat": r["headline_stat"],
        "iters_per_s_best": r["iters_per_s_best"],
        "iters_per_s_iqr": r["iters_per_s_iqr"],
        "vs_baseline": r["iters_per_s"] / ref_rate if ref_rate else None,
        "vs_native_cpu": r["iters_per_s"] / native_rate if native_rate
        else None,
        "ate_rmse": frontend.ate_rmse(est, sim.poses_gt),
        "baseline_ate_rmse": baseline.get("final_ate_rmse"),
        "dead_reckoning_ate_rmse": frontend.ate_rmse(sim.poses_dr,
                                                     sim.poses_gt),
        "iterations": iters,
        "wall_s_per_opt_best": min(times),
        "wall_s_per_opt_median": r["wall_s"],
        "wall_s_per_opt_rounds": times,
        "latency_s_single_call": latency,
        "kernel_launches": per_opt,
        **device_fields(device),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--reps", type=int, default=20,
                    help="optimizes per timed round (default 20)")
    ap.add_argument("--rounds", type=int, default=5,
                    help="timed rounds (default 5)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device is None:
        return 2
    print(json.dumps(run(device, args.reps, args.rounds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
