"""Command-line application of the PyTorch port.

``python -m toyslam_torch run [--steps 150 --iterations 10 --lr 0.2
--seed 0 --device cuda]`` simulates the scripted trajectory, builds the
factor graph, optimizes it with the Schur/fused-PCG Gauss-Newton on the
given device and prints one JSON metrics line to stdout (the same keys as
``toyslam_tpu``'s ``run``, plus the device and the kernel launch count).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def cmd_run(args) -> int:
    import numpy as np
    import torch

    from toyslam_torch.config import OptimizerConfig, SimConfig, SlamConfig
    from toyslam_torch.ops import fused_pcg
    from toyslam_torch.optimizer import GaussNewton
    from toyslam_torch.sim import frontend

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"--device {args.device}: no CUDA device", file=sys.stderr)
        return 2
    cfg = SlamConfig(
        sim=SimConfig(robot_steps=args.steps, seed=args.seed),
        optimizer=OptimizerConfig(
            iterations=args.iterations, lr=args.lr, solver="schur",
        ),
    )
    t0 = time.perf_counter()
    sim = frontend.simulate(cfg.sim)
    t_sim = time.perf_counter() - t0
    graph, _ = frontend.build_graph(sim, cfg)
    graph = graph.to(device)
    t_build = time.perf_counter() - t0 - t_sim

    gn = GaussNewton(cfg.optimizer)
    launches0 = fused_pcg.fused_pcg_chunk.launches
    t1 = time.perf_counter()
    res = gn.optimize(graph)
    est = res.graph.poses.cpu().numpy()   # fence: waits for the device
    t_opt = time.perf_counter() - t1

    iters = res.iterations_run
    errors = res.errors.cpu().numpy()
    n = sim.poses_gt.shape[0]
    metrics = {
        "cmd": "run",
        "backend": "local",
        "device": str(device),
        "poses": n,
        "landmarks": int(graph.lm_mask.sum().item()),
        "ate_rmse": round(frontend.ate_rmse(est[:n], sim.poses_gt), 4),
        "ate_dead_reckoning": round(
            frontend.ate_rmse(sim.poses_dr, sim.poses_gt), 4
        ),
        "sim_s": round(t_sim, 4),
        "build_s": round(t_build, 4),
        "optimize_s": round(t_opt, 4),
        "iterations_run": iters,
    }
    valid = errors[~np.isnan(errors)]
    if valid.size:
        metrics["chi2_first"] = round(float(valid[0]), 2)
        metrics["chi2_final"] = round(float(valid[-1]), 2)
    metrics["pcg_iters"] = res.pcg_iters[:iters].tolist()
    metrics["lambdas"] = res.lambdas[:iters].cpu().numpy().round(6).tolist()
    metrics["kernel_launches"] = (
        fused_pcg.fused_pcg_chunk.launches - launches0
    )
    print(json.dumps(metrics))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="toyslam_torch",
        description="2D LiDAR SLAM in PyTorch with a hand-written CUDA "
                    "PCG kernel (see README.md)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run", help="2D LiDAR SLAM pipeline")
    r.add_argument("--steps", type=int, default=150, help="robot steps")
    r.add_argument("--iterations", type=int, default=10)
    r.add_argument("--lr", type=float, default=0.2)
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--device", default="cpu",
                   help="torch device to optimize on, e.g. cpu or cuda")
    r.set_defaults(fn=cmd_run)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
