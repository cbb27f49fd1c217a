"""Command-line application of the PyTorch port.

``python -m toyslam_torch run [--steps 150 --iterations 10 --lr 0.2
--seed 0 --device cuda]`` simulates the scripted trajectory, builds the
factor graph, optimizes it with the Schur/fused-PCG Gauss-Newton on the
given device (the GPU by default; ``--device cpu`` runs the kernels' plain
PyTorch versions) and prints one JSON metrics line to stdout (the same keys as
``toyslam_tpu``'s ``run``, plus the device and the kernel launch count).

``python -m toyslam_torch ba3d [--poses 64 --landmarks 256 --obs 24
--iterations 25 --huber 1e9 --seed 0 --device cuda]`` does the same for the
synthetic SE(3) bundle-adjustment problem (``toyslam_tpu``'s ``ba3d``: the
same config and keys, plus the device and the kernel launch count).
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
    kernels = (fused_pcg.fused_pcg_chunk, fused_pcg.band_fused_pcg_chunk)
    launches0 = sum(k.launches for k in kernels)
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
    # both kernels: graphs of 2048 poses and more may take the band kernel
    metrics["kernel_launches"] = sum(k.launches for k in kernels) - launches0
    print(json.dumps(metrics))
    return 0


def cmd_ba3d(args) -> int:
    import numpy as np
    import torch

    from toyslam_torch.config import OptimizerConfig
    from toyslam_torch.ops import fused_pcg
    from toyslam_torch.optimizer import GaussNewton
    from toyslam_torch.sim import synthetic3d

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"--device {args.device}: no CUDA device", file=sys.stderr)
        return 2
    graph, poses_gt, _ = synthetic3d.make_ba_problem(
        num_poses=args.poses, num_landmarks=args.landmarks,
        obs_per_pose=args.obs, seed=args.seed,
    )
    n = poses_gt.shape[0]
    cfg = OptimizerConfig(
        iterations=args.iterations, lr=1.0, solver="schur3d",
        exact_odom_jacobians=True, huber_delta=args.huber,
        pcg_tol=1e-8, pcg_max_iters=400, convergence_eps=1e-8,
        reject_worse_steps=True,
    )
    kernels = (fused_pcg.fused_pcg_chunk, fused_pcg.band_fused_pcg_chunk)
    launches0 = sum(k.launches for k in kernels)
    t0 = time.perf_counter()
    res = GaussNewton(cfg).optimize(graph.to(device))
    est = res.graph.poses.cpu().numpy()   # fence: waits for the device
    dt = time.perf_counter() - t0
    errors = res.errors.cpu().numpy()
    valid = errors[~np.isnan(errors)]
    print(json.dumps({
        "cmd": "ba3d",
        "device": str(device),
        "poses": n,
        "landmarks": int(graph.lm_mask.sum().item()),
        "reproj_edges": int(graph.lm_edges.mask.sum().item()),
        "iterations_run": res.iterations_run,
        "chi2_first": round(float(valid[0]), 2),
        "chi2_final": round(float(valid[-1]), 2),
        "ate_initial": round(synthetic3d.pose_ate_rmse(
            graph.poses[:n].numpy(), poses_gt), 4),
        "ate_final": round(synthetic3d.pose_ate_rmse(est[:n], poses_gt), 4),
        "optimize_s": round(dt, 4),
        # the resident kernel at the defaults; from 192 poses the gate may
        # take the band kernel
        "kernel_launches": sum(k.launches for k in kernels) - launches0,
    }))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="toyslam_torch",
        description="2D LiDAR SLAM and SE(3) bundle adjustment in "
                    "PyTorch with hand-written CUDA PCG kernels (see "
                    "README.md)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run", help="2D LiDAR SLAM pipeline")
    r.add_argument("--steps", type=int, default=150, help="robot steps")
    r.add_argument("--iterations", type=int, default=10)
    r.add_argument("--lr", type=float, default=0.2)
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--device", default="cuda",
                   help="torch device to optimize on: cuda (the default, "
                        "through the CUDA kernels) or cpu (their plain "
                        "PyTorch versions)")
    r.set_defaults(fn=cmd_run)
    b = sub.add_parser("ba3d", help="SE(3) bundle adjustment (synthetic)")
    b.add_argument("--poses", type=int, default=64)
    b.add_argument("--landmarks", type=int, default=256)
    b.add_argument("--obs", type=int, default=24)
    b.add_argument("--iterations", type=int, default=25)
    b.add_argument("--huber", type=float, default=1e9)
    b.add_argument("--seed", type=int, default=0)
    b.add_argument("--device", default="cuda",
                   help="torch device to optimize on: cuda (the default) or "
                        "cpu")
    b.set_defaults(fn=cmd_ba3d)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
