"""Command-line application of the PyTorch port.

``python -m toyslam_torch run [--steps 150 --iterations 10 --lr 0.2
--solver schur --seed 0 --device cuda]`` simulates the scripted
trajectory, builds the factor graph, optimizes it with Gauss-Newton on the
given device (the GPU by default; ``--device cpu`` runs the kernels' plain
PyTorch versions) and prints one JSON metrics line to stdout (the same keys as
``toyslam_tpu``'s ``run``, plus the device and the kernel launch count).
``--solver schur`` (the default) is the Schur/fused-PCG solve, ``--solver
dense`` the dense assembly with a Cholesky solve.  Further flags of ``run``:
``--remote HOST:PORT`` optimizes on a graph server and falls back to the
local optimizer when it cannot connect (``backend`` says which ran);
``--snapshot PATH`` saves the optimized graph; ``--live [--optimize-every
K]`` is the per-frame incremental loop; ``--view`` / ``--save-plot PATH``
render the result; ``--profile DIR`` writes a ``torch.profiler`` trace of
the optimize, with the solve's phase spans (``toyslam_torch/tracing.py``).

``python -m toyslam_torch serve [--port 8888 --iterations 10 --backend
torch|native --device cuda]`` stands up a graph-optimization server that
speaks the framed wire codec (``io/codec.py``).

``python -m toyslam_torch ba3d [--poses 64 --landmarks 256 --obs 24
--iterations 25 --huber 1e9 --seed 0 --device cuda]`` does the same for the
synthetic SE(3) bundle-adjustment problem (``toyslam_tpu``'s ``ba3d``: the
same config and keys, plus the device and the kernel launch count).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def resolve_device(name: str):
    """The torch device of ``--device name``, or None (after a message on
    stderr) when it asks for a CUDA device and there is none."""
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"--device {name}: no CUDA device", file=sys.stderr)
        return None
    return device


def _have_matplotlib() -> bool:
    """Whether ``--view`` / ``--save-plot`` can run: matplotlib is an
    optional dependency (a message on stderr when it is missing)."""
    import importlib.util

    if importlib.util.find_spec("matplotlib") is None:
        print("--view / --save-plot need matplotlib, which is not installed",
              file=sys.stderr)
        return False
    return True


def _launch_count() -> int:
    """Launches of both CUDA kernels so far: graphs of 2048 poses and more
    may take the band kernel."""
    from toyslam_torch.ops import fused_pcg

    return (fused_pcg.fused_pcg_chunk.launches
            + fused_pcg.band_fused_pcg_chunk.launches)


def cmd_live(args, cfg, device) -> int:
    """Per-frame incremental mode: step -> scan -> graph insert -> view
    updates, re-optimizing every ``--optimize-every`` frames (0 = only at
    the end).  Each re-optimization is a new, larger graph, moved to the
    device and laid out there."""
    import numpy as np

    from toyslam_torch.optimizer import GaussNewton
    from toyslam_torch.sim import frontend
    from toyslam_torch.sim.live import LiveSlam, attach_views

    live = LiveSlam(cfg)
    gn = GaussNewton(cfg.optimizer)

    def optimize_fn(g):
        return gn.optimize(g.to(device)).graph

    update = None
    view = None
    if args.view or args.save_plot:
        import matplotlib

        if not args.view:
            matplotlib.use("Agg")
        from toyslam_torch.view.view2d import View

        view = View(title="toyslam_torch live")
        update = attach_views(live, view)

    launches0 = _launch_count()
    t0 = time.perf_counter()
    opt_graph = None
    n_opts = 0
    while live.step():
        if args.optimize_every and live.frame % args.optimize_every == 0:
            opt_graph = live.optimize(optimize_fn)
            n_opts += 1
        if update is not None:
            update(opt_graph)
            if args.view:
                view.pause(0.001)
    opt_graph = live.optimize(optimize_fn)
    n_opts += 1
    if update is not None:
        update(opt_graph)
    wall = time.perf_counter() - t0

    n = len(live.traj_gt)
    gt = np.asarray(live.traj_gt, np.float32)
    est = opt_graph.poses.cpu().numpy()[:n]
    metrics = {
        "cmd": "run --live",
        "device": str(device),
        "frames": live.frame,
        "optimizations": n_opts,
        "poses": n,
        "landmarks": int(opt_graph.lm_mask.sum().item()),
        "ate_rmse": round(frontend.ate_rmse(est, gt), 4),
        "ate_dead_reckoning": round(
            frontend.ate_rmse(np.asarray(live.traj_dr, np.float32), gt), 4
        ),
        "wall_s": round(wall, 4),
        "frames_per_s": round(live.frame / wall, 2),
        "kernel_launches": _launch_count() - launches0,
    }
    if args.save_plot and view is not None:
        view.save(args.save_plot)
        metrics["plot"] = args.save_plot
    if view is not None:
        if args.view:
            import matplotlib.pyplot as plt

            plt.show()
        view.close()
    print(json.dumps(metrics))
    return 0


def _profiled_optimize(gn, graph, trace_dir: str):
    """``gn.optimize(graph)`` under a ``torch.profiler`` trace (CPU and,
    on a GPU, CUDA activities), exported as a Chrome trace to
    ``trace_dir``; the fence that waits for the device is inside it."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if graph.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        res = gn.optimize(graph)
        res.graph.poses.cpu()   # fence inside the trace
        if graph.device.type == "cuda":
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(trace_dir, "optimize_trace.json"))
    return res


def cmd_run(args) -> int:
    import numpy as np

    from toyslam_torch.config import OptimizerConfig, SimConfig, SlamConfig
    from toyslam_torch.optimizer import GaussNewton
    from toyslam_torch.sim import frontend

    device = resolve_device(args.device)
    if device is None:
        return 2
    cfg = SlamConfig(
        sim=SimConfig(robot_steps=args.steps, seed=args.seed),
        optimizer=OptimizerConfig(
            iterations=args.iterations, lr=args.lr, solver=args.solver,
        ),
    )
    if (args.view or args.save_plot) and not _have_matplotlib():
        return 2
    if args.live:
        return cmd_live(args, cfg, device)
    t0 = time.perf_counter()
    sim = frontend.simulate(cfg.sim)
    t_sim = time.perf_counter() - t0
    graph, _ = frontend.build_graph(sim, cfg)
    t_build = time.perf_counter() - t0 - t_sim

    gn = GaussNewton(cfg.optimizer)
    backend = "local"
    launches0 = _launch_count()
    t1 = time.perf_counter()
    if args.remote:
        host, _, port = args.remote.partition(":")
        from toyslam_torch.io.client import (
            GraphClient,
            optimize_with_fallback,
        )

        client = GraphClient(host or "127.0.0.1", int(port or 8888))

        async def _go():
            try:
                await client.connect()
            except (OSError, asyncio.TimeoutError):
                _log(f"cannot connect to {args.remote}; using local optimizer")
            out, used = await optimize_with_fallback(
                graph, client if client.connected else None,
                lambda g: gn.optimize(g.to(device)).graph,
            )
            await client.close()
            return out, used

        opt_graph, backend = asyncio.run(_go())
        res = None
    else:
        graph = graph.to(device)
        if args.profile:
            res = _profiled_optimize(gn, graph, args.profile)
        else:
            res = gn.optimize(graph)
        opt_graph = res.graph
    est = opt_graph.poses.cpu().numpy()   # fence: waits for the device
    t_opt = time.perf_counter() - t1

    n = sim.poses_gt.shape[0]
    metrics = {
        "cmd": "run",
        "backend": backend,
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
    }
    if res is not None:
        iters = res.iterations_run
        errors = res.errors.cpu().numpy()
        metrics["iterations_run"] = iters
        valid = errors[~np.isnan(errors)]
        if valid.size:
            metrics["chi2_first"] = round(float(valid[0]), 2)
            metrics["chi2_final"] = round(float(valid[-1]), 2)
        metrics["pcg_iters"] = res.pcg_iters[:iters].tolist()
        metrics["lambdas"] = (
            res.lambdas[:iters].cpu().numpy().round(6).tolist())
        if args.profile:
            metrics["profile_trace"] = args.profile
    # launches in this process: 0 when a remote server did the solve
    metrics["kernel_launches"] = _launch_count() - launches0

    if args.snapshot:
        from toyslam_torch.io.snapshot import save_snapshot

        save_snapshot(args.snapshot, opt_graph, metadata={"metrics": metrics})
        metrics["snapshot"] = args.snapshot

    if args.save_plot or args.view:
        import matplotlib

        if not args.view:
            matplotlib.use("Agg")
        from toyslam_torch.view import render_result

        view = render_result(
            sim.env, sim.radius, sim.poses_gt, sim.poses_dr,
            est[:n],
            opt_graph.landmarks[opt_graph.lm_mask > 0],
            save_path=args.save_plot,
        )
        if args.save_plot:
            metrics["plot"] = args.save_plot
        if args.view:
            import matplotlib.pyplot as plt

            plt.show()
        view.close()

    print(json.dumps(metrics))
    return 0


def cmd_ba3d(args) -> int:
    import numpy as np

    from toyslam_torch.config import OptimizerConfig
    from toyslam_torch.optimizer import GaussNewton
    from toyslam_torch.sim import synthetic3d

    device = resolve_device(args.device)
    if device is None:
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
    launches0 = _launch_count()
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
        "kernel_launches": _launch_count() - launches0,
    }))
    return 0


def cmd_serve(args) -> int:
    """Stand up a graph-optimization server and serve until interrupted.

    ``--backend torch``: the pure-Python asyncio server around this
    package's Gauss-Newton on ``--device`` (the kernels are built before it
    listens).  ``--backend native``: the C++ runtime with its built-in CPU
    optimizer at its own default iteration count; ``--iterations`` and
    ``--device`` do not reach it."""
    from toyslam_torch.config import OptimizerConfig
    from toyslam_torch.io.server import (
        PyGraphServer,
        native_server,
        torch_optimize_fn,
    )

    if args.backend == "native":
        server = native_server(backend="native", port=args.port)
        _log(f"native graph server (built-in CPU optimizer) on port "
             f"{args.port}")
    else:
        device = resolve_device(args.device)
        if device is None:
            return 2
        server = PyGraphServer(
            torch_optimize_fn(
                OptimizerConfig(iterations=args.iterations, solver="schur"),
                device,
            ),
            port=args.port,
        )
        _log(f"torch graph server on port {args.port} (device {device}, "
             f"iterations={args.iterations})")
    with server:
        _log(f"listening on {server.port}; Ctrl-C to stop")
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
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
    r.add_argument("--solver", choices=("dense", "schur"), default="schur")
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--device", default="cuda",
                   help="torch device to optimize on: cuda (the default, "
                        "through the CUDA kernels) or cpu (their plain "
                        "PyTorch versions)")
    r.add_argument("--live", action="store_true",
                   help="per-frame incremental mode with live view updates")
    r.add_argument("--optimize-every", type=int, default=0, metavar="K",
                   help="with --live: re-optimize every K frames "
                        "(0 = only at the end)")
    r.add_argument("--remote", metavar="HOST:PORT", default=None,
                   help="optimize on a graph server (local fallback on "
                        "--device)")
    r.add_argument("--view", action="store_true",
                   help="show the interactive result plot")
    r.add_argument("--save-plot", metavar="PATH", default=None)
    r.add_argument("--profile", metavar="DIR", default=None,
                   help="write a torch.profiler trace of the optimize to DIR")
    r.add_argument("--snapshot", metavar="PATH", default=None,
                   help="save the optimized graph (io.snapshot, .npz)")
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
    s = sub.add_parser("serve", help="graph-optimization server")
    s.add_argument("--port", type=int, default=8888)
    s.add_argument("--iterations", type=int, default=10)
    s.add_argument("--backend", choices=("torch", "native"), default="torch")
    s.add_argument("--device", default="cuda",
                   help="torch device the torch backend solves on: cuda "
                        "(the default) or cpu")
    s.set_defaults(fn=cmd_serve)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
