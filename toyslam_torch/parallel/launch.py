"""Start N ranks on this host and run the sharded Gauss-Newton in them: the
counterpart of the JAX package's ``scripts/launch_multihost.py``.

    python -m toyslam_torch.parallel.launch --procs 4 --steps 150 \\
        --iterations 10 --reps 3 [--solve edge [partition]] [--out F] \\
        [--device cuda|cpu]

Each rank is a process of its own (``torch.multiprocessing``, spawn).  The
ranks meet through a ``file://`` store in a temporary directory, build the
same deterministic graph (the seeded 150-step simulation by default), and
run ``GaussNewton`` with the edge-sharded solve
(``distributed_linearize_solve``, the default), the partitioned one, or
both in turn (``--solve edge partition``: one start of the ranks).  The
launcher collects every rank's metrics, checks that the ranks agree bit for
bit on the whole trajectory, the chi^2 and lambda of every iteration and
the iteration counts (``bitwise_agreement_across_processes``, per solve
under ``runs``), and prints one JSON line; ``--out F`` writes it to F with
rank 0's optimized poses.
It writes nothing else.  A rank that fails or dies makes the launcher exit
non-zero.

Device and backend follow ``parallel.mesh``: rank r on
``cuda:{r % device_count}`` (or the CPU with ``--device cpu``), NCCL when
every rank has a card of its own, gloo otherwise.  With more ranks than
cards the ranks share a card, and the times are those of N processes
taking turns on it: not a scaling number.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
import time

import torch
import torch.distributed as dist


def _rank_main(rank, fn, procs, device, init_method, out_dir, args):
    from toyslam_torch.parallel.mesh import initialize_distributed, make_mesh

    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    initialize_distributed(num_processes=procs, process_id=rank,
                           init_method=init_method, device=device)
    # an exception leaves the group as it is: it reaches the launcher, which
    # ends the other ranks (tearing the group down under them aborts)
    result = fn(make_mesh(device=device), *args)
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    # no rank tears the group down while a peer is still in a collective
    dist.barrier()
    dist.destroy_process_group()


def run_ranks(fn, procs: int, device: str = "cuda", args: tuple = ()):
    """``fn(mesh, *args)`` in each of ``procs`` spawned ranks; their
    results (picklable, on the host) in rank order.  ``fn`` must be a
    module-level function.  A rank that raises or dies ends the others and
    raises here."""
    with tempfile.TemporaryDirectory(prefix="toyslam_ranks_") as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        torch.multiprocessing.start_processes(
            _rank_main, args=(fn, procs, device, init_method, tmp, args),
            nprocs=procs, start_method="spawn", join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(procs)]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def collective_ms(mesh, numel: int = 1000, reps: int = 50) -> float:
    """Mean wall ms of one all-reduce of ``numel`` floats on the rank's
    device, synchronised (after 5 unrecorded ones)."""
    t = torch.ones(numel, device=mesh.device)
    for _ in range(5):
        dist.all_reduce(t, group=mesh.group)
    _sync(mesh.device)
    t0 = time.perf_counter()
    for _ in range(reps):
        dist.all_reduce(t, group=mesh.group)
    _sync(mesh.device)
    return (time.perf_counter() - t0) / reps * 1e3


def optimize_rank(mesh, steps: int, iterations: int, reps: int,
                  solves: tuple[str, ...]) -> dict:
    """One rank of the launcher's run: the seeded ``steps``-pose graph
    optimized ``1 + reps`` times through each sharded solve in turn; per
    solve the metrics of the first run, the wall seconds of each (the rate
    from the repeats, or from the first run where there are none: the
    plain loop compiles nothing), and digests of what every rank must agree
    on."""
    from toyslam_torch.config import OptimizerConfig, SimConfig, SlamConfig
    from toyslam_torch.sim import frontend

    cfg = SlamConfig(sim=SimConfig(robot_steps=steps, seed=0))
    sim = frontend.simulate(cfg.sim)       # the same on every rank
    graph, _ = frontend.build_graph(sim, cfg)
    opt = OptimizerConfig(iterations=iterations, solver="schur",
                          pcg_tol=1e-8, pcg_max_iters=400)
    return {solve: _optimize_solve(mesh, sim, graph, opt, reps, solve)
            for solve in solves}


def _optimize_solve(mesh, sim, graph, opt, reps, solve):
    from toyslam_torch.ops import fused_pcg as fp
    from toyslam_torch.ops import pcr
    from toyslam_torch.ops.collective import all_reduce
    from toyslam_torch.optimizer import GaussNewton
    from toyslam_torch.parallel import (
        distributed_linearize_solve,
        gather_result,
        partitioned_linearize_solve,
    )
    from toyslam_torch.sim import frontend

    make = {"edge": distributed_linearize_solve,
            "partition": partitioned_linearize_solve}[solve]
    s = make(opt, mesh)
    gn = GaussNewton(opt, solve=s)
    gprep = s.prepare(graph)

    fp.fused_pcg_chunk.launches = 0
    fp.band_fused_pcg_chunk.launches = 0
    pcr.pcr_factor.launches = 0
    all_reduce.calls = 0
    t0 = time.perf_counter()
    r = gn.optimize(gprep)
    _sync(mesh.device)
    wall = [time.perf_counter() - t0]
    calls = all_reduce.calls
    launches = {"fused_pcg_chunk": fp.fused_pcg_chunk.launches,
                "band_fused_pcg_chunk": fp.band_fused_pcg_chunk.launches,
                "pcr_factor": pcr.pcr_factor.launches}
    for _ in range(reps):
        t0 = time.perf_counter()
        gn.optimize(gprep)
        _sync(mesh.device)
        wall.append(time.perf_counter() - t0)
    timed = wall[1:] or wall

    if solve == "partition":
        poses = gather_result(r, s.meta, mesh)[0]
    else:
        poses = r.graph.poses
    it = r.iterations_run
    n = sim.poses_gt.shape[0]
    est = poses.cpu().numpy()[:n]
    out = {
        "rank": mesh.rank,
        "device": str(mesh.device),
        "backend": mesh.backend,
        "poses": n,
        "iterations_run": it,
        "chi2": r.errors[:it].tolist(),
        "pcg_iters": r.pcg_iters[:it].tolist(),
        "ate_rmse": frontend.ate_rmse(est, sim.poses_gt),
        "ate_dead_reckoning": frontend.ate_rmse(sim.poses_dr, sim.poses_gt),
        "finite": bool(torch.isfinite(poses).all()),
        "kernel_launches": launches,
        "collectives": calls,
        "collectives_per_gn_iter": calls / max(it, 1),
        "wall_s": wall,
        "gn_iters_per_s": it * len(timed) / sum(timed),
        "collective_ms": collective_ms(mesh),
        "digest": _digest(poses, r.errors, r.lambdas, r.pcg_iters,
                          torch.tensor([it])),
        "poses_checksum": float(poses.double().sum()),
        "trajectory": est.tolist(),
    }
    if solve == "partition":
        out["boundary_pose_frac"] = s.meta.boundary_pose_frac
        out["boundary_lm_frac"] = s.meta.boundary_lm_frac
    return out


def launch(procs: int, steps: int, iterations: int, reps: int,
           solves: tuple[str, ...] = ("edge",), device: str = "cuda") -> dict:
    """Run :func:`optimize_rank` in ``procs`` ranks; the launcher's JSON
    object, with rank 0's optimized poses under each run's
    ``trajectory``."""
    from toyslam_torch.parallel.mesh import backend_for

    backend = backend_for(procs, device)
    cards = torch.cuda.device_count() if device != "cpu" else 0
    outs = run_ranks(optimize_rank, procs, device,
                     (steps, iterations, reps, tuple(solves)))
    runs = {}
    for solve in solves:
        per_rank = [o[solve] for o in outs]
        result = dict(per_rank[0])
        trajectory = result.pop("trajectory")
        agree = len({o["digest"] for o in per_rank}) == 1
        runs[solve] = {
            "ok": agree and all(o["finite"] for o in per_rank),
            "bitwise_agreement_across_processes": agree,
            "kernel_launches": [o["kernel_launches"] for o in per_rank],
            "result": result,
            "trajectory": trajectory,
        }
    return {
        "ok": all(r["ok"] for r in runs.values()),
        "bitwise_agreement_across_processes": all(
            r["bitwise_agreement_across_processes"] for r in runs.values()),
        "num_processes": procs,
        "backend": backend,
        "device_rule": (f"rank r on cuda:(r % {cards}), {backend}"
                        if cards else "every rank on the CPU, gloo"),
        "card": torch.cuda.get_device_name(0) if cards else None,
        "shared_card": bool(cards) and procs > cards,
        "runs": runs,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--iterations", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--solve", choices=("edge", "partition"), nargs="+",
                    default=["edge"])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    artifact = launch(args.procs, args.steps, args.iterations, args.reps,
                      args.solve, args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(artifact, f, indent=1)
    for run in artifact["runs"].values():
        run.pop("trajectory")
    print(json.dumps(artifact), flush=True)
    return 0 if artifact["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
