"""The remote cell's server process: the port's ``PyGraphServer`` over
``torch_optimize_fn``, the configuration's optimizer on ``--device``.

    python -m slambench.server --config FILE --device cuda --dump FILE

Prints ``port N`` once it listens (after the kernels are built).  SIGUSR1
has it profile each request that follows (a profiler per request, around
the callback).  SIGTERM stops it; it then writes ``--dump``: the server's
host timings per request, the kernels' launch counts, the card's name and
peak memory, the profiled requests' readings (each one's device time in
``work_s``), and the top-level names of any JAX module it holds.
``--fault`` breaks the answers, for the tests that show the comparison
fails: ``unchanged`` returns the request's graph as it came, ``alter``
moves one pose of the answer by a metre.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import signal
import sys
import threading

import torch

from slambench import trace
from slambench.cells import forbidden_modules


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dump", required=True)
    ap.add_argument("--fault", default="none",
                    choices=("none", "unchanged", "alter"))
    args = ap.parse_args(argv)

    from toyslam_torch.config import OptimizerConfig
    from toyslam_torch.io.server import PyGraphServer, torch_optimize_fn
    from toyslam_torch.ops import fused_pcg as fp

    config = json.loads(open(args.config).read())
    device = torch.device(args.device)
    solve = torch_optimize_fn(OptimizerConfig(**config["optimizer"]),
                              args.device)
    state = {"profile": False, "traces": []}
    stop = threading.Event()

    def optimize(graph):
        if not state["profile"]:
            out = solve(graph)
        else:
            with trace.profiled(device) as held:
                out = solve(graph)
            state["traces"].append(held.trace)
        if args.fault == "unchanged":
            return graph
        if args.fault == "alter":
            poses = out.poses.clone()
            poses[len(poses) // 2, 0] += 1.0
            return dataclasses.replace(out, poses=poses)
        return out

    signal.signal(signal.SIGUSR1,
                  lambda *_: state.__setitem__("profile", True))
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    server = PyGraphServer(optimize, port=0).start()
    print(f"port {server.port}", flush=True)
    while not stop.wait(0.05):
        pass
    server.stop()

    record = {
        "timings": list(solve.timings),
        "launches": {"fused_pcg_chunk": fp.fused_pcg_chunk.launches,
                     "band_fused_pcg_chunk": fp.band_fused_pcg_chunk.launches},
        "error": None if server.error is None else repr(server.error),
        "forbidden_modules": forbidden_modules(),
    }
    if device.type == "cuda":
        record["kind"] = torch.cuda.get_device_name(device)
        record["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    traces = state["traces"]
    if traces:
        record["busy_s"] = sum(t.busy_s for t in traces)
        record["window_s"] = sum(t.window_s for t in traces)
        record["breakdown"] = trace.breakdown(traces)
        record["work_s"] = [t.work_s for t in traces]
    with open(args.dump, "w") as f:
        json.dump(record, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
