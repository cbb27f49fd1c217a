"""Where the slab band matvec's wrapper (B3, ``ops/band_matvec.py``) spends
its host time per call.

    python -m toyslam_torch.scripts.band_matvec_host [--calls 1000]

At ``Np=10240, W=64, B=256`` (the entry point's check shape, where the
matvec's device time is some 10 us and a loop of calls is bound by the
host), each step of the wrapper is timed alone and the whole wrapper too:
the argument checks, the plan, a ``torch.empty`` (the output), the stream
handle (``_stream``), the scratch, output and stream together
(``_cuda_args``), and the ctypes call that enqueues both launches.
``us_per_call``: a host clock around ``calls`` back-to-back calls,
synchronised once at the end (where the card is the slower, the card's
time); ``host_us_per_call``: 100 calls with the clock stopped before the
synchronise, the host's own time.  Prints one JSON line with the card's
name and power limit and returns it as a dict.  Needs the card.  Of the
launches this makes, only the whole wrapper's are counted in
``slab_band_matvec.launches``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from toyslam_torch.bench import card
from toyslam_torch.ops import band_matvec as bmv

NP, W, B = 10240, 64, 256


def per_call_us(fn, calls: int) -> float:
    """Host microseconds per call of ``fn`` over ``calls`` calls back to
    back, after 20 to warm up, with one synchronise at the end (so where
    the card is slower than the host, the card's time)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def enqueue_us(fn, calls: int = 100) -> float:
    """Host microseconds per call of ``fn`` alone: ``calls`` calls (few
    enough that the launch queue never fills) with the clock stopped before
    the synchronise."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def host_us(calls: int = 1000, device: str = "cuda") -> dict:
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(3, NP)), dtype=torch.float32,
                     device=device)
    slab = torch.tensor(rng.normal(size=(NP // B, W, 6, B)),
                        dtype=torch.float32, device=device)
    dev = x.device
    plan = bmv.slab_plan(W, B)
    part, out, stream = bmv._cuda_args(x, slab, B, plan, dev)
    lib = bmv._library()
    steps = {
        "wrapper": lambda: bmv.slab_band_matvec(x, slab, W, B),
        "check_args": lambda: bmv._check_args(x, slab, W, B, dev),
        "plan": lambda: bmv.slab_plan(W, B),
        "empty": lambda: torch.empty_like(x),
        "stream": lambda: bmv._stream(dev.index),
        "cuda_args": lambda: bmv._cuda_args(x, slab, B, plan, dev),
        "ctypes_launch": lambda: lib.slab_band_matvec_launch(
            NP, NP // B, W, B, plan.cs, plan.warps, x.data_ptr(),
            slab.data_ptr(), part.data_ptr(), out.data_ptr(), stream),
    }
    us = {k: per_call_us(fn, calls) for k, fn in steps.items()}
    host = {k: enqueue_us(fn) for k, fn in steps.items()}
    return {"W": W, "B": B, "np": NP, "calls": calls, "us_per_call": us,
            "host_us_per_call": host, "card": card()}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--calls", type=int, default=1000)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("band_matvec_host: needs a CUDA device", file=sys.stderr)
        raise SystemExit(2)
    result = host_us(args.calls)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
