"""B1, the resident fused-PCG chunk, timed alone at the paths' layouts.

    python -m toyslam_torch.scripts.bench_b1 [--reps N] [--rounds N]
    PYTHONPATH=<checkout> python <this file> ...

For each layout of :data:`LAYOUTS` (the main path, the ba3d defaults and
bench row at dp=6, multi-loop-1k, the 2000-pose request) it builds the
smoke's seeded system of that shape (``chip_smoke.synthetic_system``) and
times one fresh 16-iteration chunk through the public wrapper
``fused_pcg_chunk`` (the plan's default schedule): CUDA events over
``reps`` launches, ``rounds`` times.  One JSON line per layout, with the
card's name and power limit.  It reads nothing but that wrapper, the state
tuple and the smoke's system, so it times another checkout's kernel too:
run the file with that checkout first on ``PYTHONPATH`` (a change and its
parent in one call, in turns).  Exits 2 without a GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

# (name, dp, Np, Mw, PCR levels, eps): chip_smoke.B1_LAYOUTS
LAYOUTS = [
    ("main_dp3_Np192", 3, 192, 768, 8, 1e-2),
    ("ba3d_dp6_Np64", 6, 64, 768, 6, 1e-2),
    ("ba128_dp6_Np128", 6, 128, 1536, 7, 1e-2),
    ("multiloop_dp3_Np1088", 3, 1088, 768, 11, 1e-1),
    ("serve2000_dp3_Np2048", 3, 2048, 768, 11, 1e-1),
]
CHUNK = 16


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=50)
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("bench_b1: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from toyslam_torch.ops import fused_pcg as fp

    device = torch.device("cuda", 0)
    name = card()
    for i, (lay, dp, np_, mw, nl, eps) in enumerate(LAYOUTS):
        op, pre, rhs = chip_smoke.synthetic_system(
            np_, mw, nl, 0, eps, seed=20 + i, device=device, dp=dp)
        st = chip_smoke.fresh_state(rhs)
        atol2 = ((1e-6 ** 2) * (rhs * rhs).sum()).reshape(1)
        ms = [chip_smoke.cuda_ms(lambda: fp.fused_pcg_chunk(
            op, pre, rhs, st, atol2, 200, True, CHUNK), args.reps)
            for _ in range(args.rounds)]
        print(json.dumps({"layout": lay, "ms": ms, "chunk": CHUNK,
                          "source": fp.__file__, "card": name}), flush=True)
        del op, pre, rhs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
