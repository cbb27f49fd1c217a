"""The slab-streamed band ``V V^T`` matvec (B3, ``ops/band_matvec.py``)
alone: its correctness check and its timing sweep.

    python -m toyslam_torch.scripts.exp_band_kernel [--device cuda|cpu]

Counterpart of the JAX package's ``scripts/exp_band_kernel.py::main``, with
the same seeded inputs (numpy, seed 0, drawn in the same order):

1. correctness at ``Np=10240, W=64, B=256``: the matvec against the numpy
   :func:`oracle`, relative error below 1e-5 of max|want|, else it raises;
2. on the card only, ``reps=8`` matvecs at ``W`` in {320, 576} x ``B`` in
   {512, 1024}: one line per shape with the microseconds per matvec (CUDA
   events around ``reps`` launches, the median of 3 rounds), the bound
   (``band_matvec.bound``), the slab bytes over that time, and the card's
   name and power limit.

``--device cuda`` (the default) runs the hand-written kernel and exits 2
without a GPU; ``--device cpu`` runs the plain version and skips the
timing.  :func:`main` returns what it measured.
"""

from __future__ import annotations

import argparse
import statistics
import sys

import numpy as np
import torch

from toyslam_torch.bench import card
from toyslam_torch.ops.band_matvec import DL, DP, bound, slab_band_matvec

NP = 10240
CHECK = (64, 256)                          # (W, B) of the correctness check
SWEEP = [(W, B) for W in (320, 576) for B in (512, 1024)]
REPS, ROUNDS = 8, 3
REL_TOL = 1e-5


def oracle(slab, x, np_, W, B):
    """``V (V^T x)`` in numpy loops, as the JAX package's script has it."""
    n_chunks = np_ // B
    xe = np.concatenate([x, np.zeros((DP, W), np.float32)], axis=1)
    wacc = np.zeros((DP, np_ + W), np.float32)
    for c in range(n_chunks):
        sb = slab[c]                                      # [W, 6, B]
        t = np.zeros((DL, B), np.float32)
        for w in range(W):
            for a in range(DP):
                for b in range(DL):
                    t[b] += sb[w, a * DL + b] * xe[a, c * B + w:
                                                   c * B + w + B]
        for w in range(W):
            for a in range(DP):
                for b in range(DL):
                    wacc[a, c * B + w: c * B + w + B] += (
                        sb[w, a * DL + b] * t[b]
                    )
    return wacc[:, :np_]


def matvec_ms(x, slab, W, B, reps=REPS, rounds=ROUNDS) -> list[float]:
    """Milliseconds per matvec of ``rounds`` rounds of ``reps`` launches
    each, CUDA events, after one launch to warm up."""
    slab_band_matvec(x, slab, W, B)
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            slab_band_matvec(x, slab, W, B)
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    device = torch.device(parser.parse_args(argv).device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("--device cuda: no CUDA device", file=sys.stderr)
        raise SystemExit(2)

    rng = np.random.default_rng(0)
    x = rng.normal(size=(DP, NP)).astype(np.float32)
    W, B = CHECK
    slab_s = rng.normal(size=(NP // B, W, DP * DL, B)).astype(np.float32)
    xd = torch.from_numpy(x).to(device)
    got = slab_band_matvec(xd, torch.from_numpy(slab_s).to(device), W, B)
    want = oracle(slab_s, x, NP, W, B)
    err = float(np.abs(got.cpu().numpy() - want).max()
                / max(np.abs(want).max(), 1e-9))
    print(f"correctness W={W} B={B}: rel err {err:.2e} ({device.type})",
          flush=True)
    if not err < REL_TOL:
        raise AssertionError(f"rel err {err:.2e} >= {REL_TOL:g}")
    result = {"device": device.type, "check": {"W": W, "B": B, "rel": err},
              "sweep": []}
    if device.type == "cpu":
        print("CPU: skipping timing", flush=True)
        return result

    smi = card()
    for W, B in SWEEP:
        slab = rng.normal(size=(NP // B, W, DP * DL, B)).astype(np.float32)
        ms = matvec_ms(xd, torch.from_numpy(slab).to(device), W, B)
        per = statistics.median(ms)
        b = bound(NP, W, B)
        row = {"W": W, "B": B, "slab_bytes": slab.nbytes, "ms": ms,
               "us_per_matvec": per * 1e3, **b,
               "gb_s": slab.nbytes / (per * 1e-3) / 1e9}
        result["sweep"].append(row)
        print(f"band matvec W={W} B={B} ({slab.nbytes / 2**20:.0f} MB): "
              f"{row['us_per_matvec']:.1f} us/matvec, bound "
              f"{b['bound_ms'] * 1e3:.1f} us ({b['bound_by']}), "
              f"{row['gb_s']:.0f} GB/s effective [{smi}]", flush=True)
    return result


if __name__ == "__main__":
    main()
