"""The program's spans in a traced window: the ``toyslam.`` host events
that ``toyslam_torch.tracing.span`` records, their self time, and where
the device's idle gaps fall among them.

A span's self time is its duration less the union of the ``toyslam.``
spans nested in it, so that the refresh's assembly (``ops.assemble``
inside ``ops.precond``) counts once, as assembly.  Nesting is read from
the intervals alone (``trace.Trace`` keeps no thread): the program's spans
come from the one thread that calls it.
"""

from __future__ import annotations

import numpy as np

PREFIX = "toyslam."
OPTIMIZE = "toyslam.gn.optimize"
ITERATION = "toyslam.gn.iteration"

# the CUDA runtime's calls that wait for the device, as the profiler names
# them; the batch cells' traces on an H100 (torch 2.11) hold only the
# first: the flag reads' ``.item()`` and ``.tolist()``, and copies between
# the device and pageable host memory
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")


def program_spans(tr) -> list:
    """``(name, start_s, end_s)`` of the program's spans, outer first."""
    return sorted(((n, s, s + d) for n, s, d in tr.host
                   if n.startswith(PREFIX)), key=lambda x: (x[1], -x[2]))


def count(tr, name: str) -> int:
    return sum(n == name for n, _, _ in tr.host)


def self_seconds(tr) -> dict:
    """Self seconds by span name, summed over the trace."""
    out: dict = {}
    open_: list = []    # [name, start, end, covered, cursor] outer first

    def close(top):
        out[top[0]] = out.get(top[0], 0.0) + (top[2] - top[1]) - top[3]

    for name, s, e in program_spans(tr):
        while open_ and open_[-1][2] <= s:
            close(open_.pop())
        # the innermost open span that holds this one: the union of its
        # direct children, which start in order
        parent = next((p for p in reversed(open_) if e <= p[2]), None)
        if parent is not None:
            lo = max(s, parent[4])
            if e > lo:
                parent[3] += e - lo
            parent[4] = max(parent[4], e)
        open_.append([name, s, e, 0.0, s])
    while open_:
        close(open_.pop())
    return out


def per_optimize_ms(tr, name: str) -> float | None:
    """Self milliseconds of span ``name`` per ``gn.optimize`` span; None
    where the trace holds no ``gn.optimize`` span."""
    if tr is None:
        return None
    n = count(tr, OPTIMIZE)
    if not n:
        return None
    return 1e3 * self_seconds(tr).get(name, 0.0) / n


def inside(points, spans) -> np.ndarray:
    """Whether each point lies in the union of the ``(name, start, end)``
    spans."""
    points = np.asarray(points, dtype=float)
    if not spans:
        return np.zeros(points.shape, dtype=bool)
    merged: list = []
    for _, s, e in sorted(spans, key=lambda x: x[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    starts = np.array([m[0] for m in merged])
    ends = np.array([m[1] for m in merged])
    i = np.searchsorted(starts, points, side="right") - 1
    return (i >= 0) & (points <= ends[np.maximum(i, 0)])
