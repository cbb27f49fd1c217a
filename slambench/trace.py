"""The traced run's readings: the device's busy time, the kernels' times by
name, and where the device waited, from ``torch.profiler``'s events.

Busy time is the union of the device activities' intervals (kernels,
copies, sets) inside the traced window, so that work on overlapping
streams counts once.  An idle gap is named by the innermost host op that
was running at its middle, or as Python between torch ops where none
was.

The kernels of the window's own work (``Trace.launched``, what the
roofline readers take) are chosen by the launch that issued them, not by
their timestamps: each device activity whose correlation id is that of a
host-side launch call (a CUDA runtime or driver event ``cu*Launch*``:
``cudaLaunchKernel``, ``cudaLaunchKernelExC`` for a cluster,
``cudaLaunchCooperativeKernel``, ``cuLaunchKernel``...) that started inside
the window.  The device's clock drifts against the host's by some
per cent of a window, so a kernel launched near the window's end can be
stamped past it.

The work's device time (``Trace.work_s``) is the union of every device
activity's interval in the profile, none clipped to the window: where a
profile holds one piece of work and nothing else (the remote cell's
server profiles one request at a time, each ending with its answer on
the host), that is the device time of that work.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

WINDOW_SPAN = "slambench.window"


class Trace(NamedTuple):
    window_s: float
    busy_s: float
    device: list        # (name, start_s, seconds) per device activity
    host: list          # (name, start_s, seconds) per host op
    gaps: list          # (start_s, seconds) idle gaps inside the window
    launched: tuple = ()    # (name, start_s, seconds) per device activity
                            # launched inside the window
    work_s: float = 0.0     # union of every device activity, unclipped


@contextlib.contextmanager
def profiled(device: torch.device):
    """Profile the body; yields a holder whose ``trace`` is set on exit."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    holder = type("Holder", (), {"trace": None})()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW_SPAN):
            yield holder
    holder.trace = read(_events(prof))


def _events(prof):
    """``(name, start_ns, duration_ns, on_device, correlation_id)`` of
    every event."""
    out = []
    for e in prof.profiler.kineto_results.events():
        on_dev = e.device_type() != torch.autograd.DeviceType.CPU
        if on_dev and (e.is_user_annotation() or e.name() == WINDOW_SPAN):
            continue        # a host span mirrored on the device's timeline
        out.append((e.name(), e.start_ns(), e.duration_ns(), on_dev,
                    e.correlation_id()))
    return out


def is_launch(name: str) -> bool:
    """Whether a host event is a CUDA runtime or driver call that launches
    work on the device."""
    return name.startswith("cu") and "Launch" in name


def read(events) -> Trace:
    """The readings of ``_events``' list of one profile."""
    window = [e for e in events if e[0] == WINDOW_SPAN and not e[3]]
    if not window:
        raise RuntimeError("the traced window's span is missing")
    w0, wd = window[0][1], window[0][2]
    w1 = w0 + wd
    dev = sorted((e for e in events if e[3] and e[1] < w1
                  and e[1] + e[2] > w0), key=lambda e: e[1])
    host = [e for e in events if not e[3] and e[0] != WINDOW_SPAN]
    ids = {e[4] for e in host if w0 <= e[1] < w1 and is_launch(e[0])}
    launched = sorted((e for e in events if e[3] and e[4] in ids),
                      key=lambda e: e[1])
    work, end = 0, float("-inf")
    for _, s, d, _, _ in sorted((e for e in events if e[3]),
                                key=lambda e: e[1]):
        if s + d > end:
            work += s + d - max(s, end)
            end = s + d
    busy, gaps = 0, []
    cursor = w0
    for _, s, d, _, _ in dev:
        s, t = max(s, w0), min(s + d, w1)
        if s > cursor:
            gaps.append(((cursor - w0) * 1e-9, (s - cursor) * 1e-9))
        if t > cursor:
            busy += t - max(s, cursor)
            cursor = t
    if w1 > cursor:
        gaps.append(((cursor - w0) * 1e-9, (w1 - cursor) * 1e-9))
    return Trace(
        window_s=wd * 1e-9, busy_s=busy * 1e-9,
        device=[(n, (s - w0) * 1e-9, d * 1e-9) for n, s, d, *_ in dev],
        host=[(n, (s - w0) * 1e-9, d * 1e-9) for n, s, d, *_ in host],
        gaps=gaps,
        launched=tuple((n, (s - w0) * 1e-9, d * 1e-9)
                       for n, s, d, *_ in launched),
        work_s=work * 1e-9)


def breakdown(traces, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps summed by the host op running at their middle, over one or more
    traces."""
    by_op: dict = {}
    by_host: dict = {}
    for tr in traces:
        for n, _, d in tr.device:
            by_op[n] = by_op.get(n, 0.0) + d
        gaps = sorted(tr.gaps, key=lambda g: -g[1])[:500]
        if not gaps:
            continue
        names = [h[0] for h in tr.host]
        hs = np.array([h[1] for h in tr.host])
        he = hs + np.array([h[2] for h in tr.host])
        for s, d in gaps:
            mid = s + 0.5 * d
            inside = np.nonzero((hs <= mid) & (he >= mid))[0]
            name = ("(python between torch ops)" if inside.size == 0 else
                    names[inside[np.argmin(he[inside] - hs[inside])]])
            by_host[name] = by_host.get(name, 0.0) + d
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in idle]}
