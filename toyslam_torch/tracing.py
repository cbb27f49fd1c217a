"""Named spans at the solve's layer boundaries, on the profiler's clock.

``span(name)`` is a ``torch.profiler.record_function`` while a profiler
runs on this thread, else one shared null context: a ``record_function``
costs microseconds even with no profiler running, a gated span ~0.4 us
(and ~0.2 ms under a profiler with CUDA activities, PERF.md).  The
profiler is the exporter (``run --profile DIR``, or any caller's
``torch.profiler.profile``): the spans are its host events, on the same
timeline as the device's activities.  Names are fixed strings under
``toyslam.`` with no per-call ids, so that a trace sums them by name; a
span's parent is the span that encloses it on the same thread.
"""

from __future__ import annotations

import contextlib

import torch

_NULL = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` while a profiler runs."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL
