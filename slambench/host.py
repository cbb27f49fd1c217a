"""How fast the host ran around a window, for each run's record: a fixed
pure-Python loop timed just before and just after the window, and the
process's CPU seconds in it.

The cells are host-bound, so their times follow the host's speed; these
readings say whether a run that reads far off ran on a slower host core,
or was kept off its core."""

from __future__ import annotations

import time

LOOP = 3_000_000


def loop_seconds() -> float:
    """Seconds of a fixed pure-Python loop (~0.1 s on a fast core)."""
    t0 = time.perf_counter()
    x = 0
    for i in range(LOOP):
        x += i
    return time.perf_counter() - t0


def before() -> dict:
    """Readings at the window's start (the loop runs first)."""
    return {"loop_before_s": loop_seconds(), "cpu": time.process_time()}


def after(start: dict) -> dict:
    """The run's host record from ``before``'s readings, read as the
    window has closed."""
    cpu = time.process_time()
    return {"loop_before_s": start["loop_before_s"],
            "loop_after_s": loop_seconds(),
            "window_cpu_s": cpu - start["cpu"]}
