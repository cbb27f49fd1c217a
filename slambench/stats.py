"""The statistics of a closed-loop window: the rate as window seconds
over the calls finished in it, and the tail of every call's time."""

from __future__ import annotations

import numpy as np


def closed_loop(prefix: str, times: list, window_s: float) -> dict:
    """``<prefix>_ms``: the window's milliseconds over its finished calls;
    ``<prefix>_ms_p90``: the 90th percentile of every call's time (ms)."""
    n = max(len(times), 1)
    return {f"{prefix}_ms": window_s / n * 1e3,
            f"{prefix}_ms_p90": float(np.percentile(np.asarray(times), 90))
            * 1e3}
