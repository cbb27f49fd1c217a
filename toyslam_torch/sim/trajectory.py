"""Scripted robot motion.

The robot follows a piecewise-constant control schedule keyed on the pose
counter; the simulation integrates trajectories sequentially in float64 on
the host (``integrate_np``) so that the simulated problem is bit-identical
to the JAX package's on every platform.  ``integrate`` composes a tape of
tensors in their own dtype and device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from toyslam_torch.ops import se2

# (pose-id upper bound, forward step, turn degrees)
_SCHEDULE = [
    (10, 2.0, 3.0),
    (20, 0.9, 6.0),
    (40, 0.9, -6.0),
    (60, 0.8, 5.0),
    (10**9, 0.7, 3.0),
]


def scripted_controls(num_steps: int) -> np.ndarray:
    """``[num_steps, 3]`` relative motions (dx, dy=0, dtheta) for steps taken
    at pose ids ``0 .. num_steps-1``."""
    out = np.zeros((num_steps, 3), np.float32)
    for k in range(num_steps):
        for bound, dx, deg in _SCHEDULE:
            if k < bound:
                out[k] = (dx, 0.0, math.radians(deg))
                break
    return out


def integrate_np(start: np.ndarray, controls: np.ndarray) -> np.ndarray:
    """Float64 sequential SE(2) compose: ``[T+1, 3]`` poses."""
    out = np.empty((controls.shape[0] + 1, 3), np.float64)
    out[0] = start
    x, y, th = start
    for k, (dx, dy, dth) in enumerate(controls):
        c, s = np.cos(th), np.sin(th)
        x, y = x + c * dx - s * dy, y + s * dx + c * dy
        th = np.arctan2(np.sin(th + dth), np.cos(th + dth))
        out[k + 1] = (x, y, th)
    return out


def integrate(start: torch.Tensor, controls: torch.Tensor) -> torch.Tensor:
    """Compose a control tape into a trajectory in the tensors' dtype and
    on their device: ``[T+1, 3]`` poses (``integrate_np`` is the float64
    host version the simulation uses)."""
    out = [start]
    for u in controls:
        out.append(se2.compose(out[-1], u))
    return torch.stack(out)
