"""Synthetic point-obstacle environment (host numpy).

A rectangular outer wall, an inner L-shaped wall block and three
free-standing obstacles — 422 points, each a circle of radius 0.25.  The
same map as ``toyslam_tpu.sim.environment.load_environment``, and its
occupancy-grid variant.
"""

from __future__ import annotations

import numpy as np


def load_environment(scale: float = 1.0) -> tuple[np.ndarray, float]:
    """Returns ``(points [P, 2] float32, radius)``."""
    size = 30
    wall = 4
    center = np.array([size, size], dtype=np.float64)

    def strip(xs, ys):
        xs = np.atleast_1d(np.asarray(xs, np.float64))
        ys = np.atleast_1d(np.asarray(ys, np.float64))
        xs, ys = np.broadcast_arrays(xs, ys)
        return np.stack([xs, ys], axis=1) + center

    segments = [
        # outer walls: top & bottom span 2x the arena, sides span it once
        strip(np.arange(-2 * size, 2 * size), size),
        strip(np.arange(-2 * size, 2 * size), -size),
        strip(-size, np.arange(-size, size)),
        strip(size, np.arange(-size, size)),
        # inner block (an almost-closed square room in the top-right)
        strip(np.arange(0, size - wall), size - wall),
        strip(0, np.arange(size - (wall - 1), size)),
        strip(size - wall, np.arange(0, size - (wall - 1))),
        strip(np.arange(size - (wall - 1), size), 0),
    ]
    free = np.array([[10.0, 10.0], [10.0, 25.0], [22.0, 28.0]])
    pts = np.concatenate(segments + [free], axis=0) / scale
    return pts.astype(np.float32), 0.25 / scale


def load_environment_grid(
    shape: tuple[int, int] = (21, 21)
) -> tuple[np.ndarray, tuple[int, ...]]:
    """Occupancy-grid variant of the map: a border of occupied cells.
    Returns ``(grid [H, W] float32, shape)``; 1.0 marks an occupied cell."""
    grid = np.zeros(shape, np.float32)
    grid[:, 0] = 1.0
    grid[:, -1] = 1.0
    grid[0, :] = 1.0
    grid[-1, :] = 1.0
    return grid, shape


def grid_to_points(
    grid: np.ndarray, cell: float = 1.0, radius: float = 0.25
) -> tuple[np.ndarray, float]:
    """Occupied grid cells as point obstacles, for the point-based LiDAR
    simulator (``sim/lidar.py``)."""
    ys, xs = np.nonzero(grid > 0.5)
    pts = np.stack([xs, ys], axis=1).astype(np.float32) * cell
    return pts, radius
