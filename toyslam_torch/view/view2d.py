"""2D SLAM visualization (the views of ``toyslam_tpu.view.view2d``).

* :class:`View`: shared figure, environment scatter and grid;
* :class:`RobotStateView`: robot position dot, heading segment, lidar FOV
  wedge and the current scan transformed to world coordinates;
* :class:`FootprintView2d`: trajectory trail;
* :class:`GraphView2d`: optimized poses (orange), landmark map (blue),
  per-pose heading ticks, cleared and rebuilt on every update;
* :func:`render_result`: one-call offline render of a finished run
  (ground truth vs dead reckoning vs optimized), savable headless.

All views consume host snapshots of the state: numpy arrays, or tensors on
any device, which are read back first.  They work the same live, offline,
and under tests with the Agg backend.
"""

from __future__ import annotations

import math
from typing import Optional

import matplotlib.pyplot as plt
import numpy as np

from toyslam_torch.models.graph import to_numpy as _np


def _heading_segment(pose, length=0.8):
    x, y, th = pose[0], pose[1], pose[2]
    return [x, x + length * math.cos(th)], [y, y + length * math.sin(th)]


class View:
    """Shared figure/axes with the environment rendered once."""

    def __init__(
        self,
        env: Optional[np.ndarray] = None,
        radius: float = 0.25,
        figsize=(9, 9),
        title: str = "toyslam_torch",
    ):
        self.fig, self.ax = plt.subplots(figsize=figsize)
        self.ax.set_aspect("equal")
        self.ax.grid(True, alpha=0.3)
        self.ax.set_title(title)
        if env is not None:
            env = _np(env)
            self.ax.scatter(
                env[:, 0], env[:, 1], s=(radius * 40) ** 2 / 4,
                c="dimgray", alpha=0.6, label="environment",
            )

    def legend(self):
        self.ax.legend(loc="upper right", fontsize=8)

    def draw(self):
        self.fig.canvas.draw_idle()

    def pause(self, dt: float = 0.001):
        plt.pause(dt)

    def save(self, path: str, dpi: int = 120):
        self.fig.savefig(path, dpi=dpi, bbox_inches="tight")

    def close(self):
        plt.close(self.fig)

    @property
    def open(self) -> bool:
        return plt.fignum_exists(self.fig.number)


class RobotStateView:
    """Current robot state: dot, heading, FOV wedge, world-frame scan."""

    def __init__(self, view: View, fov: float, color="tab:red",
                 label="robot (est)"):
        self.view = view
        self.fov = fov
        (self._dot,) = view.ax.plot([], [], "o", c=color, ms=8, label=label)
        (self._heading,) = view.ax.plot([], [], "-", c=color, lw=2)
        (self._fov_l,) = view.ax.plot([], [], ":", c=color, lw=1, alpha=0.6)
        (self._fov_r,) = view.ax.plot([], [], ":", c=color, lw=1, alpha=0.6)
        self._scan = view.ax.scatter([], [], s=8, c=color, alpha=0.5)

    def update(self, pose, scan_xy: Optional[np.ndarray] = None,
               fov_range: float = 5.0):
        x, y, th = float(pose[0]), float(pose[1]), float(pose[2])
        self._dot.set_data([x], [y])
        hx, hy = _heading_segment((x, y, th))
        self._heading.set_data(hx, hy)
        for line, sign in ((self._fov_l, 0.5), (self._fov_r, -0.5)):
            a = th + sign * self.fov
            line.set_data(
                [x, x + fov_range * math.cos(a)],
                [y, y + fov_range * math.sin(a)],
            )
        if scan_xy is not None and len(scan_xy):
            c, s = math.cos(th), math.sin(th)
            world = _np(scan_xy) @ np.array([[c, s], [-s, c]])
            world = world + np.array([x, y])
            self._scan.set_offsets(world)


class FootprintView2d:
    """Trajectory trail (growing polyline)."""

    def __init__(self, view: View, color="tab:green", label="ground truth"):
        self.view = view
        (self._line,) = view.ax.plot([], [], "-", c=color, lw=1.5,
                                     alpha=0.8, label=label)

    def update(self, poses: np.ndarray):
        poses = _np(poses)
        self._line.set_data(poses[:, 0], poses[:, 1])


class GraphView2d:
    """Optimized graph: poses (orange) + heading ticks, landmarks (blue)."""

    def __init__(self, view: View, tick: float = 0.5):
        self.view = view
        self.tick = tick
        (self._poses,) = view.ax.plot(
            [], [], "o-", c="tab:orange", ms=3, lw=1,
            label="optimized poses",
        )
        self._lms = view.ax.scatter(
            [], [], s=14, c="tab:blue", marker="x", label="landmarks (est)"
        )
        self._ticks = None

    def update(
        self,
        poses: np.ndarray,
        landmarks: np.ndarray,
        pose_mask: Optional[np.ndarray] = None,
        lm_mask: Optional[np.ndarray] = None,
    ):
        poses = _np(poses)
        landmarks = _np(landmarks)
        if pose_mask is not None:
            poses = poses[_np(pose_mask) > 0]
        if lm_mask is not None:
            landmarks = landmarks[_np(lm_mask) > 0]
        self._poses.set_data(poses[:, 0], poses[:, 1])
        if len(landmarks):
            self._lms.set_offsets(landmarks[:, :2])
        # quiver artists cannot grow; rebuild per update
        if self._ticks is not None:
            self._ticks.remove()
        self._ticks = self.view.ax.quiver(
            poses[:, 0], poses[:, 1],
            self.tick * np.cos(poses[:, 2]), self.tick * np.sin(poses[:, 2]),
            angles="xy", scale_units="xy", scale=1,
            color="tab:orange", width=0.002, alpha=0.7,
        )


def render_result(
    env: np.ndarray,
    radius: float,
    poses_gt: np.ndarray,
    poses_dr: np.ndarray,
    poses_opt: np.ndarray,
    landmarks: Optional[np.ndarray] = None,
    save_path: Optional[str] = None,
    title: str = "toyslam_torch: GT vs dead reckoning vs optimized",
) -> View:
    """Offline render of a finished run: green ground truth, red dead
    reckoning, orange optimized."""
    view = View(env=env, radius=radius, title=title)
    FootprintView2d(view, color="tab:green", label="ground truth").update(
        poses_gt
    )
    FootprintView2d(view, color="tab:red", label="dead reckoning").update(
        poses_dr
    )
    gv = GraphView2d(view)
    gv.update(
        _np(poses_opt),
        landmarks if landmarks is not None else np.zeros((0, 2)),
    )
    view.legend()
    if save_path:
        view.save(save_path)
    return view
