"""Synthetic large-scale problem generators: the scale workloads.

* :func:`multi_loop_controls` — a closed circuit repeated until the step
  count, so every lap re-observes the same landmarks;
* :func:`make_large_problem` — a ~10k-pose / ~10k-landmark block-sparse
  problem built directly as arrays (no ray casting): a serpentine path over
  a large arena, each pose observing its K nearest landmarks of a jittered
  grid.

Host numpy in float64 with a seeded ``np.random.default_rng``, exactly as
``toyslam_tpu.sim.synthetic``, so both packages build the same graph bit for
bit.  The graph comes back on the CPU; move it with ``graph.to(device)``.
"""

from __future__ import annotations

import math

import numpy as np

from toyslam_torch.config import NoiseConfig
from toyslam_torch.models.graph import FactorGraph2D, GraphBuilder2D


def multi_loop_controls(
    num_steps: int, step_len: float = 0.7, loop_steps: int = 150
) -> np.ndarray:
    """A circular circuit of ``loop_steps`` poses repeated until
    ``num_steps``: constant (dx, 0, 2*pi/loop_steps)."""
    dth = 2.0 * math.pi / loop_steps
    out = np.zeros((num_steps, 3), np.float32)
    out[:, 0] = step_len
    out[:, 2] = dth
    return out


def _integrate(start, controls):
    out = np.empty((controls.shape[0] + 1, 3), np.float64)
    out[0] = start
    x, y, th = start
    for k, (dx, dy, dth) in enumerate(controls):
        c, s = np.cos(th), np.sin(th)
        x, y = x + c * dx - s * dy, y + s * dx + c * dy
        th = np.arctan2(np.sin(th + dth), np.cos(th + dth))
        out[k + 1] = (x, y, th)
    return out


def _relative_controls(poses: np.ndarray) -> np.ndarray:
    """Odometry controls (dx, dy, dtheta in the source frame) between
    consecutive poses — the inverse of :func:`_integrate`."""
    p, q = poses[:-1], poses[1:]
    c, s = np.cos(p[:, 2]), np.sin(p[:, 2])
    ex = q[:, 0] - p[:, 0]
    ey = q[:, 1] - p[:, 1]
    return np.stack(
        [
            c * ex + s * ey,
            -s * ex + c * ey,
            np.arctan2(np.sin(q[:, 2] - p[:, 2]),
                       np.cos(q[:, 2] - p[:, 2])),
        ],
        axis=1,
    )


def _knn_obs_brute(pos_xy: np.ndarray, lms: np.ndarray, k: int):
    """Exact K-nearest landmarks per pose, chunked to bound memory."""
    num_poses = pos_xy.shape[0]
    obs_pose, obs_lm = [], []
    chunk = 512
    for s in range(0, num_poses, chunk):
        block = pos_xy[s : s + chunk]
        d2 = (
            np.sum(block**2, axis=1)[:, None]
            - 2.0 * block @ lms.T
            + np.sum(lms**2, axis=1)[None, :]
        )
        idx = np.argpartition(d2, k, axis=1)[:, :k]
        obs_pose.append(np.repeat(np.arange(s, s + block.shape[0]), k))
        obs_lm.append(idx.ravel())
    return np.concatenate(obs_pose), np.concatenate(obs_lm)


def _knn_obs_cells(pos_xy: np.ndarray, lms: np.ndarray, k: int, lo, hi):
    """K-nearest via a landmark cell hash (5x5-cell candidate windows)."""
    num_poses = pos_xy.shape[0]
    m = lms.shape[0]
    span = np.maximum(hi - lo, 1e-9)
    # ~2 landmark spacings per cell => >= ~4 landmarks/cell on average
    spacing = float(np.sqrt(span[0] * span[1] / m))
    cell = 2.0 * spacing
    nx = max(int(span[0] / cell) + 1, 1)
    ny = max(int(span[1] / cell) + 1, 1)
    cxy = np.clip(
        ((lms - lo[None, :]) / cell).astype(np.int64), 0, [nx - 1, ny - 1]
    )
    key = cxy[:, 0] * ny + cxy[:, 1]
    order = np.argsort(key, kind="stable")
    skey = key[order]
    counts = np.bincount(skey, minlength=nx * ny)
    kc = int(counts.max())
    table = np.full((nx * ny, kc), -1, np.int64)
    starts = np.searchsorted(skey, np.arange(nx * ny))
    slots = np.arange(m) - starts[skey]
    table[skey, slots] = order
    pc = np.clip(
        ((pos_xy - lo[None, :]) / cell).astype(np.int64),
        2, [nx - 3, ny - 3],
    )
    obs_pose, obs_lm = [], []
    chunk = 4096
    offs = [(dx, dy) for dx in range(-2, 3) for dy in range(-2, 3)]
    big = np.float64(1e30)
    for s in range(0, num_poses, chunk):
        p = pos_xy[s : s + chunk]
        c = pc[s : s + chunk]
        cand = np.concatenate(
            [table[(c[:, 0] + dx) * ny + (c[:, 1] + dy)]
             for dx, dy in offs],
            axis=1,
        )                                           # [B, 25*kc]
        valid = cand >= 0
        safe = np.where(valid, cand, 0)
        d2 = np.sum((lms[safe] - p[:, None, :]) ** 2, axis=2)
        d2 = np.where(valid, d2, big)
        idx = np.argpartition(d2, k, axis=1)[:, :k]
        obs_pose.append(np.repeat(np.arange(s, s + p.shape[0]), k))
        obs_lm.append(np.take_along_axis(safe, idx, axis=1).ravel())
    return np.concatenate(obs_pose), np.concatenate(obs_lm)


def make_large_problem(
    num_poses: int = 10_000,
    num_landmarks: int = 10_000,
    obs_per_pose: int = 6,
    seed: int = 0,
    noise: NoiseConfig | None = None,
    pose_bucket: int = 512,
    landmark_bucket: int = 512,
    edge_bucket: int = 4096,
    laps: int = 1,
) -> tuple[FactorGraph2D, np.ndarray, np.ndarray]:
    """Returns ``(graph, poses_gt, landmarks_gt)``.

    Trajectory: a serpentine sweep across an arena sized so landmark
    density stays constant; landmarks: a jittered grid.  Observations: the
    K nearest landmarks per pose as noisy (range, bearing); an odometry
    chain with noise.  Landmark indices are remapped to first-seen dense
    order, and only observed landmarks become vertices.

    ``laps > 1`` repeats the sweep, so every lap re-observes the same
    landmarks; ``num_poses`` stays the total pose count.
    """
    noise = noise or NoiseConfig()
    rng = np.random.default_rng(seed)
    lidar_scale, pos_scale, ang_scale = noise.sample_scales()
    arena = math.sqrt(num_landmarks) * 2.0  # ~2 units landmark spacing

    lap_poses = max(2, num_poses // laps)

    # serpentine ground-truth path (one lap)
    rows = max(2, int(math.sqrt(lap_poses) / 1.4))
    per_row = lap_poses // rows
    step = arena / max(per_row, 1)
    controls = np.zeros((lap_poses - 1, 3), np.float64)
    k = 0
    for r in range(rows):
        for c in range(per_row - 1):
            if k >= lap_poses - 1:
                break
            controls[k] = (step, 0.0, 0.0)
            k += 1
        # u-turn: two 90-degree turns, direction alternating per row so the
        # sweep advances
        turn = math.pi / 2.0 if r % 2 == 0 else -math.pi / 2.0
        for _ in range(2):
            if k >= lap_poses - 1:
                break
            controls[k] = (arena / rows / 2.0, 0.0, turn)
            k += 1
    while k < lap_poses - 1:
        controls[k] = (step, 0.0, 0.0)
        k += 1

    start = np.array([0.0, 0.0, 0.0])
    poses_gt = _integrate(start, controls)
    if laps > 1:
        # revisit sweep: repeat the lap path and re-derive the full control
        # chain from the stacked ground truth
        poses_gt = np.concatenate([poses_gt] + [poses_gt] * (laps - 1))
        controls = _relative_controls(poses_gt)
    num_poses = poses_gt.shape[0]

    # landmark grid with jitter, spanning the trajectory's bounding box
    g = int(math.ceil(math.sqrt(num_landmarks)))
    lo = poses_gt[:, :2].min(axis=0) - 2.0
    hi = poses_gt[:, :2].max(axis=0) + 2.0
    gx, gy = np.meshgrid(
        np.linspace(lo[0], hi[0], g), np.linspace(lo[1], hi[1], g)
    )
    lms_gt = np.stack([gx.ravel(), gy.ravel()], axis=1)[:num_landmarks]
    lms_gt = lms_gt + rng.normal(0, 0.3, lms_gt.shape)

    # K nearest landmarks per pose
    if num_landmarks > 20_000:
        # cell-hash candidate search: brute force is O(P*M) distance rows;
        # a 5x5-cell window around each pose holds the K nearest of a
        # jittered grid
        obs_pose, obs_lm = _knn_obs_cells(
            poses_gt[:, :2], lms_gt, obs_per_pose, lo, hi
        )
    else:
        obs_pose, obs_lm = _knn_obs_brute(
            poses_gt[:, :2], lms_gt, obs_per_pose
        )

    # noisy measurements
    dp = lms_gt[obs_lm] - poses_gt[obs_pose, :2]
    rng_gt = np.linalg.norm(dp, axis=1)
    bear_gt = np.arctan2(dp[:, 1], dp[:, 0]) - poses_gt[obs_pose, 2]
    local = np.stack(
        [rng_gt * np.cos(bear_gt), rng_gt * np.sin(bear_gt)], axis=1
    )
    local = local + rng.normal(0, lidar_scale, local.shape)
    meas = np.stack(
        [np.linalg.norm(local, axis=1), np.arctan2(local[:, 1], local[:, 0])],
        axis=1,
    )

    odom_meas = controls + rng.normal(
        0, [pos_scale, pos_scale, ang_scale], controls.shape
    )
    poses_dr = _integrate(start, odom_meas)

    odom_info = np.diag(noise.odom_information_diag()).astype(np.float32)
    lm_info = np.diag(noise.lidar_information_diag()).astype(np.float32)

    b = GraphBuilder2D(
        pose_bucket=pose_bucket,
        landmark_bucket=landmark_bucket,
        edge_bucket=edge_bucket,
    )
    for t in range(num_poses):
        b.add_pose(poses_dr[t], fixed=(t == 0))
    for t in range(num_poses - 1):
        b.add_odom_edge(t, t + 1, odom_meas[t], odom_info)

    # landmark initial estimates: first observation through the noisy pose
    c = np.cos(poses_dr[obs_pose, 2])
    s_ = np.sin(poses_dr[obs_pose, 2])
    glob = np.stack(
        [
            poses_dr[obs_pose, 0] + c * local[:, 0] - s_ * local[:, 1],
            poses_dr[obs_pose, 1] + s_ * local[:, 0] + c * local[:, 1],
        ],
        axis=1,
    )
    for e in range(obs_pose.shape[0]):
        b.add_landmark(int(obs_lm[e]), glob[e])
        b.add_landmark_edge(int(obs_pose[e]), int(obs_lm[e]), meas[e], lm_info)

    lm_gt_used = np.stack(
        [lms_gt[oid] for oid in b.landmark_id_map.keys()]
    ) if b.num_landmarks else np.zeros((0, 2))
    return b.build(), poses_gt.astype(np.float32), lm_gt_used.astype(np.float32)
