"""Synthetic SE(3) bundle-adjustment workloads: a camera ring orbiting a box
of 3D points, pinhole reprojection observations with pixel noise, and a
noisy odometry chain for the initial guess.

Host-side numpy, seeded with ``np.random.default_rng``: the same calls in
the same order as ``toyslam_tpu.sim.synthetic3d``, so a seed gives the
JAX package's graph bit for bit.  The graph comes back on the CPU; move it
with ``graph.to(device)``.
"""

from __future__ import annotations

import math

import numpy as np

from toyslam_torch.models.graph3d import FactorGraph3D, GraphBuilder3D


def _look_at(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Camera-to-world rotation with +z looking at ``target``, row-major."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(fwd, up)) > 0.99:
        up = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    # columns are the camera axes (x=right, y=down, z=forward) in world
    return np.stack([right, down, fwd], axis=1)


def _flat(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    return np.concatenate([R.reshape(9), t])


def _exp_so3(w: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-9:
        return np.eye(3) + K
    return (np.eye(3) + math.sin(th) / th * K
            + (1.0 - math.cos(th)) / th**2 * (K @ K))


def make_ba_problem(
    num_poses: int = 64,
    num_landmarks: int = 256,
    obs_per_pose: int = 24,
    seed: int = 0,
    pixel_std: float = 1.0,
    odom_t_std: float = 0.05,
    odom_r_std: float = 0.01,
    intrinsics=(500.0, 500.0, 320.0, 240.0),
    radius: float = 8.0,
) -> tuple[FactorGraph3D, np.ndarray, np.ndarray]:
    """Returns ``(graph, poses_gt [P, 12], landmarks_gt [L, 3])``.

    Cameras on a ring of ``radius`` at varying height, all looking at the
    origin; landmarks uniform in a centered box.  The initial poses
    integrate the noisy odometry chain from the true first pose (fixed: the
    gauge); each landmark starts at its true position plus noise, taken
    when it is first seen.
    """
    rng = np.random.default_rng(seed)
    fx, fy, cx, cy = intrinsics
    lms_gt = rng.uniform(-3.0, 3.0, size=(num_landmarks, 3))

    poses_gt = []
    for k in range(num_poses):
        ang = 2.0 * math.pi * k / num_poses
        eye = np.array([radius * math.cos(ang), radius * math.sin(ang),
                        1.5 + math.sin(2 * ang)])
        poses_gt.append(_flat(_look_at(eye, np.zeros(3)), eye))
    poses_gt = np.stack(poses_gt)

    def inv(p):
        R, t = p[:9].reshape(3, 3), p[9:]
        return _flat(R.T, -R.T @ t)

    def comp(a, b):
        Ra, ta = a[:9].reshape(3, 3), a[9:]
        Rb, tb = b[:9].reshape(3, 3), b[9:]
        return _flat(Ra @ Rb, ta + Ra @ tb)

    # noisy odometry chain: meas_k = T_k^-1 T_{k+1} . noise
    odom_meas = []
    for k in range(num_poses - 1):
        rel = comp(inv(poses_gt[k]), poses_gt[k + 1])
        dR = _exp_so3(rng.normal(scale=odom_r_std, size=3))
        dt = rng.normal(scale=odom_t_std, size=3)
        odom_meas.append(comp(rel, _flat(dR, dt)))

    init = [poses_gt[0]]
    for k in range(num_poses - 1):
        init.append(comp(init[-1], odom_meas[k]))
    init = np.stack(init)

    builder = GraphBuilder3D(intrinsics=intrinsics)
    for k in range(num_poses):
        builder.add_pose(init[k], fixed=(k == 0))
    info6 = np.diag(
        [1.0 / odom_t_std**2] * 3 + [1.0 / odom_r_std**2] * 3
    ).astype(np.float32)
    for k in range(num_poses - 1):
        builder.add_odom_edge(k, k + 1, odom_meas[k], info6)

    info2 = np.eye(2, dtype=np.float32) / pixel_std**2
    seen: set[int] = set()
    for k in range(num_poses):
        R, t = poses_gt[k, :9].reshape(3, 3), poses_gt[k, 9:]
        x_c = (lms_gt - t) @ R   # R^T (X - t) for all landmarks
        z = x_c[:, 2]
        u = fx * x_c[:, 0] / np.maximum(z, 1e-6) + cx
        v = fy * x_c[:, 1] / np.maximum(z, 1e-6) + cy
        visible = (z > 0.5) & (u > 0) & (u < 2 * cx) & (v > 0) & (v < 2 * cy)
        ids = np.nonzero(visible)[0]
        if ids.size > obs_per_pose:
            ids = rng.choice(ids, size=obs_per_pose, replace=False)
        for lm_id in ids:
            if lm_id not in seen:
                seen.add(int(lm_id))
                builder.add_landmark(
                    int(lm_id), lms_gt[lm_id] + rng.normal(scale=0.2, size=3))
            uv = np.array([u[lm_id], v[lm_id]]) + rng.normal(
                scale=pixel_std, size=2)
            builder.add_reproj_edge(k, int(lm_id), uv, info2)

    graph = builder.build()
    # ground-truth landmarks in the builder's first-seen dense order
    order = sorted(builder.landmark_id_map, key=builder.landmark_id_map.get)
    lms_gt_dense = lms_gt[np.asarray(order, dtype=np.int64)]
    return graph, poses_gt.astype(np.float32), lms_gt_dense.astype(np.float32)


def pose_ate_rmse(est_flat: np.ndarray, gt_flat: np.ndarray) -> float:
    """Translation ATE RMSE between ``[P, 12]`` pose sets."""
    d = est_flat[:, 9:12] - gt_flat[:, 9:12]
    return float(np.sqrt(np.mean(np.sum(d * d, axis=-1))))
