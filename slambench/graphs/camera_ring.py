"""SE(3) bundle adjustment: a ring of cameras around a box of 3D points,
pinhole reprojection observations with pixel noise, and a noisy
relative-pose chain that gives the initial camera poses.

A frozen NumPy copy of the port's
``toyslam_torch/sim/synthetic3d.py::make_ba_problem`` with its
``GraphBuilder3D`` padding: the same random draws in the same order, so one
seed gives the arrays the port's generator gives
(``tests/test_torch_ba_plain_reference.py`` holds them equal).  The graph
comes back as the keyword arguments of
``toyslam_torch.models.graph3d.graph3d_from_numpy`` plus the counts of real
vertices and the true poses and points; this module imports nothing of the
program.

* cameras on a ring of ``radius`` at heights ``1.5 + sin(2 angle)``, each
  looking at the origin (+z forward, +y down), pose 0 fixed (the gauge);
* points uniform in ``[-3, 3]^3``, each starting at its true position plus
  0.2 of noise, taken when it is first seen;
* each camera observes up to ``obs_per_pose`` of the points in front of it
  and inside the image, drawn at random, with ``pixel_std`` of noise;
* relative-pose edges ``T_k^-1 T_{k+1}`` times a noise transform
  (rotation ``odom_r_std``, translation ``odom_t_std``), information the
  inverse variances; the initial poses integrate them from the true first
  pose;
* with ``near_plane``, the cameras' intrinsics carry it as a fifth entry
  (``fx, fy, cx, cy, near``): the depth the program's and the reference's
  projections are clamped at (``make_ba_problem`` gives none: 1e-6).
"""

from __future__ import annotations

import math

import numpy as np

# GraphBuilder3D's buckets: poses, points, edges
BUCKETS = (64, 64, 256)


def _look_at(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(fwd, up)) > 0.99:
        up = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
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


def _inv(p):
    R, t = p[:9].reshape(3, 3), p[9:]
    return _flat(R.T, -R.T @ t)


def _comp(a, b):
    Ra, ta = a[:9].reshape(3, 3), a[9:]
    Rb, tb = b[:9].reshape(3, 3), b[9:]
    return _flat(Ra @ Rb, ta + Ra @ tb)


def _bucket(n: int, bucket: int) -> int:
    return max(bucket, -(-n // bucket) * bucket)


def _edges(edges: list, meas_dim: int, info_dim: int, bucket: int):
    """``(i, j, meas, info, mask)`` padded to the bucket; padded
    relative-pose measurements are identity transforms."""
    e = len(edges)
    ep = _bucket(e, bucket)
    i = np.zeros(ep, np.int64)
    j = np.zeros(ep, np.int64)
    meas = np.zeros((ep, meas_dim), np.float32)
    info = np.zeros((ep, info_dim, info_dim), np.float32)
    mask = np.zeros(ep, np.float32)
    if meas_dim == 12:
        meas[:, 0] = meas[:, 4] = meas[:, 8] = 1.0
    if e:
        i[:e] = [x[0] for x in edges]
        j[:e] = [x[1] for x in edges]
        meas[:e] = np.stack([x[2] for x in edges])
        info[:e] = np.stack([x[3] for x in edges])
        mask[:e] = 1.0
    return (i, j, meas, info, mask)


def generate(seed: int, num_poses: int, num_landmarks: int,
             obs_per_pose: int, pixel_std: float = 1.0,
             odom_t_std: float = 0.05, odom_r_std: float = 0.01,
             intrinsics=(500.0, 500.0, 320.0, 240.0), radius: float = 8.0,
             buckets=BUCKETS, near_plane: float | None = None) -> dict:
    """The camera ring's graph: ``{"graph": arrays, "n_poses",
    "n_landmarks", "poses_gt" [P, 12], "landmarks_gt" [L, 3]}`` (the true
    points in the graph's first-seen order)."""
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

    odom_meas = []
    for k in range(num_poses - 1):
        rel = _comp(_inv(poses_gt[k]), poses_gt[k + 1])
        dR = _exp_so3(rng.normal(scale=odom_r_std, size=3))
        dt = rng.normal(scale=odom_t_std, size=3)
        odom_meas.append(_comp(rel, _flat(dR, dt)))
    init = [poses_gt[0]]
    for k in range(num_poses - 1):
        init.append(_comp(init[-1], odom_meas[k]))
    init = np.stack(init)

    info6 = np.diag([1.0 / odom_t_std**2] * 3
                    + [1.0 / odom_r_std**2] * 3).astype(np.float32)
    odom = [(k, k + 1, np.asarray(odom_meas[k], np.float32), info6)
            for k in range(num_poses - 1)]

    info2 = np.eye(2, dtype=np.float32) / pixel_std**2
    dense: dict = {}            # point id -> index in first-seen order
    points, reproj = [], []
    for k in range(num_poses):
        R, t = poses_gt[k, :9].reshape(3, 3), poses_gt[k, 9:]
        x_c = (lms_gt - t) @ R
        z = x_c[:, 2]
        u = fx * x_c[:, 0] / np.maximum(z, 1e-6) + cx
        v = fy * x_c[:, 1] / np.maximum(z, 1e-6) + cy
        visible = (z > 0.5) & (u > 0) & (u < 2 * cx) & (v > 0) & (v < 2 * cy)
        ids = np.nonzero(visible)[0]
        if ids.size > obs_per_pose:
            ids = rng.choice(ids, size=obs_per_pose, replace=False)
        for lm_id in ids:
            lm_id = int(lm_id)
            if lm_id not in dense:
                dense[lm_id] = len(points)
                points.append(np.asarray(
                    lms_gt[lm_id] + rng.normal(scale=0.2, size=3),
                    np.float32))
            uv = np.array([u[lm_id], v[lm_id]]) + rng.normal(
                scale=pixel_std, size=2)
            reproj.append((k, dense[lm_id], np.asarray(uv, np.float32),
                           info2))

    pb, lb, eb = buckets
    n, m = num_poses, len(points)
    np_, mp = _bucket(n, pb), _bucket(m, lb)
    poses = np.zeros((np_, 12), np.float32)
    poses[:, 0] = poses[:, 4] = poses[:, 8] = 1.0     # padded: identity
    poses[:n] = init.astype(np.float32)
    landmarks = np.zeros((mp, 3), np.float32)
    if m:
        landmarks[:m] = np.stack(points)
    pose_mask = np.zeros(np_, np.float32)
    pose_mask[:n] = 1.0
    lm_mask = np.zeros(mp, np.float32)
    lm_mask[:m] = 1.0
    pose_fixed = np.zeros(np_, np.float32)
    pose_fixed[0] = 1.0
    graph = dict(
        poses=poses, landmarks=landmarks, pose_mask=pose_mask,
        lm_mask=lm_mask, pose_fixed=pose_fixed,
        lm_fixed=np.zeros(mp, np.float32),
        odom=_edges(odom, 12, 6, eb), lm_edges=_edges(reproj, 2, 2, eb),
        intrinsics=np.asarray(tuple(intrinsics) + (
            () if near_plane is None else (near_plane,)), np.float32))
    order = sorted(dense, key=dense.get)
    return {"graph": graph, "n_poses": n, "n_landmarks": m,
            "poses_gt": poses_gt.astype(np.float32),
            "landmarks_gt": lms_gt[np.asarray(order, np.int64)].astype(
                np.float32)}
