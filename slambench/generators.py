"""The benchmark's traffic generators: frozen copies of the port's graph
generators, in plain NumPy.

Two generators, each the ``generate`` of a graph kind's file
(``graphs/<kind>.py``, picked by a configuration's ``graph.kind``):

* ``"robot"``: the upstream ToySlam deployment.  A scripted robot drives
  through a 422-point obstacle map and scans it with a 2D LiDAR; the
  graph holds the dead-reckoned poses, the noisy odometry steps and one
  range-bearing edge per ray that hit an obstacle (a copy of the port's
  ``sim/environment.py``, ``sim/trajectory.py``, ``sim/lidar.py`` and
  ``sim/frontend.py::simulate`` + ``build_graph``);
* ``"serpentine"``: a serpentine sweep over a jittered landmark grid, each
  pose observing its K nearest landmarks (a copy of the port's
  ``sim/synthetic.py::make_large_problem``).

Both draw every random number from ``np.random.default_rng(seed)`` in the
port's order, so one seed gives the arrays the port's own generators give
(``slambench/tests/test_slambench_generators.py`` holds them equal).  The
graph comes back as the keyword arguments of
``toyslam_torch.models.graph.graph_from_numpy`` (padded to the port's
buckets) plus the counts of real vertices; this module imports nothing of
the program.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

from slambench import cells

# the port's NoiseConfig defaults, with the upstream simulator's quirk of
# feeding variances where the sampler expects standard deviations
LIDAR_STD = 0.15
POSITION_STD = 0.5
ORIENTATION_STD = math.radians(7.1)
SAMPLE_SCALES = (LIDAR_STD**2, POSITION_STD**2, ORIENTATION_STD**2)
ODOM_INFO = np.diag([1.0 / POSITION_STD**2, 1.0 / POSITION_STD**2,
                     1.0 / ORIENTATION_STD**2]).astype(np.float32)
LM_INFO = np.diag([1.0 / LIDAR_STD**2] * 2).astype(np.float32)

# (pose-id upper bound, forward step, turn degrees): the scripted robot
_SCHEDULE = [(10, 2.0, 3.0), (20, 0.9, 6.0), (40, 0.9, -6.0),
             (60, 0.8, 5.0), (10**9, 0.7, 3.0)]


def environment() -> tuple[np.ndarray, float]:
    """The upstream map: outer walls, an inner L-shaped block and three
    free obstacles, 422 points of radius 0.25."""
    size, wall = 30, 4
    center = np.array([size, size], dtype=np.float64)

    def strip(xs, ys):
        xs, ys = np.broadcast_arrays(np.atleast_1d(np.asarray(xs, np.float64)),
                                     np.atleast_1d(np.asarray(ys, np.float64)))
        return np.stack([xs, ys], axis=1) + center

    segments = [
        strip(np.arange(-2 * size, 2 * size), size),
        strip(np.arange(-2 * size, 2 * size), -size),
        strip(-size, np.arange(-size, size)),
        strip(size, np.arange(-size, size)),
        strip(np.arange(0, size - wall), size - wall),
        strip(0, np.arange(size - (wall - 1), size)),
        strip(size - wall, np.arange(0, size - (wall - 1))),
        strip(np.arange(size - (wall - 1), size), 0),
    ]
    free = np.array([[10.0, 10.0], [10.0, 25.0], [22.0, 28.0]])
    pts = np.concatenate(segments + [free], axis=0)
    return pts.astype(np.float32), 0.25


def scripted_controls(num_steps: int) -> np.ndarray:
    out = np.zeros((num_steps, 3), np.float32)
    for k in range(num_steps):
        for bound, dx, deg in _SCHEDULE:
            if k < bound:
                out[k] = (dx, 0.0, math.radians(deg))
                break
    return out


def integrate(start: np.ndarray, controls: np.ndarray) -> np.ndarray:
    """Sequential float64 SE(2) compose: ``[T+1, 3]`` poses."""
    out = np.empty((controls.shape[0] + 1, 3), np.float64)
    out[0] = start
    x, y, th = start
    for k, (dx, dy, dth) in enumerate(controls):
        c, s = np.cos(th), np.sin(th)
        x, y = x + c * dx - s * dy, y + s * dx + c * dy
        th = np.arctan2(np.sin(th + dth), np.cos(th + dth))
        out[k + 1] = (x, y, th)
    return out


def scan(poses, env, radius: float, fov: float, ray_count: int):
    """Ray-circle LiDAR from every pose: ``(meas [T, R, 2], ids [T, R],
    valid [T, R])``; the bearing is that of the hit obstacle's centre."""
    poses = np.asarray(poses, np.float64)
    env = np.asarray(env, np.float64)
    origin, theta = poses[:, :2], poses[:, 2]
    rel = np.linspace(-0.5 * fov, 0.5 * fov, ray_count)
    ang = theta[:, None] + rel[None, :]
    dirs = np.stack([np.cos(ang), np.sin(ang)], axis=-1)
    oc = env[None, :, :] - origin[:, None, :]
    tca = np.einsum("trd,tpd->trp", dirs, oc)
    d2 = np.sum(oc * oc, axis=-1)[:, None, :] - tca**2
    r2 = radius * radius
    thc = np.sqrt(np.maximum(r2 - d2, 0.0))
    t0, t1 = tca - thc, tca + thc
    t = np.where(t0 < 0.0, t1, t0)
    hit = (d2 <= r2) & (t1 >= 0.0)
    t = np.where(hit, t, 1e9)
    best = np.argmin(t, axis=2)
    t_best = np.take_along_axis(t, best[..., None], axis=2)[..., 0]
    valid = t_best < 1e9
    to_c = env[best] - origin[:, None, :]
    bearing = np.arctan2(to_c[..., 1], to_c[..., 0]) - theta[:, None]
    bearing = np.arctan2(np.sin(bearing), np.cos(bearing))
    meas = np.where(valid[..., None], np.stack([t_best, bearing], -1), 0.0)
    return (meas.astype(np.float32), np.where(valid, best, -1).astype(np.int32),
            valid)


def _bucket(n: int, bucket: int) -> int:
    return max(bucket, -(-n // bucket) * bucket)


def _pack(poses, landmarks, odom, lm_edges, buckets) -> dict:
    """The padded arrays of the port's ``GraphBuilder2D.build``: pose 0
    gauge-fixed, no landmark fixed.  ``odom = (i, j, meas)``, ``lm_edges =
    (pose, lm, meas)``, each real edge carrying the noise model's
    information matrix."""
    pb, lb, eb = buckets
    n, m = poses.shape[0], landmarks.shape[0]
    np_, mp = _bucket(n, pb), _bucket(m, lb)

    def pad(a, rows):
        out = np.zeros((rows,) + a.shape[1:], a.dtype)
        out[: a.shape[0]] = a
        return out

    def edges(i, j, meas, info):
        e = i.shape[0]
        ep = _bucket(e, eb)
        mask = np.zeros(ep, np.float32)
        mask[:e] = 1.0
        infos = np.zeros((ep,) + info.shape, np.float32)
        infos[:e] = info
        return (pad(i.astype(np.int64), ep), pad(j.astype(np.int64), ep),
                pad(meas.astype(np.float32), ep), infos, mask)

    pose_mask = pad(np.ones(n, np.float32), np_)
    lm_mask = pad(np.ones(m, np.float32), mp)
    pose_fixed = np.zeros(np_, np.float32)
    pose_fixed[0] = 1.0
    return dict(
        poses=pad(poses.astype(np.float32), np_),
        landmarks=pad(landmarks.astype(np.float32), mp),
        pose_mask=pose_mask, lm_mask=lm_mask, pose_fixed=pose_fixed,
        lm_fixed=np.zeros(mp, np.float32),
        odom=edges(*odom, ODOM_INFO), lm_edges=edges(*lm_edges, LM_INFO),
    )


def _first_seen(ids: np.ndarray):
    """Dense landmark indices in first-seen order: ``(dense [E], first
    edge of each landmark [M])``."""
    uniq, first = np.unique(ids, return_index=True)
    order = np.argsort(first, kind="stable")
    dense_of = np.empty(uniq.shape[0], np.int64)
    dense_of[order] = np.arange(uniq.shape[0])
    return dense_of[np.searchsorted(uniq, ids)], first[order]


def robot(seed: int, robot_steps: int, fov_deg: float, ray_step_deg: float,
          start_xy=(5.0, 15.0), start_theta: float = 0.0,
          buckets=(64, 64, 256)) -> dict:
    """The scripted robot's graph (``frontend.simulate`` +
    ``build_graph``)."""
    rng = np.random.default_rng(seed)
    env, radius = environment()
    fov = math.radians(fov_deg)
    ray_count = int(fov / math.radians(ray_step_deg))
    controls = scripted_controls(robot_steps - 1).astype(np.float64)
    start = np.array([start_xy[0], start_xy[1], start_theta], np.float64)
    lidar_scale, pos_scale, ang_scale = SAMPLE_SCALES

    poses_gt = integrate(start, controls)
    meas_gt, ids, valid = scan(poses_gt, env, radius, fov, ray_count)
    odom_meas = controls + rng.normal(0.0, [pos_scale, pos_scale, ang_scale],
                                      controls.shape)
    odom_meas[:, 2] = np.arctan2(np.sin(odom_meas[:, 2]),
                                 np.cos(odom_meas[:, 2]))
    poses_dr = integrate(start, odom_meas)
    mg = meas_gt.astype(np.float64)
    local = np.stack([mg[..., 0] * np.cos(mg[..., 1]),
                      mg[..., 0] * np.sin(mg[..., 1])], axis=-1)
    local = local + rng.normal(0.0, lidar_scale, local.shape)
    meas = np.stack([np.linalg.norm(local, axis=-1),
                     np.arctan2(local[..., 1], local[..., 0])], axis=-1)
    c = np.cos(poses_dr[:, 2])[:, None]
    s = np.sin(poses_dr[:, 2])[:, None]
    lm_global = np.stack([
        poses_dr[:, 0][:, None] + c * local[..., 0] - s * local[..., 1],
        poses_dr[:, 1][:, None] + s * local[..., 0] + c * local[..., 1],
    ], axis=-1).astype(np.float32)

    t_idx, r_idx = np.nonzero(valid)          # row-major: t, then ray
    lm_dense, first = _first_seen(ids[t_idx, r_idx])
    t = poses_dr.shape[0]
    graph = _pack(
        poses_dr.astype(np.float32),
        lm_global[t_idx[first], r_idx[first]],
        (np.arange(t - 1), np.arange(1, t), odom_meas.astype(np.float32)),
        (t_idx, lm_dense, meas.astype(np.float32)[t_idx, r_idx]),
        buckets)
    return {"graph": graph, "n_poses": t, "n_landmarks": first.shape[0],
            "poses_gt": poses_gt.astype(np.float32)}


def _relative_controls(poses: np.ndarray) -> np.ndarray:
    p, q = poses[:-1], poses[1:]
    c, s = np.cos(p[:, 2]), np.sin(p[:, 2])
    ex, ey = q[:, 0] - p[:, 0], q[:, 1] - p[:, 1]
    return np.stack([c * ex + s * ey, -s * ex + c * ey,
                     np.arctan2(np.sin(q[:, 2] - p[:, 2]),
                                np.cos(q[:, 2] - p[:, 2]))], axis=1)


def _knn_brute(pos_xy: np.ndarray, lms: np.ndarray, k: int):
    obs_pose, obs_lm = [], []
    for s in range(0, pos_xy.shape[0], 512):
        block = pos_xy[s: s + 512]
        d2 = (np.sum(block**2, axis=1)[:, None] - 2.0 * block @ lms.T
              + np.sum(lms**2, axis=1)[None, :])
        idx = np.argpartition(d2, k, axis=1)[:, :k]
        obs_pose.append(np.repeat(np.arange(s, s + block.shape[0]), k))
        obs_lm.append(idx.ravel())
    return np.concatenate(obs_pose), np.concatenate(obs_lm)


def serpentine(seed: int, num_poses: int, num_landmarks: int,
               obs_per_pose: int, laps: int = 1,
               buckets=(512, 512, 4096)) -> dict:
    """The serpentine sweep's graph (``synthetic.make_large_problem``; the
    brute-force K-nearest search, which it takes up to 20k landmarks)."""
    if num_landmarks > 20_000:
        raise ValueError("serpentine: the frozen copy holds the brute-force "
                         "neighbour search only (up to 20k landmarks)")
    rng = np.random.default_rng(seed)
    lidar_scale, pos_scale, ang_scale = SAMPLE_SCALES
    arena = math.sqrt(num_landmarks) * 2.0
    lap_poses = max(2, num_poses // laps)
    rows = max(2, int(math.sqrt(lap_poses) / 1.4))
    per_row = lap_poses // rows
    step = arena / max(per_row, 1)
    controls = np.zeros((lap_poses - 1, 3), np.float64)
    k = 0
    for r in range(rows):
        for _ in range(per_row - 1):
            if k >= lap_poses - 1:
                break
            controls[k] = (step, 0.0, 0.0)
            k += 1
        turn = math.pi / 2.0 if r % 2 == 0 else -math.pi / 2.0
        for _ in range(2):
            if k >= lap_poses - 1:
                break
            controls[k] = (arena / rows / 2.0, 0.0, turn)
            k += 1
    while k < lap_poses - 1:
        controls[k] = (step, 0.0, 0.0)
        k += 1
    start = np.zeros(3)
    poses_gt = integrate(start, controls)
    if laps > 1:
        poses_gt = np.concatenate([poses_gt] * laps)
        controls = _relative_controls(poses_gt)
    n = poses_gt.shape[0]

    g = int(math.ceil(math.sqrt(num_landmarks)))
    lo = poses_gt[:, :2].min(axis=0) - 2.0
    hi = poses_gt[:, :2].max(axis=0) + 2.0
    gx, gy = np.meshgrid(np.linspace(lo[0], hi[0], g),
                         np.linspace(lo[1], hi[1], g))
    lms_gt = np.stack([gx.ravel(), gy.ravel()], axis=1)[:num_landmarks]
    lms_gt = lms_gt + rng.normal(0, 0.3, lms_gt.shape)
    obs_pose, obs_lm = _knn_brute(poses_gt[:, :2], lms_gt, obs_per_pose)

    d = lms_gt[obs_lm] - poses_gt[obs_pose, :2]
    rng_gt = np.linalg.norm(d, axis=1)
    bear_gt = np.arctan2(d[:, 1], d[:, 0]) - poses_gt[obs_pose, 2]
    local = np.stack([rng_gt * np.cos(bear_gt), rng_gt * np.sin(bear_gt)], 1)
    local = local + rng.normal(0, lidar_scale, local.shape)
    meas = np.stack([np.linalg.norm(local, axis=1),
                     np.arctan2(local[:, 1], local[:, 0])], axis=1)
    odom_meas = controls + rng.normal(0, [pos_scale, pos_scale, ang_scale],
                                      controls.shape)
    poses_dr = integrate(start, odom_meas)

    c, s = np.cos(poses_dr[obs_pose, 2]), np.sin(poses_dr[obs_pose, 2])
    glob = np.stack([poses_dr[obs_pose, 0] + c * local[:, 0] - s * local[:, 1],
                     poses_dr[obs_pose, 1] + s * local[:, 0] + c * local[:, 1]],
                    axis=1).astype(np.float32)
    lm_dense, first = _first_seen(obs_lm)
    graph = _pack(
        poses_dr.astype(np.float32), glob[first],
        (np.arange(n - 1), np.arange(1, n), odom_meas.astype(np.float32)),
        (obs_pose, lm_dense, meas.astype(np.float32)),
        buckets)
    return {"graph": graph, "n_poses": n, "n_landmarks": first.shape[0],
            "poses_gt": poses_gt.astype(np.float32)}


def generate(spec: dict, seed: int, root: Path = cells.ROOT) -> dict:
    """The graph of a configuration's ``graph`` section (merged with the
    traffic mix's overrides): ``{"kind": ..., **parameters}``, made by
    ``graphs/<kind>.py`` of ``root``."""
    spec = dict(spec)
    spec.pop("pool", None)
    spec.pop("pool_seed", None)
    kind = spec.pop("kind")
    if "buckets" in spec:
        spec["buckets"] = tuple(spec["buckets"])
    return cells.load("graphs", kind, root).generate(seed=seed, **spec)


def pool(spec: dict, seed: int, root: Path = cells.ROOT) -> list:
    """The graphs one run solves in turn: ``spec["pool"]`` of them (1 where
    absent), graph ``i`` from seed ``seed * pool + i``, so that two seeds
    never share a graph and the work of a run averages over the pool's
    noise draws.

    Where the spec names a ``pool_seed``, every run has that seed's graphs,
    in an order its own seed draws: the same work for every seed, where a
    metric follows each graph's work (a noise draw sets its PCG
    iterations)."""
    k = spec.get("pool", 1)
    if "pool_seed" not in spec:
        return [generate(spec, seed * k + i, root) for i in range(k)]
    order = np.random.default_rng(seed).permutation(k)
    return [generate(spec, spec["pool_seed"] * k + int(i), root)
            for i in order]
