"""SLAM frontend: run the simulated robot and build the factor graph.

Host numpy in float64 with a seeded ``np.random.default_rng``, exactly as in
``toyslam_tpu.sim.frontend.simulate``, so both packages optimize the same
problem instance bit for bit.  Noise semantics:

* odometry: additive Gaussian on each step's (dx, dy, dtheta);
* landmarks: noise on the body-frame euclidean point, re-encoded as
  (range, bearing), and pushed through the *dead-reckoned* pose for the
  landmark's first-seen global estimate;
* the first pose is gauge-fixed.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from toyslam_torch.config import SimConfig, SlamConfig
from toyslam_torch.models.graph import FactorGraph2D, GraphBuilder2D
from toyslam_torch.sim import environment as env_mod
from toyslam_torch.sim import lidar, trajectory


class SimulationResult(NamedTuple):
    poses_gt: np.ndarray   # f32[T,3] ground-truth trajectory
    poses_dr: np.ndarray   # f32[T,3] dead-reckoned (noisy odometry) trajectory
    odom_gt: np.ndarray    # f32[T-1,3] scripted controls
    odom_meas: np.ndarray  # f32[T-1,3] noisy odometry measurements
    meas: np.ndarray       # f32[T,R,2] noisy (range, bearing) per ray
    meas_gt: np.ndarray    # f32[T,R,2] noise-free measurements
    lm_global: np.ndarray  # f32[T,R,2] first-seen candidate world estimates
    ids: np.ndarray        # i32[T,R] ground-truth obstacle id (-1 invalid)
    valid: np.ndarray      # bool[T,R]
    env: np.ndarray        # f32[P,2]
    radius: float


def simulate(
    config: SimConfig,
    rng: Optional[np.random.Generator] = None,
    controls: Optional[np.ndarray] = None,
) -> SimulationResult:
    """Deterministic host-side simulation (float64 numpy).  ``controls``
    overrides the scripted schedule."""
    if rng is None:
        rng = np.random.default_rng(config.seed)
    env, radius = env_mod.load_environment()
    if controls is None:
        controls = trajectory.scripted_controls(config.robot_steps - 1)
    controls = np.asarray(controls, np.float64)
    start = np.array(
        [config.start_xy[0], config.start_xy[1], config.start_theta],
        np.float64,
    )
    lidar_scale, pos_scale, ang_scale = config.noise.sample_scales()

    poses_gt = trajectory.integrate_np(start, controls)
    meas_gt, ids, valid = lidar.scan_trajectory_np(
        poses_gt, env, radius, config.lidar.fov, config.lidar.ray_count
    )

    odom_meas = controls + rng.normal(
        0.0, [pos_scale, pos_scale, ang_scale], controls.shape
    )
    odom_meas[:, 2] = np.arctan2(
        np.sin(odom_meas[:, 2]), np.cos(odom_meas[:, 2])
    )
    poses_dr = trajectory.integrate_np(start, odom_meas)

    mg = meas_gt.astype(np.float64)
    local = np.stack(
        [mg[..., 0] * np.cos(mg[..., 1]), mg[..., 0] * np.sin(mg[..., 1])],
        axis=-1,
    )
    local = local + rng.normal(0.0, lidar_scale, local.shape)
    meas = np.stack(
        [
            np.linalg.norm(local, axis=-1),
            np.arctan2(local[..., 1], local[..., 0]),
        ],
        axis=-1,
    )
    c = np.cos(poses_dr[:, 2])[:, None]
    s = np.sin(poses_dr[:, 2])[:, None]
    lm_global = np.stack(
        [
            poses_dr[:, 0][:, None] + c * local[..., 0] - s * local[..., 1],
            poses_dr[:, 1][:, None] + s * local[..., 0] + c * local[..., 1],
        ],
        axis=-1,
    )
    return SimulationResult(
        poses_gt=poses_gt.astype(np.float32),
        poses_dr=poses_dr.astype(np.float32),
        odom_gt=controls.astype(np.float32),
        odom_meas=odom_meas.astype(np.float32),
        meas=meas.astype(np.float32),
        meas_gt=meas_gt,
        lm_global=lm_global.astype(np.float32),
        ids=ids,
        valid=valid,
        env=env,
        radius=radius,
    )


def build_graph(
    sim: SimulationResult,
    config: SlamConfig,
) -> tuple[FactorGraph2D, dict[int, int]]:
    """The optimization problem of a simulation run, on the CPU.

    Pose vertices are the dead-reckoned states, odometry edges carry the
    noisy step transforms, landmark edges the noisy (range, bearing)
    measurements, and landmarks start at their first-seen global estimate.
    Returns the graph and the obstacle-id -> landmark-index map; move the
    graph with ``graph.to(device)``.
    """
    noise = config.sim.noise
    odom_info = np.diag(noise.odom_information_diag()).astype(np.float32)
    lm_info = np.diag(noise.lidar_information_diag()).astype(np.float32)

    b = GraphBuilder2D(
        pose_bucket=config.pose_bucket,
        landmark_bucket=config.landmark_bucket,
        edge_bucket=config.edge_bucket,
    )
    T = sim.poses_dr.shape[0]
    for t in range(T):
        b.add_pose(sim.poses_dr[t], fixed=(t == 0))
    for t in range(T - 1):
        b.add_odom_edge(t, t + 1, sim.odom_meas[t], odom_info)
    for t in range(T):
        for r in np.nonzero(sim.valid[t])[0]:
            oid = int(sim.ids[t, r])
            b.add_landmark(oid, sim.lm_global[t, r])  # first-seen wins
            b.add_landmark_edge(t, oid, sim.meas[t, r], lm_info)
    return b.build(), b.landmark_id_map


def ate_rmse(poses_est, poses_gt) -> float:
    """Absolute trajectory error (RMSE over xy), the headline metric.
    Accepts numpy arrays or tensors on any device."""
    est = _host(poses_est)
    gt = _host(poses_gt)
    d = est[:, :2] - gt[:, :2]
    return float(np.sqrt(np.mean(np.sum(d * d, axis=1))))


def _host(a) -> np.ndarray:
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)
