"""Structs-of-tensors factor graph for 2D pose-landmark SLAM.

The same layout as ``toyslam_tpu.models.graph``: fixed-shape arrays padded
to buckets, validity and gauge masks, and typed edge sets.  Here every array
is a ``torch.Tensor``: float32 values and int64 indices.  The graph holds no
learnable parameters, so it is a frozen dataclass with a ``.to(device)``
rather than an ``nn.Module``.

:class:`GraphBuilder2D` accumulates a graph host-side with numpy, pads it
exactly like the JAX package's GraphBuilder2D and returns CPU tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def to_numpy(a) -> np.ndarray:
    """A host array from an array or a tensor on any device."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _bucket(n: int, bucket: int) -> int:
    """Round ``n`` up to the next multiple of ``bucket`` (at least one)."""
    return max(bucket, -(-n // bucket) * bucket)


class TensorTree:
    """Mixin for frozen dataclasses of tensors: ``.to(device)`` moves every
    tensor field and ``.astype(dtype)`` casts every floating-point one,
    recursing into nested trees; other fields are kept."""

    def to(self, device):
        changes = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (torch.Tensor, TensorTree)):
                changes[f.name] = v.to(device)
        return dataclasses.replace(self, **changes)

    def astype(self, dtype: torch.dtype):
        """The tree with every floating-point tensor in ``dtype`` (float64
        runs); index tensors and other fields are kept."""
        changes = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, TensorTree):
                changes[f.name] = v.astype(dtype)
            elif isinstance(v, torch.Tensor) and v.is_floating_point():
                changes[f.name] = v.to(dtype)
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class OdomEdges(TensorTree):
    """SE(2) odometry constraints between consecutive poses."""

    i: torch.Tensor       # int64[E]   first pose index
    j: torch.Tensor       # int64[E]   second pose index
    meas: torch.Tensor    # f32[E,3]   measured relative motion (x, y, theta)
    info: torch.Tensor    # f32[E,3,3] information matrix
    mask: torch.Tensor    # f32[E]     1.0 = real edge, 0.0 = padding

    @property
    def count(self) -> int:
        return self.i.shape[0]


@dataclasses.dataclass(frozen=True)
class LandmarkEdges(TensorTree):
    """Range-bearing landmark observations."""

    pose: torch.Tensor    # int64[E]   observing pose index
    lm: torch.Tensor      # int64[E]   landmark index
    meas: torch.Tensor    # f32[E,2]   (range, bearing) in the pose frame
    info: torch.Tensor    # f32[E,2,2] information matrix
    mask: torch.Tensor    # f32[E]

    @property
    def count(self) -> int:
        return self.pose.shape[0]


@dataclasses.dataclass(frozen=True)
class FactorGraph2D(TensorTree):
    """The whole optimization problem as one tree of tensors."""

    poses: torch.Tensor        # f32[N,3]
    landmarks: torch.Tensor    # f32[M,2]
    pose_mask: torch.Tensor    # f32[N] 1 = real
    lm_mask: torch.Tensor      # f32[M]
    pose_fixed: torch.Tensor   # f32[N] 1 = gauge-fixed (1e6 prior)
    lm_fixed: torch.Tensor     # f32[M]
    odom: OdomEdges
    lm_edges: LandmarkEdges
    # ops.gather_plan.GatherPlan once attached (ops.gather_plan.attach_plan)
    plan: object = None

    @property
    def num_poses(self) -> int:
        return self.poses.shape[0]

    @property
    def num_landmarks(self) -> int:
        return self.landmarks.shape[0]

    @property
    def device(self) -> torch.device:
        return self.poses.device

    def with_state(
        self, poses: torch.Tensor, landmarks: torch.Tensor
    ) -> "FactorGraph2D":
        return dataclasses.replace(self, poses=poses, landmarks=landmarks)


def graph_from_numpy(
    poses, landmarks, pose_mask, lm_mask, pose_fixed, lm_fixed,
    odom: tuple, lm_edges: tuple, device="cpu",
) -> FactorGraph2D:
    """Graph from numpy arrays; ``odom = (i, j, meas, info, mask)`` and
    ``lm_edges = (pose, lm, meas, info, mask)``.  Values become float32 and
    indices int64 tensors on ``device``."""

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def i64(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    oi, oj, om, oinf, omask = odom
    lp, ll, lmeas, linf, lmask = lm_edges
    return FactorGraph2D(
        poses=f32(poses),
        landmarks=f32(landmarks),
        pose_mask=f32(pose_mask),
        lm_mask=f32(lm_mask),
        pose_fixed=f32(pose_fixed),
        lm_fixed=f32(lm_fixed),
        odom=OdomEdges(i=i64(oi), j=i64(oj), meas=f32(om), info=f32(oinf),
                       mask=f32(omask)),
        lm_edges=LandmarkEdges(pose=i64(lp), lm=i64(ll), meas=f32(lmeas),
                               info=f32(linf), mask=f32(lmask)),
    )


class GraphBuilder2D:
    """Host-side incremental graph construction with bucketed padding.

    Poses are appended in trajectory order, landmarks get dense indices in
    first-seen order, and the first-seen landmark estimate wins.
    """

    def __init__(
        self,
        pose_bucket: int = 64,
        landmark_bucket: int = 64,
        edge_bucket: int = 256,
    ):
        self.pose_bucket = pose_bucket
        self.landmark_bucket = landmark_bucket
        self.edge_bucket = edge_bucket
        self._poses: list[np.ndarray] = []
        self._pose_fixed: list[bool] = []
        self._landmarks: list[np.ndarray] = []
        self._lm_fixed: list[bool] = []
        self._lm_index: dict[int, int] = {}  # external id -> dense index
        self._odom: list[tuple[int, int, np.ndarray, np.ndarray]] = []
        self._lm_obs: list[tuple[int, int, np.ndarray, np.ndarray]] = []

    def add_pose(self, pose_xyt, fixed: bool = False) -> int:
        self._poses.append(np.asarray(pose_xyt, np.float32))
        self._pose_fixed.append(bool(fixed))
        return len(self._poses) - 1

    def add_landmark(
        self, external_id: int, position_xy, fixed: bool = False
    ) -> int:
        if external_id in self._lm_index:
            return self._lm_index[external_id]
        idx = len(self._landmarks)
        self._lm_index[external_id] = idx
        self._landmarks.append(np.asarray(position_xy, np.float32))
        self._lm_fixed.append(bool(fixed))
        return idx

    def landmark_index(self, external_id: int) -> int:
        return self._lm_index[external_id]

    @property
    def landmark_id_map(self) -> dict[int, int]:
        return dict(self._lm_index)

    def add_odom_edge(self, i: int, j: int, meas_xyt, info3) -> None:
        self._odom.append((i, j, np.asarray(meas_xyt, np.float32),
                           np.asarray(info3, np.float32)))

    def add_landmark_edge(
        self, pose: int, external_lm_id: int, meas_rb, info2
    ) -> None:
        lm = self._lm_index[external_lm_id]
        self._lm_obs.append((pose, lm, np.asarray(meas_rb, np.float32),
                             np.asarray(info2, np.float32)))

    def set_state(self, poses, landmarks) -> None:
        """Overwrite the builder's pose and landmark estimates with
        optimized values.  ``poses [num_poses, 3]`` and ``landmarks
        [num_landmarks, 2]`` (arrays or tensors on any device) must cover
        exactly the real (unpadded) vertices."""
        poses = to_numpy(poses).astype(np.float32, copy=False)
        landmarks = to_numpy(landmarks).astype(np.float32, copy=False)
        if poses.shape != (self.num_poses, 3):
            raise ValueError(
                f"poses {poses.shape} != ({self.num_poses}, 3)"
            )
        if landmarks.shape != (self.num_landmarks, 2):
            raise ValueError(
                f"landmarks {landmarks.shape} != ({self.num_landmarks}, 2)"
            )
        self._poses = list(poses)
        self._landmarks = list(landmarks)

    @property
    def num_poses(self) -> int:
        return len(self._poses)

    @property
    def num_landmarks(self) -> int:
        return len(self._landmarks)

    def build(self) -> FactorGraph2D:
        n = len(self._poses)
        m = len(self._landmarks)
        np_, mp = _bucket(n, self.pose_bucket), _bucket(m, self.landmark_bucket)

        poses = np.zeros((np_, 3), np.float32)
        if n:
            poses[:n] = np.stack(self._poses)
        landmarks = np.zeros((mp, 2), np.float32)
        if m:
            landmarks[:m] = np.stack(self._landmarks)
        pose_mask = np.zeros(np_, np.float32)
        pose_mask[:n] = 1.0
        lm_mask = np.zeros(mp, np.float32)
        lm_mask[:m] = 1.0
        pose_fixed = np.zeros(np_, np.float32)
        pose_fixed[:n] = np.asarray(self._pose_fixed, np.float32)
        lm_fixed = np.zeros(mp, np.float32)
        lm_fixed[:m] = np.asarray(self._lm_fixed, np.float32)
        return graph_from_numpy(
            poses, landmarks, pose_mask, lm_mask, pose_fixed, lm_fixed,
            self._build_edges(self._odom, 3),
            self._build_edges(self._lm_obs, 2),
        )

    def _build_edges(self, edges, dim: int):
        e = len(edges)
        ep = _bucket(e, self.edge_bucket)
        i = np.zeros(ep, np.int64)
        j = np.zeros(ep, np.int64)
        meas = np.zeros((ep, dim), np.float32)
        info = np.zeros((ep, dim, dim), np.float32)
        mask = np.zeros(ep, np.float32)
        if e:
            i[:e] = np.fromiter((x[0] for x in edges), np.int64, e)
            j[:e] = np.fromiter((x[1] for x in edges), np.int64, e)
            meas[:e] = np.stack([x[2] for x in edges])
            info[:e] = np.stack([x[3] for x in edges])
            mask[:e] = 1.0
        return (i, j, meas, info, mask)
