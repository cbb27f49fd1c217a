"""Structs-of-tensors factor graph for SE(3) pose-graph + reprojection BA.

The layout of ``toyslam_tpu.models.graph3d``, with the same field protocol
as ``models/graph.py`` so that the shape-generic Schur and fused-PCG
machinery (``ops/schur.py``, ``ops/fused_pcg.py``, ``ops/gather_plan.py``)
runs on both graphs:

* ``poses``     f32[N, 12] flat SE(3) (row-major R | t, ``ops/se3.py``);
* ``landmarks`` f32[M, 3] world points;
* ``odom``      relative-pose constraints ``i -> j``, flat [E, 12]
  measurements and 6x6 information;
* ``lm_edges``  pinhole reprojection observations: pose ``pose`` sees
  landmark ``lm`` at pixel ``meas`` (u, v) with 2x2 information; the
  camera intrinsics (fx, fy, cx, cy) are ``f32[4]`` on the graph, or
  ``f32[5]`` with a near plane (``ops/residuals3d.py``).

Pose blocks are 6-dof (dt, omega), landmark blocks 3-dof.  Values are
float32 and indices int64 tensors.  :class:`GraphBuilder3D` pads exactly
like the JAX package's builder and returns CPU tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from toyslam_torch.models.graph import TensorTree, _bucket


@dataclasses.dataclass(frozen=True)
class Odom3DEdges(TensorTree):
    """SE(3) relative-pose constraints."""

    i: torch.Tensor       # int64[E]
    j: torch.Tensor       # int64[E]
    meas: torch.Tensor    # f32[E, 12] measured relative transform
    info: torch.Tensor    # f32[E, 6, 6]
    mask: torch.Tensor    # f32[E]

    @property
    def count(self) -> int:
        return self.i.shape[0]


@dataclasses.dataclass(frozen=True)
class ReprojEdges(TensorTree):
    """Pinhole reprojection observations (BA edges)."""

    pose: torch.Tensor    # int64[E] observing camera pose
    lm: torch.Tensor      # int64[E] landmark index
    meas: torch.Tensor    # f32[E, 2] observed pixel (u, v)
    info: torch.Tensor    # f32[E, 2, 2]
    mask: torch.Tensor    # f32[E]

    @property
    def count(self) -> int:
        return self.pose.shape[0]


@dataclasses.dataclass(frozen=True)
class FactorGraph3D(TensorTree):
    """The SE(3) BA problem as one tree of tensors."""

    poses: torch.Tensor        # f32[N, 12]
    landmarks: torch.Tensor    # f32[M, 3]
    pose_mask: torch.Tensor    # f32[N]
    lm_mask: torch.Tensor      # f32[M]
    pose_fixed: torch.Tensor   # f32[N]
    lm_fixed: torch.Tensor     # f32[M]
    odom: Odom3DEdges
    lm_edges: ReprojEdges
    intrinsics: torch.Tensor   # f32[4] (fx, fy, cx, cy) or f32[5] (+ near)
    # ops.gather_plan.GatherPlan once attached (ops.gather_plan.attach_plan)
    plan: object = None

    @property
    def num_poses(self) -> int:
        return self.poses.shape[0]

    @property
    def num_landmarks(self) -> int:
        return self.landmarks.shape[0]

    @property
    def state_dim(self) -> int:
        return 6 * self.num_poses + 3 * self.num_landmarks

    @property
    def device(self) -> torch.device:
        return self.poses.device

    def with_state(
        self, poses: torch.Tensor, landmarks: torch.Tensor
    ) -> "FactorGraph3D":
        return dataclasses.replace(self, poses=poses, landmarks=landmarks)


def graph3d_from_numpy(
    poses, landmarks, pose_mask, lm_mask, pose_fixed, lm_fixed,
    odom: tuple, lm_edges: tuple, intrinsics, device="cpu",
) -> FactorGraph3D:
    """Graph from numpy arrays; ``odom = (i, j, meas, info, mask)`` and
    ``lm_edges = (pose, lm, meas, info, mask)``.  Values become float32 and
    indices int64 tensors on ``device``."""

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def i64(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    oi, oj, om, oinf, omask = odom
    lp, ll, lmeas, linf, lmask = lm_edges
    return FactorGraph3D(
        poses=f32(poses), landmarks=f32(landmarks),
        pose_mask=f32(pose_mask), lm_mask=f32(lm_mask),
        pose_fixed=f32(pose_fixed), lm_fixed=f32(lm_fixed),
        odom=Odom3DEdges(i=i64(oi), j=i64(oj), meas=f32(om), info=f32(oinf),
                         mask=f32(omask)),
        lm_edges=ReprojEdges(pose=i64(lp), lm=i64(ll), meas=f32(lmeas),
                             info=f32(linf), mask=f32(lmask)),
        intrinsics=f32(intrinsics),
    )


class GraphBuilder3D:
    """Host-side incremental SE(3) BA graph construction (bucketed
    padding)."""

    def __init__(
        self,
        intrinsics=(500.0, 500.0, 320.0, 240.0),
        pose_bucket: int = 64,
        landmark_bucket: int = 64,
        edge_bucket: int = 256,
    ):
        self.intrinsics = np.asarray(intrinsics, np.float32)
        self.pose_bucket = pose_bucket
        self.landmark_bucket = landmark_bucket
        self.edge_bucket = edge_bucket
        self._poses: list[np.ndarray] = []
        self._pose_fixed: list[bool] = []
        self._landmarks: list[np.ndarray] = []
        self._lm_fixed: list[bool] = []
        self._lm_index: dict[int, int] = {}
        self._odom: list[tuple[int, int, np.ndarray, np.ndarray]] = []
        self._reproj: list[tuple[int, int, np.ndarray, np.ndarray]] = []

    def add_pose(self, pose_flat12, fixed: bool = False) -> int:
        p = np.asarray(pose_flat12, np.float32)
        assert p.shape == (12,)
        self._poses.append(p)
        self._pose_fixed.append(bool(fixed))
        return len(self._poses) - 1

    def add_landmark(
        self, external_id: int, position_xyz, fixed: bool = False
    ) -> int:
        if external_id in self._lm_index:
            return self._lm_index[external_id]
        idx = len(self._landmarks)
        self._lm_index[external_id] = idx
        self._landmarks.append(np.asarray(position_xyz, np.float32))
        self._lm_fixed.append(bool(fixed))
        return idx

    def landmark_index(self, external_id: int) -> int:
        return self._lm_index[external_id]

    @property
    def landmark_id_map(self) -> dict[int, int]:
        return dict(self._lm_index)

    def add_odom_edge(self, i: int, j: int, meas_flat12, info6) -> None:
        self._odom.append((i, j, np.asarray(meas_flat12, np.float32),
                           np.asarray(info6, np.float32)))

    def add_reproj_edge(
        self, pose: int, external_lm_id: int, meas_uv, info2
    ) -> None:
        lm = self._lm_index[external_lm_id]
        self._reproj.append((pose, lm, np.asarray(meas_uv, np.float32),
                             np.asarray(info2, np.float32)))

    @property
    def num_poses(self) -> int:
        return len(self._poses)

    @property
    def num_landmarks(self) -> int:
        return len(self._landmarks)

    def build(self) -> FactorGraph3D:
        n, m = len(self._poses), len(self._landmarks)
        np_ = _bucket(n, self.pose_bucket)
        mp = _bucket(m, self.landmark_bucket)
        poses = np.zeros((np_, 12), np.float32)
        # padded poses get identity rotations so the SE(3) math stays
        # well defined
        poses[:, 0] = poses[:, 4] = poses[:, 8] = 1.0
        if n:
            poses[:n] = np.stack(self._poses)
        landmarks = np.zeros((mp, 3), np.float32)
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
        return graph3d_from_numpy(
            poses, landmarks, pose_mask, lm_mask, pose_fixed, lm_fixed,
            self._build_edges(self._odom, 12, 6),
            self._build_edges(self._reproj, 2, 2),
            self.intrinsics.copy(),
        )

    def _build_edges(self, edges, meas_dim: int, info_dim: int):
        e = len(edges)
        ep = _bucket(e, self.edge_bucket)
        i = np.zeros(ep, np.int64)
        j = np.zeros(ep, np.int64)
        meas = np.zeros((ep, meas_dim), np.float32)
        info = np.zeros((ep, info_dim, info_dim), np.float32)
        mask = np.zeros(ep, np.float32)
        if meas_dim == 12:
            meas[:, 0] = meas[:, 4] = meas[:, 8] = 1.0   # identity rotations
        if e:
            i[:e] = np.fromiter((x[0] for x in edges), np.int64, e)
            j[:e] = np.fromiter((x[1] for x in edges), np.int64, e)
            meas[:e] = np.stack([x[2] for x in edges])
            info[:e] = np.stack([x[3] for x in edges])
            mask[:e] = 1.0
        return (i, j, meas, info, mask)
