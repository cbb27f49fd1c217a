"""Binary graph wire codec, byte-compatible with ``toyslam_tpu.io.codec``.

The stream is little-endian uint32/float32:

    [u32 body_size]
    [u32 n_vertices] { u32 id, u32 type,
                       type 0 (SE2 pose):   f32 x, f32 y, f32 theta
                       type 1 (2D point):   f32 x, f32 y }
    [u32 n_edges]    { u32 type, u32 id1, u32 id2,
                       meas  = matrix block,
                       info  = matrix block, always diagonal-encoded }
    [u32 n_fixed]    { u32 id }

where a matrix block is ``u32 rows, u32 cols, f32 payload``; ``rows == 0``
marks a vector (or, for information matrices, the diagonal of a cols x cols
matrix).  Odometry edges (type 0) carry their measurement as a full 3x3
homogeneous transform; landmark edges (type 1) carry a length-2 (range,
bearing) vector.

Vertex-id convention: pose vertex ``p`` has wire id ``p``; landmark vertex
``l`` has wire id ``num_poses_padded + l``.

Information matrices travel as their diagonal only, so :func:`graph_to_bytes`
raises on a non-diagonal one unless ``allow_lossy_info=True``.

The codec is host numpy: :func:`graph_to_bytes` reads the graph's tensors
back to the host, and :func:`bytes_to_graph` returns a graph of CPU tensors
(the caller moves it with ``.to(device)``).  It is also the body of the
remote-optimizer protocol (``io/client.py``, ``io/server.py``).
"""

from __future__ import annotations

import dataclasses
import io as _io
import struct

import numpy as np
import torch

from toyslam_torch.models.graph import (
    FactorGraph2D,
    GraphBuilder2D,
    to_numpy as _np,
)

_U32 = "<I"
VERTEX_SE2 = 0
VERTEX_POINT2 = 1
EDGE_ODOM = 0
EDGE_LANDMARK = 1


def _u32(value: int) -> bytes:
    return struct.pack(_U32, value)


def _matrix_block(mat: np.ndarray, is_diag: bool) -> bytes:
    """Encode one matrix block."""
    mat = np.asarray(mat, np.float32)
    if is_diag:
        head = _u32(0) + _u32(mat.shape[0])
        payload = np.ascontiguousarray(np.diag(mat)).tobytes()
    elif mat.ndim == 1:
        head = _u32(0) + _u32(mat.shape[0])
        payload = np.ascontiguousarray(mat).tobytes()
    else:
        head = _u32(mat.shape[0]) + _u32(mat.shape[1])
        payload = np.ascontiguousarray(mat).tobytes()
    return head + payload


def _se2_to_matrix_np(pose: np.ndarray) -> np.ndarray:
    th = np.float64(pose[2])
    c, s = np.float32(np.cos(th)), np.float32(np.sin(th))
    return np.array(
        [[c, -s, pose[0]], [s, c, pose[1]], [0.0, 0.0, 1.0]], np.float32
    )


def graph_to_bytes(
    graph: FactorGraph2D,
    *,
    frame: bool = True,
    allow_lossy_info: bool = False,
) -> bytes:
    """Serialize a factor graph to the wire format.

    ``frame=True`` prepends the 4-byte body size; pass ``False`` to get the
    bare body.
    """
    poses = _np(graph.poses).astype(np.float32, copy=False)
    lms = _np(graph.landmarks).astype(np.float32, copy=False)
    pose_mask = _np(graph.pose_mask) > 0.5
    lm_mask = _np(graph.lm_mask) > 0.5
    n_poses_padded = poses.shape[0]

    out = _io.BytesIO()

    # -- vertices ----------------------------------------------------------
    pose_ids = np.nonzero(pose_mask)[0]
    lm_ids = np.nonzero(lm_mask)[0]
    out.write(_u32(len(pose_ids) + len(lm_ids)))
    for p in pose_ids:
        out.write(_u32(int(p)) + _u32(VERTEX_SE2))
        out.write(np.ascontiguousarray(poses[p]).tobytes())
    for l in lm_ids:
        out.write(_u32(int(n_poses_padded + l)) + _u32(VERTEX_POINT2))
        out.write(np.ascontiguousarray(lms[l]).tobytes())

    # -- edges -------------------------------------------------------------
    def _check_diag(info: np.ndarray, what: str) -> None:
        if allow_lossy_info:
            return
        off = info - np.diag(np.diag(info))
        if np.any(np.abs(off) > 0):
            raise ValueError(
                f"{what} information matrix has off-diagonal entries; the "
                "wire format transmits diagonals only. Pass "
                "allow_lossy_info=True to truncate."
            )

    od, le = graph.odom, graph.lm_edges
    od_real = np.nonzero(_np(od.mask) > 0.5)[0]
    le_real = np.nonzero(_np(le.mask) > 0.5)[0]
    out.write(_u32(len(od_real) + len(le_real)))
    od_meas = _np(od.meas).astype(np.float32, copy=False)
    od_info = _np(od.info).astype(np.float32, copy=False)
    od_i = _np(od.i)
    od_j = _np(od.j)
    for e in od_real:
        _check_diag(od_info[e], "odometry edge")
        out.write(_u32(EDGE_ODOM) + _u32(int(od_i[e])) + _u32(int(od_j[e])))
        out.write(_matrix_block(_se2_to_matrix_np(od_meas[e]), False))
        out.write(_matrix_block(od_info[e], True))
    le_meas = _np(le.meas).astype(np.float32, copy=False)
    le_info = _np(le.info).astype(np.float32, copy=False)
    le_pose = _np(le.pose)
    le_lm = _np(le.lm)
    for e in le_real:
        _check_diag(le_info[e], "landmark edge")
        out.write(
            _u32(EDGE_LANDMARK)
            + _u32(int(le_pose[e]))
            + _u32(int(n_poses_padded + le_lm[e]))
        )
        out.write(_matrix_block(le_meas[e], False))
        out.write(_matrix_block(le_info[e], True))

    # -- fixed vertices ----------------------------------------------------
    fixed_p = np.nonzero((_np(graph.pose_fixed) > 0.5) & pose_mask)[0]
    fixed_l = np.nonzero((_np(graph.lm_fixed) > 0.5) & lm_mask)[0]
    out.write(_u32(len(fixed_p) + len(fixed_l)))
    for p in fixed_p:
        out.write(_u32(int(p)))
    for l in fixed_l:
        out.write(_u32(int(n_poses_padded + l)))

    body = out.getvalue()
    return _u32(len(body)) + body if frame else body


class _Reader:
    def __init__(self, data: bytes, offset: int = 0):
        self.data = data
        self.off = offset

    def u32(self) -> int:
        (v,) = struct.unpack_from(_U32, self.data, self.off)
        self.off += 4
        return v

    def f32(self, count: int) -> np.ndarray:
        v = np.frombuffer(self.data, np.float32, count, self.off)
        self.off += 4 * count
        return v

    def matrix(self, is_diag: bool = False) -> np.ndarray:
        rows, cols = self.u32(), self.u32()
        if is_diag:
            return np.diag(self.f32(cols)).astype(np.float32)
        if rows == 0:
            return self.f32(cols).copy()
        return self.f32(rows * cols).reshape(rows, cols).copy()


def bytes_to_graph(
    data: bytes,
    *,
    framed: bool = True,
    pose_bucket: int = 64,
    landmark_bucket: int = 64,
    edge_bucket: int = 256,
) -> FactorGraph2D:
    """Decode the wire format back into a padded :class:`FactorGraph2D` of
    CPU tensors.

    Inverse of :func:`graph_to_bytes`.  Vertex ids may be arbitrary; they
    are densified in the order poses then landmarks appear on the wire.
    """
    r = _Reader(data)
    if framed:
        body_size = r.u32()
        if body_size != len(data) - 4:
            raise ValueError(
                f"frame header says {body_size} bytes, got {len(data) - 4}"
            )

    n_vertices = r.u32()
    pose_list: list[tuple[int, np.ndarray]] = []
    lm_list: list[tuple[int, np.ndarray]] = []
    for _ in range(n_vertices):
        vid, vtype = r.u32(), r.u32()
        if vtype == VERTEX_SE2:
            pose_list.append((vid, r.f32(3).copy()))
        elif vtype == VERTEX_POINT2:
            lm_list.append((vid, r.f32(2).copy()))
        else:
            raise ValueError(f"unknown vertex type {vtype}")

    b = GraphBuilder2D(
        pose_bucket=pose_bucket,
        landmark_bucket=landmark_bucket,
        edge_bucket=edge_bucket,
    )
    pose_index: dict[int, int] = {}
    for vid, xyt in pose_list:
        pose_index[vid] = b.add_pose(xyt)
    for vid, xy in lm_list:
        b.add_landmark(vid, xy)

    n_edges = r.u32()
    for _ in range(n_edges):
        etype, id1, id2 = r.u32(), r.u32(), r.u32()
        meas = r.matrix(False)
        info = r.matrix(True)
        if etype == EDGE_ODOM:
            theta = float(np.arctan2(np.float64(meas[1, 0]),
                                     np.float64(meas[0, 0])))
            b.add_odom_edge(
                pose_index[id1],
                pose_index[id2],
                np.array([meas[0, 2], meas[1, 2], theta], np.float32),
                info,
            )
        elif etype == EDGE_LANDMARK:
            b.add_landmark_edge(pose_index[id1], id2, meas, info)
        else:
            raise ValueError(f"unknown edge type {etype}")

    n_fixed = r.u32()
    fixed_ids = {r.u32() for _ in range(n_fixed)}

    graph = b.build()
    pose_fixed = graph.pose_fixed.numpy().copy()
    lm_fixed = graph.lm_fixed.numpy().copy()
    lm_index = b.landmark_id_map
    for vid in fixed_ids:
        if vid in pose_index:
            pose_fixed[pose_index[vid]] = 1.0
        elif vid in lm_index:
            lm_fixed[lm_index[vid]] = 1.0
        else:
            raise ValueError(f"fixed id {vid} names no vertex")
    return dataclasses.replace(
        graph,
        pose_fixed=torch.from_numpy(pose_fixed),
        lm_fixed=torch.from_numpy(lm_fixed),
    )
