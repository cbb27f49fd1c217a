"""Dense normal-equation assembly (``solver="dense"``, small graphs).

The per-edge Jacobian blocks are written into one tall dense matrix
``J [R, D]`` (every residual row holds at most two small blocks), and

    H = J^T (W J),    b = J^T (W r)

are one matrix product and one matrix-vector product, in full float32
(the 1e6 gauge prior leaves no digits to spare for TF32).
``R = 3*E_odom + 2*E_lm`` and ``D = 3*N + 2*M``; the state holds all pose
blocks first, then all landmark blocks.  Each (row, column) of J receives
one edge's entry (padded edges write zeros), so the indexed writes are
deterministic.

Port of ``toyslam_tpu.ops.assemble``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from toyslam_torch.models.graph import FactorGraph2D
from toyslam_torch.ops import blockmath as bm
from toyslam_torch.ops import residuals as res_ops
from toyslam_torch.ops.schur import _full_f32_matmul


class DenseSystem(NamedTuple):
    H: torch.Tensor       # f32[D, D]
    b: torch.Tensor       # f32[D] gradient J^T W r (solve H dx = -b)
    err: torch.Tensor     # f32[] total robustified chi^2
    fixed: torch.Tensor   # f32[D] 1 where the entry belongs to a fixed vertex
    padded: torch.Tensor  # f32[D] 1 where the entry is padding


def state_masks(graph: FactorGraph2D) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-vertex fixed and padding masks on the stacked state."""
    fixed = torch.cat([graph.pose_fixed.repeat_interleave(3),
                       graph.lm_fixed.repeat_interleave(2)])
    padded = torch.cat([(1.0 - graph.pose_mask).repeat_interleave(3),
                        (1.0 - graph.lm_mask).repeat_interleave(2)])
    return fixed, padded


def _eval_edges(graph: FactorGraph2D, huber_delta: float,
                exact_odom_jacobians: bool):
    od = res_ops.eval_odom_edges(
        graph.poses, graph.odom.i, graph.odom.j, graph.odom.meas,
        graph.odom.info, graph.odom.mask, huber_delta,
        exact=exact_odom_jacobians,
    )
    lme = res_ops.eval_landmark_edges(
        graph.poses, graph.landmarks, graph.lm_edges.pose, graph.lm_edges.lm,
        graph.lm_edges.meas, graph.lm_edges.info, graph.lm_edges.mask,
        huber_delta,
    )
    return od, lme


def assemble_dense(
    graph: FactorGraph2D,
    huber_delta: float,
    fixed_prior: float = 1e6,
    exact_odom_jacobians: bool = False,
) -> DenseSystem:
    n = graph.num_poses
    e1, e2 = graph.odom.count, graph.lm_edges.count
    d = 3 * n + 2 * graph.num_landmarks
    dev, dtype = graph.device, graph.poses.dtype
    od, lme = _eval_edges(graph, huber_delta, exact_odom_jacobians)

    # robustified information per edge; padded edges are masked to zero
    w_od = od.w[:, None, None] * graph.odom.info
    w_lm = lme.w[:, None, None] * graph.lm_edges.info

    J = torch.zeros((3 * e1 + 2 * e2, d), dtype=dtype, device=dev)
    WJ = torch.zeros_like(J)
    wr = torch.zeros(J.shape[0], dtype=dtype, device=dev)

    def put(rows, cols_a, cols_b, JA, JB, WA, WB, wres, mask):
        r, a, b = rows[:, :, None], cols_a[:, None, :], cols_b[:, None, :]
        m3 = mask[:, None, None]
        J.index_put_((r, a), JA * m3, accumulate=True)
        J.index_put_((r, b), JB * m3, accumulate=True)
        WJ.index_put_((r, a), WA * m3, accumulate=True)
        WJ.index_put_((r, b), WB * m3, accumulate=True)
        wr.index_put_((rows,), wres * mask[:, None], accumulate=True)

    # odometry edges: rows [3k, 3k+3), blocks at the two pose columns
    ar3 = torch.arange(3, device=dev)
    ar2 = torch.arange(2, device=dev)
    put(3 * torch.arange(e1, device=dev)[:, None] + ar3,
        3 * graph.odom.i[:, None] + ar3, 3 * graph.odom.j[:, None] + ar3,
        od.JA, od.JB, bm.mm(w_od, od.JA), bm.mm(w_od, od.JB),
        bm.mv(w_od, od.r), graph.odom.mask)
    # landmark edges: rows [3 E1 + 2k, ...), a pose and a landmark block
    put(3 * e1 + 2 * torch.arange(e2, device=dev)[:, None] + ar2,
        3 * graph.lm_edges.pose[:, None] + ar3,
        3 * n + 2 * graph.lm_edges.lm[:, None] + ar2,
        lme.JA, lme.JB, bm.mm(w_lm, lme.JA), bm.mm(w_lm, lme.JB),
        bm.mv(w_lm, lme.r), graph.lm_edges.mask)

    with _full_f32_matmul():
        H = J.T @ WJ
        b = J.T @ wr

    fixed, padded = state_masks(graph)
    # fixed vertices: a strong prior on the diagonal and a zero gradient;
    # padded entries get a unit diagonal so that H stays invertible
    idx = torch.arange(d, device=dev)
    H[idx, idx] = torch.diagonal(H) + fixed_prior * fixed + padded
    b = b * (1.0 - fixed)
    err = od.robust_err.sum() + lme.robust_err.sum()
    return DenseSystem(H=H, b=b, err=err, fixed=fixed, padded=padded)


def total_error(
    graph: FactorGraph2D, huber_delta: float,
    exact_odom_jacobians: bool = False,
) -> torch.Tensor:
    """Robustified chi^2 of the current state (no assembly)."""
    od, lme = _eval_edges(graph, huber_delta, exact_odom_jacobians)
    return od.robust_err.sum() + lme.robust_err.sum()
