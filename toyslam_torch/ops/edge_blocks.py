"""Per-edge weighted normal-equation blocks — the linearization interface.

* odometry edge (A = -I, B = I): the blocks collapse to ``±W'`` with
  ``W' = w * info`` and the gradient contribution to ``±W' r``;
* landmark edge: ``JA^T W' JA``, ``JB^T W' JB``, ``JA^T W' JB`` and the two
  gradient pieces.

Accumulation into per-vertex blocks is the deterministic gather-table sum
of ``ops/schur.py``, never atomics.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from toyslam_torch.ops import blockmath as bm
from toyslam_torch.ops import residuals as res_ops


class OdomBlocks(NamedTuple):
    """``w_info`` f32[E,3,3] = huber_w * mask * info (= ``A^T W' A`` =
    ``B^T W' B``; the off-diagonal block is its negative); ``wr`` f32[E,3]
    = ``W' r`` (gradient ``-wr`` at vertex i, ``+wr`` at j)."""

    w_info: torch.Tensor
    wr: torch.Tensor
    robust_err: torch.Tensor
    chi2: torch.Tensor


class LmBlocks(NamedTuple):
    """``w_ata`` f32[E,3,3] = JA^T W' JA; ``w_btb`` f32[E,2,2] = JB^T W' JB;
    ``w_hpl`` f32[E,3,2] = JA^T W' JB; ``bp_c`` f32[E,3] = JA^T W' r;
    ``bl_c`` f32[E,2] = JB^T W' r."""

    w_ata: torch.Tensor
    w_btb: torch.Tensor
    w_hpl: torch.Tensor
    bp_c: torch.Tensor
    bl_c: torch.Tensor
    robust_err: torch.Tensor
    chi2: torch.Tensor


def odom_edge_blocks(
    poses, i, j, meas, info, mask, huber_delta: float
) -> OdomBlocks:
    od = res_ops.eval_odom_edges(poses, i, j, meas, info, mask, huber_delta)
    w_info = od.w[:, None, None] * info
    wr = bm.mv(w_info, od.r)
    return OdomBlocks(
        w_info=w_info, wr=wr, robust_err=od.robust_err, chi2=od.chi2
    )


def lm_edge_blocks(
    poses, landmarks, pose_idx, lm_idx, meas, info, mask, huber_delta: float
) -> LmBlocks:
    lme = res_ops.eval_landmark_edges(
        poses, landmarks, pose_idx, lm_idx, meas, info, mask, huber_delta
    )
    w_lm = lme.w[:, None, None] * info
    wjb = bm.mm(w_lm, lme.JB)
    wr = bm.mv(w_lm, lme.r)
    return LmBlocks(
        w_ata=bm.quad(lme.JA, w_lm),
        w_btb=bm.mtm(lme.JB, wjb),
        w_hpl=bm.mtm(lme.JA, wjb),
        bp_c=bm.mtv(lme.JA, wr),
        bl_c=bm.mtv(lme.JB, wr),
        robust_err=lme.robust_err,
        chi2=lme.chi2,
    )

