"""Weighted normal-equation blocks of every SE(3) edge at once: the 3D
counterpart of ``ops/edge_blocks.py`` (port of
``toyslam_tpu.ops.edge_blocks3d`` without its ``backend`` knob, which
names only the batched formulas there too).  These batched formulas are
the plain version of the kernels of ``ops/edges3d_kernel.py``, which
``schur3d.edge_blocks_3d`` takes on the card."""

from __future__ import annotations

from typing import NamedTuple

import torch

from toyslam_torch.ops import blockmath as bm
from toyslam_torch.ops import residuals3d as res3


class OdomBlocks(NamedTuple):
    """``w_aa``, ``w_bb``, ``w_ab`` f32[E,6,6] = JA^T W' JA, JB^T W' JB,
    JA^T W' JB; ``b_a``, ``b_b`` f32[E,6] = JA^T W' r, JB^T W' r, with W' =
    huber_w * mask * info; ``robust_err`` f32[E] (masked)."""

    w_aa: torch.Tensor
    w_bb: torch.Tensor
    w_ab: torch.Tensor
    b_a: torch.Tensor
    b_b: torch.Tensor
    robust_err: torch.Tensor


def odom3d_edge_blocks(
    poses, i, j, meas, info, mask, huber_delta: float, exact: bool = False,
) -> OdomBlocks:
    od = res3.eval_odom3d_edges(poses, i, j, meas, info, mask, huber_delta,
                                exact=exact)
    w_od = od.w[:, None, None] * info                # [E, 6, 6]
    wr = bm.mv(w_od, od.r)
    return OdomBlocks(
        w_aa=bm.quad(od.JA, w_od),
        w_bb=bm.quad(od.JB, w_od),
        w_ab=bm.mtm(od.JA, bm.mm(w_od, od.JB)),
        b_a=bm.mtv(od.JA, wr),
        b_b=bm.mtv(od.JB, wr),
        robust_err=od.robust_err,
    )


class ReprojBlocks(NamedTuple):
    """``w_ata`` f32[E,6,6] = JA^T W' JA; ``w_btb`` f32[E,3,3] = JB^T W' JB;
    ``w_hpl`` f32[E,6,3] = JA^T W' JB; ``bp_c`` f32[E,6] = JA^T W' r;
    ``bl_c`` f32[E,3] = JB^T W' r, with W' = huber_w * mask * info."""

    w_ata: torch.Tensor
    w_btb: torch.Tensor
    w_hpl: torch.Tensor
    bp_c: torch.Tensor
    bl_c: torch.Tensor
    robust_err: torch.Tensor
    chi2: torch.Tensor


def reproj_edge_blocks(
    poses, landmarks, intrinsics, pose_idx, lm_idx, meas, info, mask,
    huber_delta: float,
) -> ReprojBlocks:
    rp = res3.eval_reproj_edges(poses, landmarks, intrinsics, pose_idx,
                                lm_idx, meas, info, mask, huber_delta)
    w_rp = rp.w[:, None, None] * info               # [E, 2, 2]
    wjb = bm.mm(w_rp, rp.JB)                        # [E, 2, 3]
    wr = bm.mv(w_rp, rp.r)                          # [E, 2]
    return ReprojBlocks(
        w_ata=bm.quad(rp.JA, w_rp),
        w_btb=bm.mtm(rp.JB, wjb),
        w_hpl=bm.mtm(rp.JA, wjb),
        bp_c=bm.mtv(rp.JA, wr),
        bl_c=bm.mtv(rp.JB, wr),
        robust_err=rp.robust_err,
        chi2=rp.chi2,
    )
