"""Batched residuals and analytic Jacobians for all edges of a type at once.

Jacobian conventions (those of ``toyslam_tpu.ops.residuals``):

* landmark edge: residual ``r = R(th)^T (lm - t) - [d cos(b), d sin(b)]``;
  ``A = dr/d(pose)`` (2x3), ``B = dr/d(lm)`` (2x2), the true Jacobians;
* odometry edge: residual ``odom^-1 ⊕ (p_i^-1 ⊕ p_j)`` with the upstream
  optimizer's approximation ``A = -I3, B = I3``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from toyslam_torch.ops import blockmath as bm
from toyslam_torch.ops import se2


class EdgeEval(NamedTuple):
    """``r`` f32[E, d] residuals; ``JA`` f32[E, d, da], ``JB`` f32[E, d, db];
    ``chi2`` f32[E] unrobust ``r^T W r``; ``w`` f32[E] Huber weight;
    ``robust_err`` f32[E] robustified chi^2 contribution (masked)."""

    r: torch.Tensor
    JA: torch.Tensor
    JB: torch.Tensor
    chi2: torch.Tensor
    w: torch.Tensor
    robust_err: torch.Tensor


def huber_weights(
    chi2: torch.Tensor, delta: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Huber robustification applied to chi^2: inside ``delta^2`` the edge
    is untouched (err = chi2, w = 1); beyond it ``err = 2 sqrt(chi2) delta
    - delta^2`` and ``w = delta / sqrt(chi2)``."""
    delta_sq = delta * delta
    sqrt_e = torch.sqrt(torch.clamp(chi2, min=1e-30))
    inlier = chi2 <= delta_sq
    robust_err = torch.where(inlier, chi2, 2.0 * sqrt_e * delta - delta_sq)
    w = torch.where(inlier, 1.0, delta / sqrt_e)
    return robust_err, w


def eval_odom_edges(
    poses: torch.Tensor,
    i: torch.Tensor,
    j: torch.Tensor,
    meas: torch.Tensor,
    info: torch.Tensor,
    mask: torch.Tensor,
    huber_delta: float,
    exact: bool = False,
) -> EdgeEval:
    """Residuals/Jacobians for all odometry edges (``A = -I, B = I``)."""
    if exact:
        raise NotImplementedError(
            "exact_odom_jacobians=True is not ported yet (ROADMAP.md, "
            "queue A: exact_odom_jacobians)"
        )
    r = se2.compose(se2.inverse(meas), se2.relative(poses[i], poses[j]))
    e = r.shape[0]
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    JA = (-eye).expand(e, 3, 3)
    JB = eye.expand(e, 3, 3)
    chi2 = bm.vwv(r, info, r) * mask
    robust_err, w = huber_weights(chi2, huber_delta)
    return EdgeEval(r, JA, JB, chi2, w * mask, robust_err * mask)


def eval_landmark_edges(
    poses: torch.Tensor,
    landmarks: torch.Tensor,
    pose_idx: torch.Tensor,
    lm_idx: torch.Tensor,
    meas: torch.Tensor,
    info: torch.Tensor,
    mask: torch.Tensor,
    huber_delta: float,
) -> EdgeEval:
    """Residuals/Jacobians for all range-bearing landmark edges."""
    p = poses[pose_idx]           # [E, 3]
    lm = landmarks[lm_idx]        # [E, 2]
    r = se2.inv_transform_point(p, lm) - se2.radial_to_euclidean(meas)

    c, s = torch.cos(p[..., 2]), torch.sin(p[..., 2])
    x1, y1 = p[..., 0], p[..., 1]
    lx, ly = lm[..., 0], lm[..., 1]
    a00, a01, a02 = -c, -s, c * ly - s * lx - c * y1 + s * x1
    a10, a11, a12 = s, -c, -s * ly - c * lx + s * y1 + c * x1
    JA = torch.stack(
        [
            torch.stack([a00, a01, a02], dim=-1),
            torch.stack([a10, a11, a12], dim=-1),
        ],
        dim=-2,
    )
    JB = torch.stack(
        [torch.stack([c, s], dim=-1), torch.stack([-s, c], dim=-1)], dim=-2
    )
    chi2 = bm.vwv(r, info, r) * mask
    robust_err, w = huber_weights(chi2, huber_delta)
    return EdgeEval(r, JA, JB, chi2, w * mask, robust_err * mask)
