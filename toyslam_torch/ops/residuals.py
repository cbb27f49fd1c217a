"""Batched residuals and analytic Jacobians for all edges of a type at once.

Jacobian conventions (those of ``toyslam_tpu.ops.residuals``):

* landmark edge: residual ``r = R(th)^T (lm - t) - [d cos(b), d sin(b)]``;
  ``A = dr/d(pose)`` (2x3), ``B = dr/d(lm)`` (2x2), the true Jacobians;
* odometry edge: residual ``odom^-1 ⊕ (p_i^-1 ⊕ p_j)`` with the upstream
  optimizer's approximation ``A = -I3, B = I3``; ``exact=True`` gives the
  true Jacobians of that residual in closed form (the JAX package takes
  them by ``jax.jacfwd``).
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
    """Residuals/Jacobians for all odometry edges: ``A = -I, B = I``, or
    with ``exact`` the true Jacobians (:func:`_exact_odom_jacobians`)."""
    pi, pj = poses[i], poses[j]
    r = se2.compose(se2.inverse(meas), se2.relative(pi, pj))
    if exact:
        JA, JB = _exact_odom_jacobians(pi, pj, meas)
    else:
        e = r.shape[0]
        eye = torch.eye(3, dtype=r.dtype, device=r.device)
        JA = (-eye).expand(e, 3, 3)
        JB = eye.expand(e, 3, 3)
    chi2 = bm.vwv(r, info, r) * mask
    robust_err, w = huber_weights(chi2, huber_delta)
    return EdgeEval(r, JA, JB, chi2, w * mask, robust_err * mask)


def _exact_odom_jacobians(
    a: torch.Tensor, b: torch.Tensor, m: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Closed-form ``d r / d a`` and ``d r / d b`` of
    ``r = m^-1 ⊕ (a^-1 ⊕ b)``.

    With ``q = R(ta)^T (tb - ta_xy)`` the relative translation,
    ``r_xy = R(tm)^T q + const`` and ``r_th = th_b - th_a - th_m``
    (wrapped, derivative 1), so
    ``dr_xy/da = R(tm)^T [-R(ta)^T | (q_y, -q_x)]``,
    ``dr_xy/db = R(tm)^T [ R(ta)^T | 0]``."""
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    cm, sm = torch.cos(m[..., 2]), torch.sin(m[..., 2])
    dx = b[..., 0] - a[..., 0]
    dy = b[..., 1] - a[..., 1]
    qx = ca * dx + sa * dy
    qy = -sa * dx + ca * dy
    # R(tm)^T R(ta)^T
    m00 = cm * ca - sm * sa
    m01 = cm * sa + sm * ca
    m10 = -sm * ca - cm * sa
    m11 = -sm * sa + cm * ca
    z = torch.zeros_like(ca)
    one = torch.ones_like(ca)
    JA = torch.stack([
        torch.stack([-m00, -m01, cm * qy - sm * qx], -1),
        torch.stack([-m10, -m11, -sm * qy - cm * qx], -1),
        torch.stack([z, z, -one], -1),
    ], -2)
    JB = torch.stack([
        torch.stack([m00, m01, z], -1),
        torch.stack([m10, m11, z], -1),
        torch.stack([z, z, one], -1),
    ], -2)
    return JA, JB


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
