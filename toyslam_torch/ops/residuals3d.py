"""Batched residuals and Jacobians of the SE(3) edges: relative pose and
reprojection.

Jacobians are taken with respect to the tangent update the optimizer
applies (``se3.retract``: additive translation, right-multiplied
rotation), as in ``toyslam_tpu.ops.residuals3d``:

* relative-pose edge: residual ``log(meas^-1 . (T_i^-1 . T_j))`` in the
  decoupled (t, log R) chart.  ``exact=False`` keeps the 2D odometry
  approximation ``A = -I, B = I`` lifted to 6-dof; ``exact=True``
  differentiates the residual with ``torch.func.jacfwd`` under
  ``torch.func.vmap``, as the reference does with ``jax.jacfwd``;
* reprojection edge: pinhole projection of a world landmark into the
  camera at the pose (pose = camera-to-world), analytic 2x6 / 2x3
  Jacobians.  The depth is clamped at the camera's near plane: 1e-6, as
  in the reference, or a fifth intrinsic (fx, fy, cx, cy, near) where the
  graph gives one.  Below a given near plane the projection does not
  move with the depth, and its Jacobian has no depth column.  In float32
  a point at or behind a camera's plane makes normal equations the card
  cannot hold (entries up to ~1e21 at a depth of 1e-6, overflowing the
  3x3 inverses); a near plane bounds them.
"""

from __future__ import annotations

import torch

from toyslam_torch.ops import blockmath as bm
from toyslam_torch.ops import se3
from toyslam_torch.ops.residuals import EdgeEval, huber_weights


def _odom3d_residual(pi, pj, meas):
    return se3.log(se3.compose(se3.inverse(meas), se3.relative(pi, pj)))


def _odom3d_tangent_residual(eps_a, eps_b, a, b, m):
    return _odom3d_residual(se3.retract(a, eps_a), se3.retract(b, eps_b), m)


def eval_odom3d_edges(
    poses: torch.Tensor,
    i: torch.Tensor,
    j: torch.Tensor,
    meas: torch.Tensor,
    info: torch.Tensor,
    mask: torch.Tensor,
    huber_delta: float,
    exact: bool = False,
) -> EdgeEval:
    pi, pj = poses[i], poses[j]
    r = _odom3d_residual(pi, pj, meas)
    if exact:
        zeros = torch.zeros_like(r)
        JA, JB = torch.func.vmap(torch.func.jacfwd(
            _odom3d_tangent_residual, argnums=(0, 1)))(zeros, zeros, pi, pj,
                                                       meas)
        # forward mode carries some tangents of float32 expressions with
        # Python scalars as float64; the Jacobians are float32 like r
        JA, JB = JA.to(r.dtype), JB.to(r.dtype)
    else:
        eye = torch.eye(6, dtype=r.dtype, device=r.device)
        JA = (-eye).expand(r.shape[0], 6, 6)
        JB = eye.expand(r.shape[0], 6, 6)
    chi2 = bm.vwv(r, info, r) * mask
    robust_err, w = huber_weights(chi2, huber_delta)
    return EdgeEval(r, JA, JB, chi2, w * mask, robust_err * mask)


def near_plane(intrinsics: torch.Tensor):
    """The depth a projection is clamped at: the fifth intrinsic where the
    graph gives one, else 1e-6."""
    return intrinsics[4] if intrinsics.shape[-1] > 4 else 1e-6


def project(intrinsics: torch.Tensor, x_cam: torch.Tensor) -> torch.Tensor:
    """Pinhole projection of camera-frame points ``[..., 3] -> [..., 2]``."""
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    z = torch.clamp(x_cam[..., 2], min=near_plane(intrinsics))
    return torch.stack([fx * x_cam[..., 0] / z + cx,
                        fy * x_cam[..., 1] / z + cy], dim=-1)


def eval_reproj_edges(
    poses: torch.Tensor,
    landmarks: torch.Tensor,
    intrinsics: torch.Tensor,
    pose_idx: torch.Tensor,
    lm_idx: torch.Tensor,
    meas: torch.Tensor,
    info: torch.Tensor,
    mask: torch.Tensor,
    huber_delta: float,
) -> EdgeEval:
    """Reprojection residual and analytic Jacobians.

    ``x_c = R^T (X - t)``, ``r = project(x_c) - meas``; ``d x_c / d dt =
    -R^T``, ``d x_c / d omega = [x_c]_x`` (right-multiplied rotation
    update), ``d x_c / d X = R^T``: ``JA = J_proj [-R^T | [x_c]_x]`` (2x6),
    ``JB = J_proj R^T`` (2x3)."""
    p = poses[pose_idx]           # [E, 12]
    X = landmarks[lm_idx]         # [E, 3]
    Rt = se3.rot(p).transpose(-1, -2)
    x_c = bm.mv(Rt, X - se3.trans(p))
    r = project(intrinsics, x_c) - meas

    fx, fy = intrinsics[0], intrinsics[1]
    near = near_plane(intrinsics)
    inv_z = 1.0 / torch.clamp(x_c[..., 2], min=near)
    x_z = x_c[..., 0] * inv_z
    y_z = x_c[..., 1] * inv_z
    zeros = torch.zeros_like(inv_z)
    # the depth column, none below a given near plane
    dz = inv_z if intrinsics.shape[-1] == 4 else inv_z * (x_c[..., 2] > near)
    jp = torch.stack([
        torch.stack([fx * inv_z, zeros, -fx * x_z * dz], dim=-1),
        torch.stack([zeros, fy * inv_z, -fy * y_z * dz], dim=-1),
    ], dim=-2)                                   # J_proj [E, 2, 3]
    JA = torch.cat([bm.mm(jp, -Rt), bm.mm(jp, se3.hat(x_c))], dim=-1)
    JB = bm.mm(jp, Rt)

    chi2 = bm.vwv(r, info, r) * mask
    robust_err, w = huber_weights(chi2, huber_delta)
    return EdgeEval(r, JA, JB, chi2, w * mask, robust_err * mask)
