"""SO(3)/SE(3) operations on flat ``[..., 12]`` pose tensors.

The layout of ``toyslam_tpu.ops.se3``:

* a pose is ``[..., 12]``: the row-major rotation (9), then the
  translation (3);
* the optimizer's tangent step is ``[..., 6]`` = (dt, omega);
* the retraction adds the translation and right-multiplies the rotation:
  ``t' = t + dt``, ``R' = R exp(omega^)``.

All functions broadcast over leading batch dimensions.  The 3x3 products
are the broadcast-and-reduce of ``ops/blockmath.py``: full float32 on every
device.  Rodrigues' formulas take a series near zero, and :func:`log_so3`
guards its untaken branch, so forward-mode derivatives
(``torch.func.jacfwd``, the exact odometry Jacobians) stay finite at the
identity.
"""

from __future__ import annotations

import torch

from toyslam_torch.ops import blockmath as bm

_EPS = 1e-8


def rot(pose: torch.Tensor) -> torch.Tensor:
    """``[..., 3, 3]`` rotation of a ``[..., 12]`` pose."""
    return pose[..., :9].reshape(pose.shape[:-1] + (3, 3))


def trans(pose: torch.Tensor) -> torch.Tensor:
    """``[..., 3]`` translation of a ``[..., 12]`` pose."""
    return pose[..., 9:12]


def make(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Pack rotation and translation into the flat ``[..., 12]`` layout."""
    return torch.cat([R.reshape(R.shape[:-2] + (9,)), t], dim=-1)


def identity(batch_shape: tuple = (), dtype=torch.float32,
             device=None) -> torch.Tensor:
    eye = torch.eye(3, dtype=dtype, device=device).reshape(9)
    return torch.cat([eye.expand(batch_shape + (9,)),
                      torch.zeros(batch_shape + (3,), dtype=dtype,
                                  device=device)], dim=-1)


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: ``[..., 3] -> [..., 3, 3]`` skew matrix."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], dim=-1),
        torch.stack([w[..., 2], z, -w[..., 0]], dim=-1),
        torch.stack([-w[..., 1], w[..., 0], z], dim=-1),
    ], dim=-2)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: ``[..., 3] -> [..., 3, 3]``, safe at ``|w| -> 0``."""
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    # sin(x)/x and (1 - cos x)/x^2 with series near zero
    small = theta2 < _EPS
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    K = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a[..., None, None] * K + b[..., None, None] * bm.mm(K, K)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`exp_so3`: rotation -> axis-angle ``[..., 3]``.

    Valid for angles in [0, pi); the factor-graph residuals take it of
    small relative rotations.  ``theta / sin(theta)`` switches to its
    series near the identity, and the untaken branch is evaluated at a safe
    argument (the double ``where``): ``arccos`` has an infinite derivative
    at 1, which would make the exact Jacobian NaN at an identity residual.
    The angle is clipped below pi (``cos >= -1 + 1e-7``)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0 + 1e-7, 1.0)
    w = 0.5 * torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], dim=-1)
    near_zero = cos_t > 1.0 - 1e-6
    safe_cos = torch.where(near_zero, torch.zeros_like(cos_t), cos_t)
    theta = torch.arccos(safe_cos)
    # theta^2 ~= 2 (1 - cos)  =>  theta / sin(theta) ~= 1 + (1 - cos) / 3
    scale = torch.where(near_zero, 1.0 + (1.0 - cos_t) / 3.0,
                        theta / torch.sin(theta))
    return w * scale[..., None]


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Group product ``a . b`` on ``[..., 12]`` poses."""
    Ra = rot(a)
    return make(bm.mm(Ra, rot(b)), trans(a) + bm.mv(Ra, trans(b)))


def inverse(a: torch.Tensor) -> torch.Tensor:
    Rt = rot(a).transpose(-1, -2)
    return make(Rt, -bm.mv(Rt, trans(a)))


def relative(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a^-1 . b``: the motion taking frame ``a`` to frame ``b``."""
    return compose(inverse(a), b)


def transform_point(pose: torch.Tensor, pt: torch.Tensor) -> torch.Tensor:
    """World coordinates of a body-frame point."""
    return trans(pose) + bm.mv(rot(pose), pt)


def inv_transform_point(pose: torch.Tensor, pt: torch.Tensor) -> torch.Tensor:
    """Body-frame coordinates of a world point: ``R^T (p - t)``."""
    return bm.mtv(rot(pose), pt - trans(pose))


def retract(pose: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Tangent update ``[..., 6]`` = (dt, omega): additive translation and
    right-multiplied rotation, not the full SE(3) exponential (the
    translation is not coupled through V(omega))."""
    return make(bm.mm(rot(pose), exp_so3(delta[..., 3:6])),
                trans(pose) + delta[..., :3])


def log(pose: torch.Tensor) -> torch.Tensor:
    """Residual readout ``[..., 6]`` = (t, log_so3(R)): the decoupled chart
    that matches :func:`retract`."""
    return torch.cat([trans(pose), log_so3(rot(pose))], dim=-1)


def orthonormalize(pose: torch.Tensor) -> torch.Tensor:
    """Project the rotation back onto SO(3) (Gram-Schmidt on rows)."""
    R = rot(pose)
    r0 = R[..., 0, :]
    r0 = r0 / torch.linalg.vector_norm(r0, dim=-1, keepdim=True)
    r1 = R[..., 1, :]
    r1 = r1 - (r0 * r1).sum(-1, keepdim=True) * r0
    r1 = r1 / torch.linalg.vector_norm(r1, dim=-1, keepdim=True)
    r2 = torch.linalg.cross(r0, r1, dim=-1)
    return make(torch.stack([r0, r1, r2], dim=-2), trans(pose))
