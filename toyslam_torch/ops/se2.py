"""SE(2) operations on ``[..., 3]`` tensors of ``(x, y, theta)``.

All functions broadcast over leading batch dimensions.
"""

from __future__ import annotations

import torch


def wrap_angle(theta: torch.Tensor) -> torch.Tensor:
    """Wrap angles to (-pi, pi]."""
    return torch.atan2(torch.sin(theta), torch.cos(theta))


def rotation(theta: torch.Tensor) -> torch.Tensor:
    """``[..., 2, 2]`` rotation matrix for ``[...]`` angles."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack(
        [torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2
    )


def identity(batch_shape: tuple = (), dtype=torch.float32,
             device=None) -> torch.Tensor:
    """The identity pose, ``[*batch_shape, 3]`` zeros."""
    return torch.zeros(batch_shape + (3,), dtype=dtype, device=device)


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Group product ``a ⊕ b``."""
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = a[..., 0] + ca * b[..., 0] - sa * b[..., 1]
    y = a[..., 1] + sa * b[..., 0] + ca * b[..., 1]
    th = wrap_angle(a[..., 2] + b[..., 2])
    return torch.stack([x, y, th], dim=-1)


def inverse(a: torch.Tensor) -> torch.Tensor:
    """Group inverse."""
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = -(ca * a[..., 0] + sa * a[..., 1])
    y = -(-sa * a[..., 0] + ca * a[..., 1])
    return torch.stack([x, y, -a[..., 2]], dim=-1)


def transform_point(pose: torch.Tensor, pt: torch.Tensor) -> torch.Tensor:
    """World coordinates of a body-frame point."""
    c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
    x = pose[..., 0] + c * pt[..., 0] - s * pt[..., 1]
    y = pose[..., 1] + s * pt[..., 0] + c * pt[..., 1]
    return torch.stack([x, y], dim=-1)


def inv_transform_point(pose: torch.Tensor, pt: torch.Tensor) -> torch.Tensor:
    """Body-frame coordinates of a world point."""
    c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
    dx = pt[..., 0] - pose[..., 0]
    dy = pt[..., 1] - pose[..., 1]
    return torch.stack([c * dx + s * dy, -s * dx + c * dy], dim=-1)


def retract(pose: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Additive-xy, angle-recompose retraction (not the SE(2) exponential
    map): the vertex update of the upstream optimizer."""
    return torch.stack(
        [
            pose[..., 0] + delta[..., 0],
            pose[..., 1] + delta[..., 1],
            wrap_angle(pose[..., 2] + delta[..., 2]),
        ],
        dim=-1,
    )


def to_matrix(pose: torch.Tensor) -> torch.Tensor:
    """``[..., 3, 3]`` homogeneous matrix."""
    c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
    z = torch.zeros_like(c)
    o = torch.ones_like(c)
    rows = [
        torch.stack([c, -s, pose[..., 0]], dim=-1),
        torch.stack([s, c, pose[..., 1]], dim=-1),
        torch.stack([z, z, o], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def from_matrix(mat: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`to_matrix` (theta via atan2)."""
    theta = torch.atan2(mat[..., 1, 0], mat[..., 0, 0])
    return torch.stack([mat[..., 0, 2], mat[..., 1, 2], theta], dim=-1)


def relative(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a^-1 ⊕ b`` — the motion taking frame ``a`` to frame ``b``."""
    return compose(inverse(a), b)


def radial_to_euclidean(meas: torch.Tensor) -> torch.Tensor:
    """(range, bearing) -> body-frame (x, y)."""
    return torch.stack(
        [
            meas[..., 0] * torch.cos(meas[..., 1]),
            meas[..., 0] * torch.sin(meas[..., 1]),
        ],
        dim=-1,
    )


def euclidean_to_radial(pt: torch.Tensor) -> torch.Tensor:
    """Body-frame (x, y) -> (range, bearing)."""
    rng = torch.sqrt(pt[..., 0] ** 2 + pt[..., 1] ** 2)
    ang = torch.atan2(pt[..., 1], pt[..., 0])
    return torch.stack([rng, ang], dim=-1)
