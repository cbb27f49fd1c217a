"""Tiny-block linear algebra as broadcast + reduce.

Batched 2x2/3x3 products written as elementwise multiplies with an explicit
sum over the 2-or-3-long axis: full float32 on every device (no TF32 matmul
path can reach them) and two kernels per product on the GPU.

Shapes use trailing block axes: ``A [..., a, b]``, vectors ``x [..., b]``.
"""

from __future__ import annotations


def mv(A, x):
    """``A @ x``: [..., a, b] x [..., b] -> [..., a]."""
    return (A * x[..., None, :]).sum(-1)


def mtv(A, x):
    """``A^T @ x``: [..., a, b] x [..., a] -> [..., b]."""
    return (A * x[..., :, None]).sum(-2)


def mm(A, B):
    """``A @ B``: [..., a, b] x [..., b, c] -> [..., a, c]."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)


def mtm(A, B):
    """``A^T @ B``: [..., a, b] x [..., a, c] -> [..., b, c]."""
    return (A[..., :, :, None] * B[..., :, None, :]).sum(-3)


def quad(J, W):
    """``J^T @ W @ J``: [..., r, d] x [..., r, r] -> [..., d, d]."""
    return mtm(J, mm(W, J))


def vwv(x, W, y):
    """``x^T W y`` -> [...]."""
    return (x[..., :, None] * W * y[..., None, :]).sum((-2, -1))
