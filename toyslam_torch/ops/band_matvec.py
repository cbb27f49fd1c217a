"""B3: one matvec with the landmark fill factor ``V`` held as a pose-banded
slab, ``out = V (V^T x)``, and its plain PyTorch version.

Shapes (SE(2): ``DP = 3`` pose components, ``DL = 2`` landmark
components): ``x [3, Np]``, ``slab [n_chunks, W, 6, B]`` with row
``a * DL + b``, ``out [3, Np]``, all f32.  Landmark ``l = c * B + p`` has
base pose ``l`` and window poses ``l .. l + W - 1``:

    t[b, l]        = sum_{w,a} slab[c, w, a*DL+b, p] * x[a, l+w]
    out[a, l + w] += sum_b     slab[c, w, a*DL+b, p] * t[b, l]

with ``x`` zero past ``Np`` and what lands past ``Np`` dropped.

Port of the JAX package's prototype ``scripts/exp_band_kernel.py``
(``band_matvec_kernel``, ``make_fn``, ``oracle``).  Its inputs are numpy
arrays in this same layout, so ``torch.from_numpy`` carries them across
unchanged: no converter is needed.  Not to be confused with
``fused_pcg.band_matvec_ref``, which is B2's windowed tile-stack layout.

:func:`slab_band_matvec` launches the hand-written kernel
(``csrc/slab_band_matvec.cu``) on CUDA tensors and counts it in
``slab_band_matvec.launches``; on CPU tensors it runs
:func:`slab_band_matvec_ref`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from toyslam_torch.ops.fused_pcg import _check

DP, DL = 3, 2


def slab_band_matvec_ref(x: torch.Tensor, slab: torch.Tensor, W: int,
                         B: int) -> torch.Tensor:
    """``V (V^T x)`` in plain PyTorch: the windows gathered with one index
    ``c*B + p + w`` over ``[n_chunks, W, B]``, two einsums, and an
    ``index_add_`` into ``[3, Np + W]`` cut to ``Np``."""
    np_ = x.shape[1]
    n_chunks = slab.shape[0]
    dev = x.device
    idx = (torch.arange(n_chunks, device=dev)[:, None, None] * B
           + torch.arange(W, device=dev)[None, :, None]
           + torch.arange(B, device=dev)[None, None, :])    # [nc, W, B]
    xext = torch.cat([x, x.new_zeros((DP, W))], dim=1)
    xw = xext[:, idx]                                     # [3, nc, W, B]
    s = slab.reshape(n_chunks, W, DP, DL, B)
    t = torch.einsum("cwabp,acwp->bcp", s, xw)             # [2, nc, B]
    contrib = torch.einsum("cwabp,bcp->acwp", s, t)        # [3, nc, W, B]
    wacc = x.new_zeros((DP, np_ + W))
    wacc.index_add_(1, idx.reshape(-1), contrib.reshape(DP, -1))
    return wacc[:, :np_]


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's shared library (built at first use), with its C
    signature declared."""
    from toyslam_torch import kernels

    lib = kernels.load("slab_band_matvec").lib
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.slab_band_matvec_launch.argtypes = [ci] * 4 + [vp] * 5
    lib.slab_band_matvec_launch.restype = ci
    lib.slab_band_matvec_pass_ms.argtypes = [ci] * 4 + [vp] * 4 + [
        ci, ctypes.POINTER(ctypes.c_float), vp]
    lib.slab_band_matvec_pass_ms.restype = ci
    return lib


def _check_args(x: torch.Tensor, slab: torch.Tensor, W: int, B: int):
    """Raise on what the kernel does not take; the wrapper checks CPU
    tensors too, so both devices see one contract."""
    if W < 1 or B < 1:
        raise ValueError(f"slab_band_matvec: W={W}, B={B}; both must be >= 1")
    if x.dim() != 2 or x.shape[0] != DP:
        raise ValueError(f"x: shape {tuple(x.shape)}, expected ({DP}, Np)")
    np_ = x.shape[1]
    _check("x", x, (DP, np_), torch.float32, x.device)
    _check("slab", slab, (np_ // B, W, DP * DL, B), torch.float32, x.device)


def slab_band_matvec(x: torch.Tensor, slab: torch.Tensor, W: int,
                     B: int) -> torch.Tensor:
    """``V (V^T x)`` over the pose-banded ``slab``.  On CUDA tensors this
    launches the hand-written kernel (csrc/slab_band_matvec.cu: a t-pass
    and a w-pass on the current stream) and counts one launch in
    ``slab_band_matvec.launches``; on CPU tensors it runs
    :func:`slab_band_matvec_ref`."""
    _check_args(x, slab, W, B)
    if x.device.type == "cpu":
        return slab_band_matvec_ref(x, slab, W, B)
    if x.device.type != "cuda":
        raise ValueError(f"slab_band_matvec: no kernel for {x.device}")
    np_ = x.shape[1]
    n_chunks = slab.shape[0]
    t = torch.empty((DL, n_chunks * B), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _library().slab_band_matvec_launch(
        np_, n_chunks, W, B, x.data_ptr(), slab.data_ptr(), t.data_ptr(),
        out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"slab_band_matvec launch failed: cudaError_t {err}")
    slab_band_matvec.launches += 1
    return out


slab_band_matvec.launches = 0


def pass_ms(x: torch.Tensor, slab: torch.Tensor, W: int, B: int,
            reps: int = 20) -> tuple[float, float]:
    """The kernel's device ms per t-pass and per w-pass, averaged over
    ``reps`` matvecs launched back to back and timed with CUDA events
    between the passes.  For measurement: launches the kernel without
    counting it, and waits for the stream."""
    _check_args(x, slab, W, B)
    if x.device.type != "cuda":
        raise ValueError(f"pass_ms: times the kernel, on CUDA tensors only, "
                         f"not on {x.device}")
    np_ = x.shape[1]
    n_chunks = slab.shape[0]
    t = torch.empty((DL, n_chunks * B), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    ms = (ctypes.c_float * 2)()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _library().slab_band_matvec_pass_ms(
        np_, n_chunks, W, B, x.data_ptr(), slab.data_ptr(), t.data_ptr(),
        out.data_ptr(), reps, ms, stream)
    if err != 0:
        raise RuntimeError(f"slab_band_matvec_pass_ms: cudaError_t {err}")
    return ms[0], ms[1]


def bound(np_: int, W: int, B: int) -> dict:
    """The least time an H100 could take for one matvec: ``x``, the slab and
    ``out`` each moved once at 3.35 TB/s, or ``24 * W`` f32 operations per
    landmark at 67 TFLOP/s (NVIDIA's data sheet, SXM at 700 W), whichever is
    larger."""
    nl = (np_ // B) * B
    moved = 4 * (2 * DP * np_ + nl * W * DP * DL)
    ops = 24 * W * nl
    by_bytes, by_ops = moved / 3.35e12, ops / 67e12
    return {"bytes": moved, "flops": ops,
            "bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}
