"""The PCR factorization of the block-tridiagonal preconditioner in one
launch of a hand-written kernel (``csrc/pcr_factor.cu``).

:func:`pcr_factor` takes the diagonal blocks and the chain superdiagonal in
the block layout the callers hold (``diag, upper [N, dp, dp]``, float32,
contiguous, on the card) and returns every level of the parallel cyclic
reduction in the layout kernels B1 and B2 read: ``alphas, gammas [L, dp,
dp, N]`` and ``binv [dp, dp, N]``, ``L = max(1, ceil(log2 N))``.  Its plain
version is ``schur.build_tridiag_planes_ref``; ``schur.build_tridiag_planes``
takes the kernel for CUDA tensors and the plain version on the CPU.

The kernel is one cooperative grid of a pose a thread, as many blocks as
N needs and the card runs at once, with its state in a workspace the
wrapper allocates.  Each launch counts in ``pcr_factor.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

# the pose block sizes the kernel is built for (those of B1 and B2,
# fused_pcg.KERNEL_DPS): SE(2) and SE(3)
DPS = (3, 6)


def pcr_levels(n: int) -> int:
    """PCR levels of an ``n``-pose chain (those of the plain version)."""
    return max(1, (n - 1).bit_length())


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's shared library (built at first use), with its C
    signatures declared."""
    from toyslam_torch import kernels

    lib = kernels.load("pcr_factor").lib
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    pi = ctypes.POINTER(ci)
    lib.pcr_factor_layout.argtypes = [ci, pi, pi]
    lib.pcr_factor_layout.restype = ci
    lib.pcr_factor_grid_fit.argtypes = [ci, ci, pi]
    lib.pcr_factor_grid_fit.restype = ci
    lib.pcr_factor_attrs.argtypes = [ci, ctypes.POINTER(cll)]
    lib.pcr_factor_attrs.restype = ci
    lib.pcr_factor_launch.argtypes = [ci, ci, ci, ci] + [vp] * 7
    lib.pcr_factor_launch.restype = ci
    return lib


@functools.cache
def layout(dp: int) -> tuple[int, int]:
    """``(threads a block, workspace floats a pose)`` of the kernel's
    instantiation for ``dp``, as the kernel states them."""
    threads, floats = ctypes.c_int(0), ctypes.c_int(0)
    if _library().pcr_factor_layout(dp, ctypes.byref(threads),
                                    ctypes.byref(floats)) != 0:
        raise ValueError(f"pcr_factor kernel: no instantiation for dp={dp}")
    return threads.value, floats.value


@functools.cache
def grid_fit(device_index: int, dp: int) -> int:
    """Blocks of the kernel the card runs at once (the most a cooperative
    launch takes), queried once per (device, dp); raises where the card
    runs none."""
    blocks = ctypes.c_int(0)
    err = _library().pcr_factor_grid_fit(dp, device_index,
                                         ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"pcr_factor: occupancy query failed: "
                           f"cudaError_t {err}")
    if blocks.value < 1:
        raise RuntimeError(f"pcr_factor: {torch.cuda.get_device_name(device_index)}"
                           " runs no cooperative grid of the kernel")
    return blocks.value


def pcr_kernel_attrs(dp: int) -> dict:
    """The kernel's instantiation for ``dp`` as the card compiled it: its
    registers a thread and its local memory a thread (spilled
    registers)."""
    out = (ctypes.c_longlong * 2)()
    err = _library().pcr_factor_attrs(dp, out)
    if err != 0:
        raise RuntimeError(f"pcr_factor_attrs failed: cudaError_t {err}")
    return {"registers": out[0], "local_bytes": out[1]}


def _check(diag: torch.Tensor, upper: torch.Tensor) -> tuple[int, int]:
    """``(n, dp)`` of operands the kernel takes; raises on any other."""
    if diag.dim() != 3 or diag.shape[1] != diag.shape[2] or diag.shape[0] < 1:
        raise ValueError(f"pcr_factor: diag of shape {tuple(diag.shape)}, "
                         "the kernel takes [N, dp, dp]")
    n, dp = diag.shape[0], diag.shape[1]
    if dp not in DPS:
        raise ValueError(f"pcr_factor kernel: dp={dp}; it is built for dp in "
                         f"{DPS} (SE(2), SE(3))")
    if tuple(upper.shape) != tuple(diag.shape):
        raise ValueError(f"pcr_factor: upper of shape {tuple(upper.shape)} != "
                         f"diag's {tuple(diag.shape)}")
    for name, t in (("diag", diag), ("upper", upper)):
        if t.dtype != torch.float32:
            raise TypeError(f"pcr_factor: {name} of dtype {t.dtype}, the "
                            "kernel takes torch.float32")
        if not t.is_contiguous():
            raise ValueError(f"pcr_factor: {name} is not contiguous; the "
                             "kernel reads the block layout as stored")
    if upper.device != diag.device:
        raise ValueError(f"pcr_factor: upper on {upper.device}, diag on "
                         f"{diag.device}")
    if diag.device.type != "cuda":
        raise ValueError(f"pcr_factor: no kernel for {diag.device}")
    return n, dp


def pcr_factor(
    diag: torch.Tensor, upper: torch.Tensor, *, blocks: int | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """PCR factors of ``tridiag(upper^T, diag, upper)`` in one launch of the
    hand-written kernel on the current stream: ``diag, upper [N, dp, dp]``
    float32, contiguous, on one CUDA device (``upper[v]`` the (v, v+1)
    block), dp in ``DPS``; raises on anything else.  Returns ``(alphas
    [L,dp,dp,N], gammas [L,dp,dp,N], binv [dp,dp,N])``, the plain
    version's (``schur.build_tridiag_planes_ref``) layout.  ``blocks`` sets
    the grid's blocks (a test of the grid-stride loop); by default a pose a
    thread, up to what the card runs at once."""
    n, dp = _check(diag, upper)
    dev = diag.device
    levels = pcr_levels(n)
    threads, floats = layout(dp)
    if blocks is None:
        blocks = min(-(-n // threads), grid_fit(dev.index or 0, dp))
    work = torch.empty(floats * n, dtype=torch.float32, device=dev)
    alphas = torch.empty((levels, dp, dp, n), dtype=torch.float32, device=dev)
    gammas = torch.empty_like(alphas)
    binv = torch.empty((dp, dp, n), dtype=torch.float32, device=dev)
    err = _library().pcr_factor_launch(
        dp, n, levels, blocks, diag.data_ptr(), upper.data_ptr(),
        alphas.data_ptr(), gammas.data_ptr(), binv.data_ptr(),
        work.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pcr_factor launch failed: cudaError_t {err}")
    pcr_factor.launches += 1
    return alphas, gammas, binv


pcr_factor.launches = 0
