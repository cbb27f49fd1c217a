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
:func:`slab_band_matvec_ref`.  The kernel reads the slab once: tiles of 32
landmarks, each on a thread-block cluster whose blocks hold a share of the
window in registers (:func:`slab_plan`), write per-tile partial rows, and a
second launch sums them in a fixed order.
"""

from __future__ import annotations

import ctypes
import dataclasses
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


TL = 32                  # landmarks per tile: a warp's lanes
MAX_CLUSTER = 8          # the portable thread-block cluster size
MAX_NW = 8               # window rows a warp holds in registers, at most
# Rows a block takes: a window of up to 64 rows on one block of 8 warps (no
# cluster to wait on); else up to 56 rows a block on 8 warps (7 rows a
# warp, three blocks an SM) where W <= 8 * 56, and up to 96 on 16 warps (6
# rows a warp, two blocks an SM) above.  The plan takes the least cluster
# that keeps a block within that: the fastest of chip_smoke.py's cluster
# sweep (phase 28) at W = 64, 320 and 576.
ROWS_1, ROWS_8, ROWS_16 = 64, 56, 96


@dataclasses.dataclass(frozen=True)
class SlabPlan:
    """How the kernel cuts one matvec: tiles of ``tl`` landmarks, each on a
    cluster of ``cs`` blocks of ``warps`` warps that hold ``wb`` window rows
    each (``cs * wb >= W``), ``nw`` rows a warp, ``smem_bytes`` of shared
    memory a block, and a partial row of ``sp = wb + tl - 1`` poses per
    block and component."""

    tl: int
    cs: int
    warps: int
    wb: int
    nw: int
    smem_bytes: int

    @property
    def sp(self) -> int:
        return self.wb + self.tl - 1

    def part_shape(self, n_chunks: int, B: int) -> tuple:
        """The partial buffer ``[tiles, cs, 3, sp]``."""
        return (n_chunks * -(-B // self.tl), self.cs, DP, self.sp)


def _smem_bytes(warps: int, nw: int) -> int:
    """One block's shared memory (csrc/slab_band_matvec.cu
    ``slab_tile<WARPS, NW>``): the x window [3, warps*nw + 31], the warps'
    partial t [warps, 2, 32], the rank's and the tile's t [2, 32] each, and
    the warps' diagonal sums [warps, 3, nw + 31]."""
    return 4 * (DP * (warps * nw + TL - 1) + (warps + 2) * DL * TL
                + warps * DP * (nw + TL - 1))


@functools.lru_cache(maxsize=None)
def slab_plan(W: int, B: int, cs: int | None = None) -> SlabPlan:
    """The tile plan for window ``W`` and chunk ``B``: one block for
    ``W <= ROWS_1``, else the least cluster size whose blocks take at most
    ``ROWS_8`` rows (``W <= 8 * ROWS_8``) or ``ROWS_16``; or ``cs`` when
    given (then cut to the ranks that hold a row: ``ceil(W / ceil(W /
    cs))``).  8 warps a block up to 64 rows, else 16.  Raises
    ``ValueError`` when a warp would hold more than ``MAX_NW`` rows even
    at 8 blocks."""
    if W < 1 or B < 1:
        raise ValueError(f"slab_plan: W={W}, B={B}; both must be >= 1")
    if cs is not None and not 1 <= cs <= MAX_CLUSTER:
        raise ValueError(f"slab_plan: cs={cs}, expected 1..{MAX_CLUSTER}")
    if cs is None:
        rows = (ROWS_1 if W <= ROWS_1 else
                ROWS_8 if W <= MAX_CLUSTER * ROWS_8 else ROWS_16)
        cs = next((k for k in range(1, MAX_CLUSTER + 1)
                   if -(-W // k) <= rows), MAX_CLUSTER)
    wb = -(-W // cs)
    warps = 8 if wb <= 8 * MAX_NW else 16
    nw = -(-wb // warps)
    if nw > MAX_NW:
        raise ValueError(
            f"slab_plan: W={W} needs {nw} window rows a warp at cs={cs}, "
            f"more than the {MAX_NW} a warp holds in registers")
    return SlabPlan(TL, -(-W // wb), warps, wb, nw, _smem_bytes(warps, nw))


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's shared library (built at first use), with its C
    signature declared."""
    from toyslam_torch import kernels

    lib = kernels.load("slab_band_matvec").lib
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.slab_band_matvec_launch.argtypes = [ci] * 6 + [vp] * 5
    lib.slab_band_matvec_launch.restype = ci
    lib.slab_band_matvec_pass_ms.argtypes = [ci] * 6 + [vp] * 4 + [
        ci, ctypes.POINTER(ctypes.c_float), vp]
    lib.slab_band_matvec_pass_ms.restype = ci
    lib.slab_band_matvec_attrs.argtypes = [
        ci, ci, ctypes.POINTER(ctypes.c_longlong)]
    lib.slab_band_matvec_attrs.restype = ci
    return lib


def _tile_attrs(plan: SlabPlan) -> dict:
    """The compiled tile kernel of ``plan`` as the card reports it: its
    static shared memory and local memory (spilled registers) in bytes a
    block and thread, and its registers a thread."""
    out = (ctypes.c_longlong * 3)()
    err = _library().slab_band_matvec_attrs(plan.warps, plan.nw, out)
    if err != 0:
        raise RuntimeError(f"slab_band_matvec_attrs: cudaError_t {err}")
    return {"smem_bytes": out[0], "local_bytes": out[1],
            "registers": out[2]}


def _check_args(x: torch.Tensor, slab: torch.Tensor, W: int, B: int,
                dev: torch.device):
    """Raise on what the contract does not take (``dev`` is ``x.device``);
    the wrapper checks CPU tensors too, so both devices see one
    contract."""
    if W < 1 or B < 1:
        raise ValueError(f"slab_band_matvec: W={W}, B={B}; both must be >= 1")
    if x.dim() != 2 or x.shape[0] != DP:
        raise ValueError(f"x: shape {tuple(x.shape)}, expected ({DP}, Np)")
    np_ = x.shape[1]
    _check("x", x, (DP, np_), torch.float32, dev)
    _check("slab", slab, (np_ // B, W, DP * DL, B), torch.float32, dev)


_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(index: int) -> int:
    """The current stream's handle on card ``index``, from the raw getter
    that PyTorch's own compiled code uses (a ``torch.cuda.current_stream``
    object costs some 5 us a call, more than the rest of the wrapper's
    Python); from ``torch.cuda.current_stream`` on a PyTorch without that
    private getter."""
    if _RAW_STREAM is None:
        return torch.cuda.current_stream(index).cuda_stream
    return _RAW_STREAM(index)


def _cuda_args(x, slab, B, plan, dev):
    """The scratch, the output and the stream of a launch of ``plan`` on
    the card (raises for any other device)."""
    if dev.type != "cuda":
        raise ValueError(f"slab_band_matvec: no kernel for {dev}")
    part = torch.empty(plan.part_shape(slab.shape[0], B),
                       dtype=torch.float32, device=dev)
    return part, torch.empty_like(x), _stream(dev.index)


def _launch(x: torch.Tensor, slab: torch.Tensor, W: int, B: int,
            plan: SlabPlan) -> torch.Tensor:
    """Launch the kernel on the card with ``plan`` (the wrapper's, or one
    of another cluster size for the smoke's sweep) and count it in
    ``slab_band_matvec.launches``; the arguments are checked by the
    caller."""
    part, out, stream = _cuda_args(x, slab, B, plan, x.device)
    err = _library().slab_band_matvec_launch(
        x.shape[1], slab.shape[0], W, B, plan.cs, plan.warps, x.data_ptr(),
        slab.data_ptr(), part.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"slab_band_matvec launch failed: cudaError_t {err}")
    slab_band_matvec.launches += 1
    return out


def slab_band_matvec(x: torch.Tensor, slab: torch.Tensor, W: int,
                     B: int) -> torch.Tensor:
    """``V (V^T x)`` over the pose-banded ``slab``.  On CUDA tensors this
    launches the hand-written kernel (csrc/slab_band_matvec.cu: the tile
    launch on clusters of ``slab_plan(W, B).cs`` blocks, then the sum of
    its partials, on the current stream) and counts one launch in
    ``slab_band_matvec.launches``; it takes ``W <= 1024`` (8 blocks of 16
    warps x 8 rows in registers) and raises ``ValueError`` above.  On CPU
    tensors it runs :func:`slab_band_matvec_ref`, which takes any
    ``W >= 1``."""
    dev = x.device
    _check_args(x, slab, W, B, dev)
    if dev.type == "cpu":
        return slab_band_matvec_ref(x, slab, W, B)
    return _launch(x, slab, W, B, slab_plan(W, B))


slab_band_matvec.launches = 0


def pass_ms(x: torch.Tensor, slab: torch.Tensor, W: int, B: int,
            reps: int = 20) -> tuple[float, float]:
    """The kernel's device ms per tile launch and per partial sum, averaged
    over ``reps`` matvecs launched back to back and timed with CUDA events
    between the two.  For measurement: launches the kernel without
    counting it, and waits for the stream."""
    _check_args(x, slab, W, B, x.device)
    if x.device.type != "cuda":
        raise ValueError(f"pass_ms: times the kernel, on CUDA tensors only, "
                         f"not on {x.device}")
    plan = slab_plan(W, B)
    part, out, stream = _cuda_args(x, slab, B, plan, x.device)
    ms = (ctypes.c_float * 2)()
    err = _library().slab_band_matvec_pass_ms(
        x.shape[1], slab.shape[0], W, B, plan.cs, plan.warps, x.data_ptr(),
        slab.data_ptr(), part.data_ptr(), out.data_ptr(), reps, ms, stream)
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
