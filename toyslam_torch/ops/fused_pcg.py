"""Fused Schur/PCG: the conjugate-gradient loop in chunks of one kernel
launch each.

For graphs whose low-rank factor fits the kernel's budget the damped Schur
complement is re-expressed exactly as

    S = T - V V^T,   T = block-tridiagonal part of Hpp (odometry chain),
                     V = Hpl L^{-T} with Hll = L L^T      (landmark fill-in)
                         [+ chol(W) columns for loop-closure odometry]

and CG runs on it component-major ``[dp, Np]``.  One launch of the kernel
(``csrc/fused_pcg_chunk.cu``, wrapped by :func:`fused_pcg_chunk`) runs
``chunk_iters`` iterations and ends with the true residual ``rhs - S x``;
the host loop in :func:`fused_pcg` relaunches until that residual meets the
tolerance, the sticky breakdown stop is set, or ``ceil(max_iters / chunk)``
launches ran.  It reads one flag per chunk to the host.

The CPU path runs :func:`fused_pcg_chunk_ref`, the same chunk in plain
PyTorch; on a CUDA tensor the wrapper launches the kernel or raises.

Port of the resident half of ``toyslam_tpu.ops.fused_pcg``.  Not here yet:
the coarse-level construction (ROADMAP.md A.8) and the streamed band kernel
(ROADMAP.md B2).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from toyslam_torch.ops import blockmath as bm
from toyslam_torch.ops import schur

_f32 = torch.float32
_i32 = torch.int32

# Resident budget of the kernel on an H100.  The [dp, Np] state vectors and
# the V^T x row live in one block's shared memory (at most 227 KB, the
# opt-in maximum); the V slabs are read from global memory twice per matvec
# and stay fast only while they fit in L2 (50 MB) next to everything else.
SMEM_BUDGET_BYTES = 232_448
SLAB_BUDGET_BYTES = 40 * 2**20


class FusedOperator(NamedTuple):
    """The damped Schur operator in fused ``T - V V^T`` form."""

    u: torch.Tensor        # f32[dp, Np, Mw] per-component V rows; Mw = dl*M
    #                        + dp*C closure columns
    tdiag: torch.Tensor    # f32[dp, dp, Np] T diagonal blocks, component planes
    tupper: torch.Tensor   # f32[dp, dp, Np] T (v, v+1) blocks
    tlower: torch.Tensor   # f32[dp, dp, Np] T (v, v-1) blocks = upper[v-1]^T


class FusedPrecond(NamedTuple):
    """PCR block-tridiagonal (+ optional Galerkin coarse) preconditioner in
    plane layout.  ``alphas.shape[0] == 0`` means block-Jacobi."""

    alphas: torch.Tensor          # f32[L, dp, dp, Np]
    gammas: torch.Tensor          # f32[L, dp, dp, Np]
    binv: torch.Tensor            # f32[dp, dp, Np]
    cinv: torch.Tensor | None     # f32[dp, dp, nc, nc] coarse inverse blocks
    rmat: torch.Tensor | None     # f32[Np, nc] restriction matrix


class ChunkState(NamedTuple):
    """The CG state carried from one chunk launch to the next."""

    x: torch.Tensor      # f32[dp, Np]
    r: torch.Tensor      # f32[dp, Np] recurrence residual
    p: torch.Tensor      # f32[dp, Np] search direction
    rt: torch.Tensor     # f32[dp, Np] true residual at the end of the chunk
    it: torch.Tensor     # i32[1] live iterations so far
    rz: torch.Tensor     # f32[1] r^T M^-1 r
    stop: torch.Tensor   # i32[1] sticky breakdown flag
    rr: torch.Tensor     # f32[1] squared norm of the true residual


def _planes(blocks: torch.Tensor) -> torch.Tensor:
    """[N, a, b] block array -> [a, b, N] component planes."""
    return blocks.permute(1, 2, 0).contiguous()


def _chol_spd(a: torch.Tensor) -> torch.Tensor:
    """Batched closed-form Cholesky of tiny SPD blocks, pivots clamped at a
    tiny positive floor (the factor of a nearby SPD matrix)."""
    k = a.shape[-1]
    tiny = 1e-30
    if k == 2:
        l00 = torch.sqrt(torch.clamp(a[..., 0, 0], min=tiny))
        l10 = a[..., 1, 0] / l00
        l11 = torch.sqrt(torch.clamp(a[..., 1, 1] - l10 * l10, min=tiny))
        z = torch.zeros_like(l00)
        return torch.stack([
            torch.stack([l00, z], -1),
            torch.stack([l10, l11], -1),
        ], -2)
    if k == 3:
        l00 = torch.sqrt(torch.clamp(a[..., 0, 0], min=tiny))
        l10 = a[..., 1, 0] / l00
        l20 = a[..., 2, 0] / l00
        l11 = torch.sqrt(torch.clamp(a[..., 1, 1] - l10 * l10, min=tiny))
        l21 = (a[..., 2, 1] - l20 * l10) / l11
        l22 = torch.sqrt(
            torch.clamp(a[..., 2, 2] - l20 * l20 - l21 * l21, min=tiny)
        )
        z = torch.zeros_like(l00)
        return torch.stack([
            torch.stack([l00, z, z], -1),
            torch.stack([l10, l11, z], -1),
            torch.stack([l20, l21, l22], -1),
        ], -2)
    return torch.linalg.cholesky(a)


def _tri_inv_lower(l: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of batched lower-triangular 2x2/3x3 blocks."""
    k = l.shape[-1]
    if k == 2:
        m00 = 1.0 / l[..., 0, 0]
        m11 = 1.0 / l[..., 1, 1]
        m10 = -l[..., 1, 0] * m00 * m11
        z = torch.zeros_like(m00)
        return torch.stack([
            torch.stack([m00, z], -1),
            torch.stack([m10, m11], -1),
        ], -2)
    if k == 3:
        m00 = 1.0 / l[..., 0, 0]
        m11 = 1.0 / l[..., 1, 1]
        m22 = 1.0 / l[..., 2, 2]
        m10 = -l[..., 1, 0] * m00 * m11
        m21 = -l[..., 2, 1] * m11 * m22
        m20 = -(l[..., 2, 0] * m00 + l[..., 2, 1] * m10) * m22
        z = torch.zeros_like(m00)
        return torch.stack([
            torch.stack([m00, z, z], -1),
            torch.stack([m10, m11, z], -1),
            torch.stack([m20, m21, m22], -1),
        ], -2)
    raise ValueError(f"unsupported block size {k}")


def _closure_columns(d: schur.BlockSystem, aux, n: int, dp: int):
    """Loop-closure odometry as full-height +chol(W) column pairs, plus the
    +W diagonal compensation on T (see build_fused_operator).  The sums are
    the reference's ``segment_sum``s, here ``index_add_``."""
    c = aux.closure_e.shape[0]
    if not c:
        return None, None
    wcl = -d.hpp_off[aux.closure_e]                   # [C, dp, dp] PSD
    lcl = torch.linalg.cholesky(wcl)
    cid = torch.arange(c, device=wcl.device)
    ue = torch.zeros((n, c, dp, dp), dtype=_f32, device=wcl.device)
    ue.index_put_((aux.closure_i, cid), lcl, accumulate=True)
    ue.index_put_((aux.closure_j, cid), lcl, accumulate=True)
    ucols = ue.permute(2, 0, 1, 3).reshape(dp, n, dp * c)
    extra = torch.zeros((n, dp, dp), dtype=_f32, device=wcl.device)
    extra.index_add_(0, aux.closure_i, wcl)
    extra.index_add_(0, aux.closure_j, wcl)
    return ucols, extra


def build_fused_operator(
    d: schur.BlockSystem, hll_inv: torch.Tensor, graph
) -> FusedOperator:
    """Materialize ``T`` and the per-component ``V`` slabs.

    The per-edge ``Hpl L^{-T}`` blocks are laid out pose-major through the
    gather table, and a one-hot contraction over the slot axis places them
    into landmark columns (host-side setup, outside the kernel).
    """
    n, m = graph.num_poses, graph.num_landmarks
    dp = d.hpp_diag.shape[-1]
    dl = d.hll.shape[-1]
    # V = Hpl L^{-T} with hll = L L^T:  V V^T = Hpl Hll^{-1} Hlp exactly
    lh = _chol_spd(d.hll)                                  # [M, dl, dl]
    el = _tri_inv_lower(lh).transpose(-1, -2)              # L^{-T}
    blk = bm.mm(d.hpl, el[graph.lm_edges.lm])              # [E, dp, dl]
    tbl = graph.plan.lm_by_pose
    grid = blk[tbl.idx] * tbl.mask[..., None, None]        # [Np, Kp, dp, dl]
    lmg = graph.lm_edges.lm[tbl.idx]                       # [Np, Kp]
    onehot = (
        (lmg[..., None] == torch.arange(m, device=lmg.device)).to(_f32)
        * tbl.mask[..., None]
    )                                                      # [Np, Kp, M]
    z = torch.einsum("pkm,pkab->pmab", onehot, grid)       # [Np, M, dp, dl]
    u = z.permute(2, 0, 1, 3).reshape(dp, n, dl * m)

    tdiag = d.hpp_diag
    # loop-closure odometry: +chol(W) columns at rows i AND j give
    # (V V^T)[i,j] = +W, so S[i,j] = -W; the +W they add on the diagonals
    # is compensated on T
    ccols, extra = _closure_columns(d, graph.plan.fused, n, dp)
    if ccols is not None:
        u = torch.cat([u, ccols], dim=2)
        tdiag = tdiag + extra

    upper = schur.chain_upper(d, graph.odom.i, graph.odom.j, n)
    lower = schur._shift_down(upper, 1).transpose(-1, -2)
    return FusedOperator(
        u=u.contiguous(),
        tdiag=_planes(tdiag),
        tupper=_planes(upper),
        tlower=_planes(lower),
    )


def build_fused_precond(
    d: schur.BlockSystem,
    hll_inv: torch.Tensor,
    graph,
    s_diag: torch.Tensor,
    precond: str,
    coarse_group: int,
) -> FusedPrecond:
    """The local preconditioner in the kernel's plane layout: PCR factors
    of the block-tridiagonal part of S ("tridiag") or the inverse diagonal
    blocks ("jacobi")."""
    n = graph.num_poses
    dp = d.hpp_diag.shape[-1]
    local_kind, _, coarse_kind = precond.partition("+")
    if coarse_kind == "coarse":
        raise NotImplementedError(
            f"pcg_precond={precond!r}: the coarse-level construction "
            "(build_coarse_precond, spd_inverse) is not ported yet "
            "(ROADMAP.md A.8); the kernel itself takes a coarse level"
        )
    if local_kind == "tridiag":
        upper = schur.chain_upper(d, graph.odom.i, graph.odom.j, n)
        al, ga, binv = schur.build_tridiag_planes(
            s_diag.permute(1, 2, 0), upper.permute(1, 2, 0)
        )
        return FusedPrecond(al.contiguous(), ga.contiguous(),
                            binv.contiguous(), None, None)
    if local_kind != "jacobi":
        raise NotImplementedError(
            f"pcg_precond={precond!r}: the fused kernel takes 'jacobi' or "
            "'tridiag' local preconditioners"
        )
    alphas = torch.zeros((0, dp, dp, n), dtype=_f32, device=s_diag.device)
    return FusedPrecond(alphas, alphas, _planes(schur.inv_blocks(s_diag)),
                        None, None)


def chunk_smem_bytes(dp: int, np_: int, mw: int, nc: int) -> int:
    """Shared memory of one kernel launch: seven [dp, Np] vectors, the
    V^T x row, the coarse scratch and the reduction slots (mirrors
    ``smem_bytes`` in csrc/fused_pcg_chunk.cu)."""
    return 4 * (7 * dp * np_ + mw + 2 * dp * nc + 2 * 32 + 2)


def fused_mode(cfg, graph) -> str:
    """The gate: "resident" when the kernel can run this graph and config.

    Everything the reference's gate routes elsewhere raises here, naming
    what is missing: the plain PCG loop (``pcg_backend="xla"`` and the
    reference's fallbacks) and the streamed band kernel (graphs past the
    resident budget, ROADMAP.md B2)."""
    local_kind, _, coarse_kind = cfg.pcg_precond.partition("+")
    if cfg.pcg_backend == "xla" or cfg.pcg_unroll:
        raise NotImplementedError(
            "the plain PCG loop (the reference's pcg_backend='xla' / "
            "pcg_unroll path) is not ported yet (ROADMAP.md, queue A: "
            "pcg/schur_solve oracle)"
        )
    if graph.plan is None or graph.plan.fused is None:
        raise ValueError(
            "the fused solve needs the gather plan: call "
            "toyslam_torch.ops.gather_plan.attach_plan(graph) first"
        )
    if local_kind not in ("jacobi", "tridiag"):
        raise NotImplementedError(
            f"pcg_precond={cfg.pcg_precond!r}: the 'chunk' preconditioner "
            "runs only in the plain PCG loop, not ported yet (ROADMAP.md "
            "A.8)"
        )
    if cfg.solver != "schur":
        raise NotImplementedError(
            f"solver={cfg.solver!r}: only 'schur' is ported (ROADMAP.md §A)"
        )
    dp, dl = 3, 2
    n, m = graph.num_poses, graph.num_landmarks
    c = graph.plan.fused.closure_e.shape[0]
    if c and cfg.exact_odom_jacobians:
        raise NotImplementedError(
            "loop closures with exact odometry Jacobians take the plain "
            "PCG loop, not ported yet (ROADMAP.md §A)"
        )
    if coarse_kind == "coarse" and n % cfg.pcg_coarse_group:
        raise NotImplementedError(
            f"pcg_coarse_group={cfg.pcg_coarse_group} does not divide the "
            f"padded pose count {n}: the reference takes its plain PCG "
            "loop, not ported yet (ROADMAP.md §A)"
        )
    nc = -(-n // cfg.pcg_coarse_group) if coarse_kind == "coarse" else 0
    mw = dl * m + dp * c
    smem = chunk_smem_bytes(dp, n, mw, nc)
    slab = 4 * dp * n * mw
    if smem <= SMEM_BUDGET_BYTES and slab <= SLAB_BUDGET_BYTES:
        return "resident"
    raise NotImplementedError(
        f"graph with Np={n}, Mw={mw} exceeds the resident kernel's budget "
        f"(shared memory {smem} > {SMEM_BUDGET_BYTES} B or V slabs {slab} > "
        f"{SLAB_BUDGET_BYTES} B): it needs the streamed band kernel, not "
        "ported yet (ROADMAP.md B2)"
    )


# --- the chunk: plain version ------------------------------------------


def _shift(x: torch.Tensor, s: int) -> torch.Tensor:
    """Circular lane shift of ``x [dp, Np]``: ``y[:, p] = x[:, p - s]``.
    The coefficient planes vanish where it wraps."""
    return torch.roll(x, shifts=s, dims=-1)


def _bmv(planes: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Block matvec on component planes: [d,d,Np] x [d,Np] -> [d,Np]."""
    return (planes * x[None, :, :]).sum(1)


def fused_matvec_ref(op: FusedOperator, x: torch.Tensor) -> torch.Tensor:
    """``S x = T x - V (V^T x)`` for ``x [dp, Np]`` in plain PyTorch."""
    dp, n = x.shape
    y = _bmv(op.tdiag, x)
    y = y + _bmv(op.tupper, _shift(x, -1))   # upper[v] @ x[v+1]
    y = y + _bmv(op.tlower, _shift(x, 1))    # upper[v-1]^T @ x[v-1]
    v = op.u.reshape(dp * n, -1)
    urow = x.reshape(1, -1) @ v              # [1, Mw] = V^T x
    return y - (v @ urow.reshape(-1, 1)).reshape(dp, n)


def _precond_ref(pre: FusedPrecond, r: torch.Tensor) -> torch.Tensor:
    t = r
    s = 1
    for l in range(pre.alphas.shape[0]):
        t = (
            t
            + _bmv(pre.alphas[l], _shift(t, s))
            + _bmv(pre.gammas[l], _shift(t, -s))
        )
        s *= 2
    z = _bmv(pre.binv, t)
    if pre.cinv is not None:
        rc = r @ pre.rmat                                  # [dp, nc]
        za = torch.einsum("abgh,bh->ag", pre.cinv, rc)     # [dp, nc]
        z = z + za @ pre.rmat.T
    return z


def fused_pcg_chunk_ref(
    op: FusedOperator,
    pre: FusedPrecond,
    rhs: torch.Tensor,
    st: ChunkState,
    atol2: torch.Tensor,
    maxit: int,
    restart: bool,
    chunk_iters: int,
) -> ChunkState:
    """One chunk in plain PyTorch: the oracle of the kernel and the CPU
    path.  Same control as the kernel, without host syncs."""
    atol2 = atol2.reshape(())
    x = st.x
    r = st.rt if restart else st.r
    z = _precond_ref(pre, r)
    p = z if restart else st.p
    rz = (r * z).sum() if restart else st.rz.reshape(())
    rr = (r * r).sum()
    stop = st.stop.reshape(()) > 0
    it = st.it.reshape(())
    for _ in range(chunk_iters):
        ap = fused_matvec_ref(op, p)
        pap = (p * ap).sum()
        stop = stop | ~(pap > 0.0) | ~torch.isfinite(pap)
        done = stop | (rr <= atol2) | (it >= maxit)
        alpha = torch.where(done, 0.0, rz / torch.where(done, 1.0, pap))
        x = x + alpha * p
        r = r - alpha * ap
        z = _precond_ref(pre, r)
        rz_new = (r * z).sum()
        rr = (r * r).sum()
        beta = torch.where(
            done, 0.0, rz_new / torch.where(rz == 0.0, 1.0, rz)
        )
        p = torch.where(done, p, z + beta * p)
        rz = torch.where(done, rz, rz_new)
        it = it + (~done).to(it.dtype)
    r_true = rhs - fused_matvec_ref(op, x)
    return ChunkState(
        x=x, r=r, p=p, rt=r_true, it=it.reshape(1), rz=rz.reshape(1),
        stop=stop.to(_i32).reshape(1), rr=(r_true * r_true).sum().reshape(1),
    )


# --- the chunk: kernel ---------------------------------------------------


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's shared library (built at first use), with its C
    signatures declared."""
    from toyslam_torch import kernels

    lib = kernels.load("fused_pcg_chunk").lib
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.fused_pcg_chunk_launch.argtypes = [ci] * 8 + [vp] * 27
    lib.fused_pcg_chunk_launch.restype = ci
    lib.fused_pcg_chunk_smem_bytes.argtypes = [ci] * 4
    lib.fused_pcg_chunk_smem_bytes.restype = ctypes.c_longlong
    lib.fused_pcg_chunk_smem_optin.argtypes = [ci]
    lib.fused_pcg_chunk_smem_optin.restype = ctypes.c_longlong
    return lib


def _check(name: str, t: torch.Tensor, shape: tuple, dtype, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes {dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes contiguous tensors")


def _launch(op, pre, rhs, st, atol2, maxit, restart, chunk_iters):
    dev = rhs.device
    dp, n = rhs.shape
    mw = op.u.shape[-1]
    nl = pre.alphas.shape[0]
    has_coarse = pre.cinv is not None
    nc = pre.cinv.shape[-1] if has_coarse else 0
    if dp != 3:
        raise NotImplementedError(
            f"fused_pcg_chunk kernel: dp={dp}; only dp=3 (SE(2)) is built "
            "(dp=6 comes with the SE(3) port, ROADMAP.md A.16)"
        )
    vec = (dp, n)
    planes = (dp, dp, n)
    checks = [
        ("rhs", rhs, vec, _f32), ("x", st.x, vec, _f32),
        ("r", st.r, vec, _f32), ("p", st.p, vec, _f32),
        ("rt", st.rt, vec, _f32), ("it", st.it, (1,), _i32),
        ("rz", st.rz, (1,), _f32), ("stop", st.stop, (1,), _i32),
        ("atol2", atol2, (1,), _f32), ("u", op.u, (dp, n, mw), _f32),
        ("tdiag", op.tdiag, planes, _f32), ("tupper", op.tupper, planes, _f32),
        ("tlower", op.tlower, planes, _f32),
        ("alphas", pre.alphas, (nl,) + planes, _f32),
        ("gammas", pre.gammas, (nl,) + planes, _f32),
        ("binv", pre.binv, planes, _f32),
    ]
    if has_coarse:
        checks += [("cinv", pre.cinv, (dp, dp, nc, nc), _f32),
                   ("rmat", pre.rmat, (n, nc), _f32)]
    elif pre.rmat is not None:
        raise ValueError("rmat given without cinv")
    for name, t, shape, dtype in checks:
        _check(name, t, shape, dtype, dev)

    lib = _library()
    need = lib.fused_pcg_chunk_smem_bytes(dp, n, mw, nc)
    have = lib.fused_pcg_chunk_smem_optin(dev.index)
    if have < 0:
        raise RuntimeError("cudaDeviceGetAttribute failed")
    if need > have:
        raise ValueError(
            f"fused_pcg_chunk: Np={n}, Mw={mw} needs {need} B of shared "
            f"memory; {torch.cuda.get_device_name(dev)} allows {have} B"
        )
    out = ChunkState(
        x=torch.empty(vec, dtype=_f32, device=dev),
        r=torch.empty(vec, dtype=_f32, device=dev),
        p=torch.empty(vec, dtype=_f32, device=dev),
        rt=torch.empty(vec, dtype=_f32, device=dev),
        it=torch.empty(1, dtype=_i32, device=dev),
        rz=torch.empty(1, dtype=_f32, device=dev),
        stop=torch.empty(1, dtype=_i32, device=dev),
        rr=torch.empty(1, dtype=_f32, device=dev),
    )

    def ptr(t):
        return None if t is None or t.numel() == 0 else t.data_ptr()

    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.fused_pcg_chunk_launch(
        dp, n, mw, nl, nc, chunk_iters, int(maxit), int(bool(restart)),
        ptr(atol2), ptr(st.it), ptr(st.rz), ptr(st.stop),
        ptr(rhs), ptr(st.x), ptr(st.r), ptr(st.p), ptr(st.rt),
        ptr(op.u), ptr(op.tdiag), ptr(op.tupper), ptr(op.tlower),
        ptr(pre.alphas), ptr(pre.gammas), ptr(pre.binv),
        ptr(pre.cinv), ptr(pre.rmat),
        ptr(out.x), ptr(out.r), ptr(out.p), ptr(out.rt),
        ptr(out.it), ptr(out.rz), ptr(out.stop), ptr(out.rr),
        stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_pcg_chunk launch failed: cudaError_t {err}")
    fused_pcg_chunk.launches += 1
    return out


def fused_pcg_chunk(
    op: FusedOperator,
    pre: FusedPrecond,
    rhs: torch.Tensor,
    st: ChunkState,
    atol2: torch.Tensor,
    maxit: int,
    restart: bool,
    chunk_iters: int,
) -> ChunkState:
    """One chunk of PCG: ``chunk_iters`` iterations from ``st``, then the
    true residual.  On CUDA tensors this launches the hand-written kernel
    (csrc/fused_pcg_chunk.cu) and counts it in ``fused_pcg_chunk.launches``;
    on CPU tensors it runs :func:`fused_pcg_chunk_ref`."""
    if rhs.device.type == "cpu":
        return fused_pcg_chunk_ref(op, pre, rhs, st, atol2, maxit, restart,
                                   chunk_iters)
    if rhs.device.type != "cuda":
        raise ValueError(f"fused_pcg_chunk: no kernel for {rhs.device}")
    return _launch(op, pre, rhs, st, atol2, maxit, restart, chunk_iters)


fused_pcg_chunk.launches = 0


def fused_pcg(
    op: FusedOperator,
    pre: FusedPrecond,
    rhs2: torch.Tensor,        # f32[dp, Np]
    tol: float,
    max_iters: int,
    chunk_iters: int,
    restart_every: int = 64,
) -> schur.PCGResult:
    """PCG on the fused operator: true-residual replacement and direction
    restart every ``restart_every`` iterations (in whole chunks), masked
    no-op iterations after convergence or breakdown.  The convergence test
    reads one flag per chunk to the host."""
    dp, n = rhs2.shape
    rhs_norm2 = (rhs2 * rhs2).sum()
    atol2 = ((tol ** 2) * rhs_norm2).reshape(1)
    n_chunks = -(-max_iters // chunk_iters)
    restart_chunks = max(1, restart_every // chunk_iters)
    zeros = torch.zeros_like(rhs2)
    st = ChunkState(
        x=zeros, r=zeros, p=zeros,
        rt=rhs2,   # the true residual at x = 0
        it=torch.zeros(1, dtype=_i32, device=rhs2.device),
        rz=torch.zeros(1, dtype=_f32, device=rhs2.device),
        stop=torch.zeros(1, dtype=_i32, device=rhs2.device),
        rr=rhs_norm2.reshape(1),
    )
    k = 0
    while k < n_chunks and bool(
        ((st.rr > atol2) & (st.stop == 0)).item()   # host sync, once a chunk
    ):
        st = fused_pcg_chunk(op, pre, rhs2, st, atol2, max_iters,
                             k % restart_chunks == 0, chunk_iters)
        k += 1
    return schur.PCGResult(
        x=st.x, iterations=st.it[0], residual_norm=torch.sqrt(st.rr[0]),
    )


def fused_schur_solve(
    sys: schur.BlockSystem,
    graph,
    lam: torch.Tensor,
    tol: float,
    max_iters: int,
    precond: str,
    coarse_group: int,
    chunk_iters: int,
    restart_every: int = 64,
    mode: str = "resident",
) -> tuple[torch.Tensor, torch.Tensor, schur.SolveStats]:
    """Damp, eliminate the landmarks, run the fused PCG on the reduced
    pose system, back-substitute the landmarks.  Returns
    ``(dx_poses [N,3], dx_landmarks [M,2], stats)``."""
    if mode != "resident":
        raise NotImplementedError(
            f"fused mode {mode!r}: only the resident kernel is ported; the "
            "streamed band kernel is ROADMAP.md B2"
        )
    plan = graph.plan
    d = schur.damp(sys, lam)
    hll_inv = schur.inv_blocks(d.hll)
    rhs = -d.bp + schur.hpl_matvec(
        d, graph.lm_edges.lm, bm.mv(hll_inv, d.bl), plan
    )
    s_diag = schur.schur_s_diag(d, hll_inv, graph)
    pre = build_fused_precond(d, hll_inv, graph, s_diag, precond,
                              coarse_group)
    op = build_fused_operator(d, hll_inv, graph)
    res = fused_pcg(op, pre, rhs.T.contiguous(), tol, max_iters,
                    chunk_iters, restart_every)
    dx_p = res.x.T
    u = schur.hlp_matvec(d, graph.lm_edges.pose, dx_p, plan)
    dx_l = bm.mv(hll_inv, -d.bl - u)
    stats = schur.SolveStats(pcg_iters=res.iterations,
                             pcg_residual=res.residual_norm)
    return dx_p, dx_l, stats
