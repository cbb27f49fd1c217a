"""Fused Schur/PCG: the conjugate-gradient loop in chunks of one kernel
launch each.

For graphs whose low-rank factor fits the kernel's budget the damped Schur
complement is re-expressed exactly as

    S = T - V V^T,   T = block-tridiagonal part of Hpp (odometry chain),
                     V = Hpl L^{-T} with Hll = L L^T      (landmark fill-in)
                         [+ chol(W) columns for loop-closure odometry]

and CG runs on it component-major ``[dp, Np]``.  Two kernels run one chunk
of it each: ``chunk_iters`` iterations, ending with the true residual
``rhs - S x``.  The host loop (:func:`fused_pcg`, :func:`band_fused_pcg`)
relaunches until that residual meets the tolerance, the sticky breakdown
stop is set, or ``ceil(max_iters / chunk)`` launches ran; it reads one flag
per chunk to the host.

* resident (``csrc/fused_pcg_chunk.cu``, :func:`fused_pcg_chunk`): V as
  dense slabs ``u [dp, Np, Mw]`` split by columns over one thread-block
  cluster (:func:`b1_layout`);
* band (``csrc/band_fused_pcg_chunk.cu``, :func:`band_fused_pcg_chunk`):
  for large graphs, V as the tile stack of ``ops/band_plan.py`` streamed
  from device memory once per matvec by a cooperative grid of one block
  per SM (:func:`band_slab_plan`), plus a few full-height wide columns.

Both kernels are instantiated for SE(2) (dp=3, landmarks dl=2) and SE(3)
BA (dp=6, dl=3), ``KERNEL_DPS``.  :func:`fused_mode` picks one.  The preconditioner is PCR on the chain
(or block-Jacobi), optionally with the additive Galerkin coarse level
``rmat cinv rmat^T``.  The CPU path runs each kernel's plain PyTorch
version (:func:`fused_pcg_chunk_ref`, :func:`band_fused_pcg_chunk_ref`);
on a CUDA tensor a wrapper launches its kernel or raises.

Where the gate declines both kernels the solve takes the plain PCG loop of
``ops/schur.py``, as in the reference.  Port of
``toyslam_tpu.ops.fused_pcg``.  Left out: the streamed "fold" coarse level
and the bf16 PCR planes of the reference's band kernel, both workarounds
for its on-chip memory (ROADMAP.md B2); every coarse level reaches the
kernels as ``cinv`` and the restriction ``rmat``.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import NamedTuple

import torch

from toyslam_torch.ops import blockmath as bm
from toyslam_torch.ops import schur

_f32 = torch.float32
_i32 = torch.int32

# Resident budget of the kernel on an H100.  Every block of its cluster
# holds the [dp, Np] state vectors in shared memory (at most 227 KB, the
# opt-in maximum); the V slabs stay in shared memory where a block's slice
# fits, else they are read from L2 on every matvec and stay fast only while
# they fit in L2 (50 MB) next to everything else.
SMEM_BUDGET_BYTES = 232_448
SLAB_BUDGET_BYTES = 40 * 2**20
# Budget of the band kernel on an H100: it has no on-chip ceiling (the
# tile stack streams from device memory on every matvec), so what bounds
# it is the card's 80 GB, of which this leaves half to the rest of the
# program and to the build's temporaries.
BAND_BUDGET_BYTES = 40 * 2**30


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


class BandOperator(NamedTuple):
    """The damped Schur operator in streamed banded form (large graphs);
    layout from ``ops/band_plan.py``."""

    tiles: torch.Tensor        # f32[n_chunks, K, dp, Wrow, B*dl]
    win_off: torch.Tensor      # i32[n_chunks, K] window start pose
    cover: torch.Tensor        # i32[Np, cap] windows covering each pose
    u: torch.Tensor | None     # f32[dp, Mw, Np] wide + closure columns
    tdiag: torch.Tensor        # f32[dp, dp, Np]
    tupper: torch.Tensor
    tlower: torch.Tensor


def build_band_operator(
    d: schur.BlockSystem, hll_inv: torch.Tensor, graph
) -> BandOperator:
    """Materialize the streamed banded operator.

    The per-edge ``Hpl L^{-T}`` blocks go into the tile stack with one
    gather and one indexed write at the layout's unique ``elem_ids``; wide
    landmarks and loop closures become full-height columns, as the
    resident slabs (the wide ones summed with ``index_add_`` where the
    reference has ``segment_sum``)."""
    n = graph.num_poses
    dp = d.hpp_diag.shape[-1]
    dl = d.hll.shape[-1]
    band = graph.plan.band
    w_row, b_dl = band.w_row, band.chunk_b * dl
    n_tiles = band.n_chunks * band.k_windows

    lh = _chol_spd(d.hll)
    el = _tri_inv_lower(lh).transpose(-1, -2)              # L^{-T}
    blk = bm.mm(d.hpl, el[graph.lm_edges.lm])              # [E, dp, dl]

    flat = torch.zeros(n_tiles * dp * w_row * b_dl, dtype=_f32,
                       device=blk.device)
    flat[band.elem_ids] = blk[band.src_edges].reshape(-1)
    tiles = flat.reshape(band.n_chunks, band.k_windows, dp, w_row, b_dl)

    ucols = []
    if band.n_wide:
        nw = band.n_wide
        e_all = blk.shape[0]
        we = band.wide_edges                               # padded with E
        ok = we < e_all
        wej = torch.clamp(we, max=e_all - 1)
        wvals = blk[wej] * ok[:, None, None].to(_f32)
        # padded entries go to a dump row past the n*nw real ones
        wid = torch.where(
            ok, graph.lm_edges.pose[wej] * nw + band.wide_idx[wej], n * nw)
        uw = torch.zeros((n * nw + 1, dp, dl), dtype=_f32, device=blk.device)
        uw.index_add_(0, wid, wvals)
        ucols.append(
            uw[: n * nw].reshape(n, nw, dp, dl).permute(2, 1, 3, 0)
            .reshape(dp, nw * dl, n)
        )
    tdiag = d.hpp_diag
    ccols, extra = _closure_columns(d, graph.plan.fused, n, dp)
    if ccols is not None:
        ucols.append(ccols.transpose(1, 2))
        tdiag = tdiag + extra
    u = torch.cat(ucols, dim=1).contiguous() if ucols else None

    upper = schur.chain_upper(d, graph.odom.i, graph.odom.j, n)
    lower = schur._shift_down(upper, 1).transpose(-1, -2)
    return BandOperator(
        tiles=tiles, win_off=band.win_off, cover=band.cover, u=u,
        tdiag=_planes(tdiag), tupper=_planes(upper), tlower=_planes(lower),
    )


def build_band_operator_grid(
    hll_d: torch.Tensor,      # f32[M, dl, dl] damped landmark blocks
    hpl_p: torch.Tensor,      # f32[N, Kp, dp, dl] pose-major hpl grid
    lm_p: torch.Tensor,       # int64[N, Kp] landmark of each grid slot
    hpp_diag: torch.Tensor,   # f32[N, dp, dp] damped pose diagonal
    tupper: torch.Tensor,     # f32[N, dp, dp] chain superdiagonal (masked)
    gband, n: int,
) -> BandOperator:
    """The streamed band operator straight from the grid assembly
    (``ops/grid_schur.py``): the math of :func:`build_band_operator`, with
    the low-rank blocks computed on the pose-major grid, the tile write
    sourcing grid slots (``band_plan.GridBandAux``), the chain
    superdiagonal read positionally, and no loop closures (the grid plan
    holds chain odometry only).  The tile write's indices are unique, so
    a plain indexed write is deterministic; the wide columns are summed
    with ``index_add_`` where the reference has ``segment_sum``."""
    dp, dl = hpl_p.shape[-2], hpl_p.shape[-1]
    w_row, b_dl = gband.w_row, gband.chunk_b * dl
    n_tiles = gband.n_chunks * gband.k_windows

    lh = _chol_spd(hll_d)
    el = _tri_inv_lower(lh).transpose(-1, -2)              # L^{-T}
    blk = bm.mm(hpl_p, el[lm_p])                           # [N, Kp, dp, dl]
    blk_flat = blk.reshape(-1, dp, dl)

    flat = torch.zeros(n_tiles * dp * w_row * b_dl, dtype=_f32,
                       device=blk.device)
    flat[gband.elem_ids] = blk_flat[gband.src_rows].reshape(-1)
    tiles = flat.reshape(gband.n_chunks, gband.k_windows, dp, w_row, b_dl)

    u = None
    if gband.n_wide:
        nw = gband.n_wide
        ws = gband.wide_slots                  # padded with N*Kp
        ok = ws < blk_flat.shape[0]
        wvals = blk_flat[torch.clamp(ws, max=blk_flat.shape[0] - 1)]
        # padded entries go to a dump row past the n*nw real ones
        wid = torch.where(ok, gband.wide_ids, n * nw)
        uw = torch.zeros((n * nw + 1, dp, dl), dtype=_f32, device=blk.device)
        uw.index_add_(0, wid, wvals * ok[:, None, None].to(_f32))
        u = (uw[: n * nw].reshape(n, nw, dp, dl).permute(2, 1, 3, 0)
             .reshape(dp, nw * dl, n).contiguous())

    lower = schur._shift_down(tupper, 1).transpose(-1, -2)
    return BandOperator(
        tiles=tiles, win_off=gband.win_off, cover=gband.cover, u=u,
        tdiag=_planes(hpp_diag), tupper=_planes(tupper),
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
    """The preconditioner in the kernels' plane layout: PCR factors of the
    block-tridiagonal part of S ("tridiag") or the inverse diagonal blocks
    ("jacobi"), and with "+coarse" the Galerkin coarse level over groups
    of ``coarse_group`` poses: its explicit inverse
    (``schur.build_coarse_precond``) as ``cinv [dp, dp, nc, nc]`` blocks
    and the 0/1 restriction ``rmat [Np, nc]``."""
    n = graph.num_poses
    dp = d.hpp_diag.shape[-1]
    local_kind, _, coarse_kind = precond.partition("+")
    if local_kind == "tridiag":
        upper = schur.chain_upper(d, graph.odom.i, graph.odom.j, n)
        al, ga, binv = schur.build_tridiag_planes(
            s_diag.permute(1, 2, 0), upper.permute(1, 2, 0)
        )
        al, ga, binv = al.contiguous(), ga.contiguous(), binv.contiguous()
    elif local_kind == "jacobi":
        al = ga = torch.zeros((0, dp, dp, n), dtype=_f32,
                              device=s_diag.device)
        binv = _planes(schur.inv_blocks(s_diag))
    else:
        raise ValueError(
            f"pcg_precond={precond!r}: the fused kernels take 'jacobi' or "
            "'tridiag' local preconditioners"
        )
    if coarse_kind != "coarse":
        return FusedPrecond(al, ga, binv, None, None)
    cinv = schur.build_coarse_precond(d, hll_inv, graph, coarse_group)
    return FusedPrecond(al, ga, binv, *_coarse_operands(cinv, n, dp,
                                                         coarse_group))


def _coarse_operands(cinv: torch.Tensor, n: int, dp: int, group: int):
    """The kernels' coarse operands from the component-major explicit
    inverse ``[dp*nc, dp*nc]`` (row ``a*nc + c``): ``cinv [dp, dp, nc, nc]``
    blocks and the 0/1 restriction ``rmat [Np, nc]`` over groups of
    ``group`` poses."""
    nc = cinv.shape[0] // dp
    cinv_b = cinv.reshape(dp, nc, dp, nc).permute(0, 2, 1, 3).contiguous()
    dev = cinv.device
    rmat = (
        (torch.arange(n, device=dev) // group)[:, None]
        == torch.arange(nc, device=dev)[None, :]
    ).to(_f32)
    return cinv_b, rmat


def fused_precond_from_parts(
    local_kind: str,
    local,                              # schur.TridiagPrecond or inv blocks
    coarse_inv: torch.Tensor | None,    # [dp*nc, dp*nc] component-major
    n: int,
    dp: int,
    coarse_group: int,
) -> FusedPrecond:
    """Re-lay a plain-loop preconditioner (the grid solver's ``(local,
    coarse)``) into the kernels' plane layout; a coarse level comes with
    its restriction ``rmat``, as from :func:`build_fused_precond`."""
    if local_kind == "tridiag":
        al = local.alphas.permute(0, 2, 3, 1).contiguous()
        ga = local.gammas.permute(0, 2, 3, 1).contiguous()
        binv = _planes(local.binv)
    else:
        al = ga = torch.zeros((0, dp, dp, n), dtype=_f32,
                              device=local.device)
        binv = _planes(local)
    if coarse_inv is None:
        return FusedPrecond(al, ga, binv, None, None)
    return FusedPrecond(al, ga, binv,
                        *_coarse_operands(coarse_inv, n, dp, coarse_group))


def fused_precond_from_graph(cfg, graph, lam: torch.Tensor) -> FusedPrecond:
    """Assemble and build the fused preconditioner at ``(graph, lam)``: the
    init and refresh step of the stateful ``pcg_precond_refresh != 1``
    solve."""
    sys = schur.assemble_blocks(
        graph, huber_delta=cfg.huber_delta, fixed_prior=cfg.fixed_prior,
        exact_odom_jacobians=cfg.exact_odom_jacobians,
    )
    d = schur.damp(sys, lam)
    hll_inv = schur.inv_blocks(d.hll)
    s_diag = schur.schur_s_diag(d, hll_inv, graph)
    return build_fused_precond(d, hll_inv, graph, s_diag, cfg.pcg_precond,
                               cfg.pcg_coarse_group)


# pose block sizes both kernels are instantiated for (their C entry points
# dispatch on dp): SE(2) and SE(3)
KERNEL_DPS = (3, 6)
B1_THREADS = 576      # kThreads in csrc/fused_pcg_chunk.cu
B1_CLUSTER = 16       # blocks per launch (a non-portable cluster size)


def chunk_smem_bytes(dp: int, np_: int, mw: int, nc: int,
                     cluster: int = B1_CLUSTER, resident: bool = False) -> int:
    """Shared memory of one block of the resident kernel: when
    ``resident``, the block's U slice ``[dp*Np, ceil(Mw / cluster)]`` with
    rows padded to an odd number of float4s; the float4 column-sum
    scratch; the block's V^T x columns; seven [dp, Np] vectors; the coarse
    scratch and the reduction slots (mirrors ``smem_layout`` in
    csrc/fused_pcg_chunk.cu)."""
    cp = -(-mw // cluster)
    n = dp * np_
    stride = 4 * ((-(-cp // 4)) | 1)
    return 4 * ((n * stride if resident else 0) + 4 * B1_THREADS
                + -(-cp // 4) * 4 + 7 * n + 2 * dp * nc
                + 2 * (B1_THREADS // 32) + 2)


class ClusterLayout(NamedTuple):
    """How one launch of the resident kernel splits U over its cluster."""

    cluster: int          # thread blocks in the launch's cluster
    cols_per_block: int   # U columns owned by each block
    resident: bool        # the U slice lives in shared memory for the launch
    smem_bytes: int       # dynamic shared memory per block


def b1_layout(dp: int, np_: int, mw: int, nc: int, smem_limit: int,
              cluster: int = B1_CLUSTER) -> ClusterLayout:
    """The resident kernel's layout under a shared-memory limit per block:
    the U slice in shared memory where it fits beside the vectors, else
    streamed from L2 on every matvec.  Raises when the vectors alone do not
    fit."""
    for resident in (True, False):
        need = chunk_smem_bytes(dp, np_, mw, nc, cluster, resident)
        if need <= smem_limit:
            return ClusterLayout(cluster, -(-mw // cluster), resident, need)
    raise ValueError(
        f"fused_pcg_chunk: Np={np_}, Mw={mw} needs {need} B of shared "
        f"memory per block; {smem_limit} B allowed")


BAND_THREADS = 256   # kThreads in csrc/band_fused_pcg_chunk.cu
BAND_WIDE_SEG = 1024  # kWideSeg: poses per wide-column partial
# SMs of an H100: the band kernel's grid (one block per SM) on the card the
# gate plans for; the wrapper re-plans with the device's own count
H100_SMS = 132


def _round4(v: int) -> int:
    return (v + 3) & ~3


def band_smem_bytes(rows: int, cols: int, mw: int) -> int:
    """Dynamic shared memory of one block of the band kernel: a slab of
    ``rows`` tile rows by ``cols`` columns, the state values of its rows,
    ``t`` over its columns, the row-group combination buffer, ``u^T v`` and
    the reduction slots (mirrors ``smem_layout`` in
    csrc/band_fused_pcg_chunk.cu)."""
    return 4 * (rows * cols + _round4(rows) + _round4(cols)
                + 4 * BAND_THREADS + _round4(mw) + 64)


class BandSlabPlan(NamedTuple):
    """How the band kernel cuts each chunk's ``rows = K*dp*Wrow`` tile rows
    by columns into slabs, one per block at a time, and deals them to the
    blocks."""

    rows: int              # tile rows per chunk (every slab holds them all)
    cols: int              # columns per slab
    slabs_per_chunk: int   # B*dl / cols
    slabs_per_block: int   # the most slabs one block walks per matvec
    smem_bytes: int        # dynamic shared memory per block


def band_slab_plan(n_chunks: int, k_win: int, dp: int, w_row: int,
                   b_dl: int, mw: int, smem_limit: int,
                   grid: int) -> BandSlabPlan:
    """The slab schedule for a shared-memory limit per block and a grid of
    blocks: the widest slab (a divisor of B*dl, a multiple of 4 columns, at
    most 4 per thread) whose rows all fit in shared memory.  Raises when
    not even 4 columns fit.  No block ever waits on another inside the slab
    phase, so the grid puts no bound on the slab count."""
    rows = k_win * dp * w_row
    if rows % 4:
        raise ValueError(f"band kernel: K*dp*Wrow={rows} rows per chunk "
                         "must be a multiple of 4 (16-byte copies)")
    for cols in range(min(b_dl, 4 * BAND_THREADS), 3, -4):
        if b_dl % cols == 0 and band_smem_bytes(rows, cols, mw) <= smem_limit:
            spc = b_dl // cols
            return BandSlabPlan(rows, cols, spc, -(-n_chunks * spc // grid),
                                band_smem_bytes(rows, cols, mw))
    raise ValueError(
        f"band kernel: a slab of {rows} rows does not fit in {smem_limit} "
        "B of shared memory even at 4 columns")


def band_workspace_floats(dp: int, np_: int, n_chunks: int,
                          plan: BandSlabPlan, b_dl: int, mw: int, nc: int,
                          grid: int) -> int:
    """Workspace floats of one launch: seven [dp, Np] vectors, the matvec
    input at the window rows, the w-pass rows per slab, the wide partials,
    the blocks' coarse restriction shares, the coarse scratch and the
    partial sums (mirrors ``layout`` in csrc/band_fused_pcg_chunk.cu)."""
    o = _round4(7 * dp * np_)
    cells = n_chunks * plan.rows
    return (o + cells + plan.slabs_per_chunk * cells
            + -(-np_ // BAND_WIDE_SEG) * mw + grid * dp * nc + 2 * dp * nc
            + 2 * grid * 4)


def band_device_bytes(dp: int, np_: int, band, mw: int, nlevels: int,
                      nc: int) -> int:
    """Device memory the band solve holds at once on an H100: the tile
    stack (three times: the zeroed stack, the values written into it and
    the kernel's slab-major copy), the wide columns, the T, PCR and
    ``binv`` planes, the coarse level, the chunk state in and out, the
    kernel's workspace and the cover table."""
    dd = dp * dp
    n_ck = band.n_chunks * band.k_windows
    b_dl = band.chunk_b * band.dl
    plan = band_slab_plan(band.n_chunks, band.k_windows, dp, band.w_row,
                          b_dl, mw, SMEM_BUDGET_BYTES, H100_SMS)
    words = (
        3 * n_ck * dp * band.w_row * b_dl
        + dp * mw * np_
        + (4 + 2 * nlevels) * dd * np_
        + dd * nc * nc + np_ * nc
        + 9 * dp * np_
        + band_workspace_floats(dp, np_, band.n_chunks, plan, b_dl, mw, nc,
                                H100_SMS)
        + np_ * band.cover.shape[-1]
    )
    return 4 * words


def fused_mode(cfg, graph) -> str | None:
    """The gate, from the config, the shapes and the budgets alone:
    "resident" when the resident kernel can run this graph, else "band"
    when the graph carries a band layout (``plan.band``) whose slabs fit a
    block's shared memory and whose operands fit ``BAND_BUDGET_BYTES`` of
    device memory, else None: the plain PCG loop (``schur.schur_solve``).

    None wherever the JAX package's gate declines its kernels:
    ``pcg_backend="xla"``, ``pcg_unroll``, the "chunk" preconditioner,
    loop closures with exact odometry Jacobians or in an SE(3) graph, a
    coarse group that does not divide Np, and graphs past the resident
    budget without a fitting band layout."""
    local_kind, _, coarse_kind = cfg.pcg_precond.partition("+")
    if cfg.pcg_backend == "xla" or cfg.pcg_unroll:
        return None
    if graph.plan is None or graph.plan.fused is None:
        raise ValueError(
            "the Schur solve needs the gather plan: call "
            "toyslam_torch.ops.gather_plan.attach_plan(graph) first"
        )
    if local_kind not in ("jacobi", "tridiag"):
        return None
    # block sizes: SE(2) poses and 2D landmarks, or SE(3) poses and 3D points
    dp, dl = (6, 3) if cfg.solver == "schur3d" else (3, 2)
    n, m = graph.num_poses, graph.num_landmarks
    c = graph.plan.fused.closure_e.shape[0]
    if c and (cfg.exact_odom_jacobians or dp != 3):
        # the closure columns chol(W) need the A=-I/B=I odometry blocks
        # (off-diagonal -W, PSD); SE(3) odometry blocks are general
        return None
    if coarse_kind == "coarse" and n % cfg.pcg_coarse_group:
        return None
    nc = -(-n // cfg.pcg_coarse_group) if coarse_kind == "coarse" else 0
    mw = dl * m + dp * c
    if (chunk_smem_bytes(dp, n, mw, nc) <= SMEM_BUDGET_BYTES
            and 4 * dp * n * mw <= SLAB_BUDGET_BYTES):
        return "resident"
    band = graph.plan.band
    if band is None or (band.dp, band.dl) != (dp, dl):
        return None
    nlevels = max(1, (n - 1).bit_length()) if local_kind == "tridiag" else 0
    if band_fits(dp, n, band, band.n_wide * dl + dp * c, nlevels, nc):
        return "band"
    return None


def band_fits(dp: int, np_: int, band, mw: int, nlevels: int,
              nc: int) -> bool:
    """Whether the band kernel can run a layout on an H100: its slabs fit
    a block's shared memory (``band_slab_plan``) and the band solve's
    operands fit ``BAND_BUDGET_BYTES`` of device memory."""
    try:
        band_slab_plan(band.n_chunks, band.k_windows, dp, band.w_row,
                       band.chunk_b * band.dl, mw, SMEM_BUDGET_BYTES,
                       H100_SMS)
    except ValueError:
        return False
    return band_device_bytes(dp, np_, band, mw, nlevels, nc) \
        <= BAND_BUDGET_BYTES


def fused_supported(cfg, graph) -> bool:
    """Whether the gate admits one of the kernels."""
    return fused_mode(cfg, graph) is not None


def gated_mode(cfg, graph) -> str | None:
    """:func:`fused_mode`, with ``pcg_backend="fused"`` where the gate
    declines the kernels raising ``ValueError``, as in the JAX package."""
    mode = fused_mode(cfg, graph)
    if mode is None and cfg.pcg_backend == "fused":
        raise ValueError(
            "pcg_backend='fused' but the graph/config does not support the "
            "fused PCG kernels (see ops/fused_pcg.py::fused_mode)")
    return mode


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
    lib.fused_pcg_chunk_launch.argtypes = [ci] * 10 + [vp] * 28
    lib.fused_pcg_chunk_launch.restype = ci
    lib.fused_pcg_chunk_smem_bytes.argtypes = [ci] * 6
    lib.fused_pcg_chunk_smem_bytes.restype = ctypes.c_longlong
    lib.fused_pcg_chunk_smem_optin.argtypes = [ci]
    lib.fused_pcg_chunk_smem_optin.restype = ctypes.c_longlong
    lib.fused_pcg_chunk_max_clusters.argtypes = [ci] * 6 + [
        ctypes.POINTER(ci)]
    lib.fused_pcg_chunk_max_clusters.restype = ci
    return lib


@functools.cache
def b1_schedule(device_index: int, dp: int, np_: int, mw: int, nc: int,
                cluster: int = B1_CLUSTER) -> ClusterLayout:
    """The resident kernel's cluster layout on the device, checked against
    the card once per (device, shape, cluster size) and cached.  Raises
    when the card cannot hold the cluster: there is no smaller one."""
    lib = _library()
    have = lib.fused_pcg_chunk_smem_optin(device_index)
    if have < 0:
        raise RuntimeError("cudaDeviceGetAttribute failed")
    name = torch.cuda.get_device_name(device_index)
    try:
        lay = b1_layout(dp, np_, mw, nc, have, cluster)
    except ValueError as e:
        raise ValueError(f"{e} on {name} (shared memory)") from None
    if lib.fused_pcg_chunk_smem_bytes(dp, np_, mw, nc, cluster,
                                      int(lay.resident)) != lay.smem_bytes:
        raise RuntimeError("fused_pcg_chunk: chunk_smem_bytes does not "
                           "mirror the kernel's shared-memory layout")
    count = ctypes.c_int(0)
    err = lib.fused_pcg_chunk_max_clusters(dp, np_, mw, nc, cluster,
                                           int(lay.resident),
                                           ctypes.byref(count))
    if err != 0 or count.value < 1:
        raise RuntimeError(
            f"fused_pcg_chunk: {name} refuses a cluster of {cluster} blocks "
            f"at {lay.smem_bytes} B of shared memory each (cudaError_t "
            f"{err}, {count.value} clusters fit)")
    return lay


def _check(name: str, t: torch.Tensor, shape: tuple, dtype, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes {dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes contiguous tensors")


B1_TIMERS = ("vt_x", "v_urow", "exchange", "precond", "other")


def _launch(op, pre, rhs, st, atol2, maxit, restart, chunk_iters,
            cluster=None, timing=None):
    """Check, allocate and launch one chunk on a cluster of ``cluster``
    blocks (default ``B1_CLUSTER``).  ``timing``, an int64 tensor of
    len(B1_TIMERS) on the device, receives block 0's clock64 cycles per
    phase kind."""
    dev = rhs.device
    dp, n = rhs.shape
    mw = op.u.shape[-1]
    nl = pre.alphas.shape[0]
    has_coarse = pre.cinv is not None
    nc = pre.cinv.shape[-1] if has_coarse else 0
    if dp not in KERNEL_DPS:
        raise ValueError(
            f"fused_pcg_chunk kernel: dp={dp}; it is built for dp in "
            f"{KERNEL_DPS} (SE(2), SE(3))"
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
    if timing is not None:
        checks.append(("timing", timing, (len(B1_TIMERS),), torch.int64))
    for name, t, shape, dtype in checks:
        _check(name, t, shape, dtype, dev)

    lib = _library()
    lay = b1_schedule(dev.index or 0, dp, n, mw, nc,
                      B1_CLUSTER if cluster is None else cluster)
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
        lay.cluster, int(lay.resident),
        ptr(atol2), ptr(st.it), ptr(st.rz), ptr(st.stop),
        ptr(rhs), ptr(st.x), ptr(st.r), ptr(st.p), ptr(st.rt),
        ptr(op.u), ptr(op.tdiag), ptr(op.tupper), ptr(op.tlower),
        ptr(pre.alphas), ptr(pre.gammas), ptr(pre.binv),
        ptr(pre.cinv), ptr(pre.rmat),
        ptr(out.x), ptr(out.r), ptr(out.p), ptr(out.rt),
        ptr(out.it), ptr(out.rz), ptr(out.stop), ptr(out.rr),
        ptr(timing), stream,
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


# --- the band chunk: plain version ----------------------------------------


def band_matvec_ref(op: BandOperator, x: torch.Tensor) -> torch.Tensor:
    """``S x = T x - V (V^T x)`` on the banded operator, ``x [dp, Np]``,
    in plain PyTorch.  ``V V^T x`` per chunk: ``t = sum_{k,a} x[a, window
    k] . tiles[c, k, a]`` over ALL of the chunk's windows first, then each
    window gets ``tiles[c, k, a] . t``; splitting ``t`` per window would
    drop the cross-window terms of a landmark seen in several."""
    dp, n = x.shape
    y = _bmv(op.tdiag, x)
    y = y + _bmv(op.tupper, _shift(x, -1))
    y = y + _bmv(op.tlower, _shift(x, 1))
    if op.u is not None:
        urow = torch.einsum("amp,ap->m", op.u, x)
        y = y - torch.einsum("amp,m->ap", op.u, urow)
    nch, k_win, _, w_row, b_dl = op.tiles.shape
    xext = torch.cat([x, x.new_zeros((dp, w_row))], dim=1)
    rows = op.win_off.long()[..., None] + torch.arange(w_row, device=x.device)
    xw = xext[:, rows]                                  # [dp, nch, K, Wrow]
    xw = xw.permute(1, 2, 0, 3).reshape(nch, 1, k_win * dp * w_row)
    dmat = op.tiles.reshape(nch, k_win * dp * w_row, b_dl)
    t = torch.bmm(xw, dmat)                             # [nch, 1, B*dl]
    wv = torch.bmm(dmat, t.transpose(1, 2))             # [nch, K*dp*Wrow, 1]
    wv = wv.reshape(nch, k_win, dp, w_row).permute(2, 0, 1, 3)
    wacc = x.new_zeros((dp, n + w_row))
    wacc.index_add_(1, rows.reshape(-1), wv.reshape(dp, -1))
    return y - wacc[:, :n]


def band_fused_pcg_chunk_ref(
    op: BandOperator,
    pre: FusedPrecond,
    rhs: torch.Tensor,
    st: ChunkState,
    atol2: torch.Tensor,
    maxit: int,
    restart: bool,
    chunk_iters: int,
) -> ChunkState:
    """One launch of the band kernel in plain PyTorch: the oracle of the
    kernel and the CPU path.

    ``chunk_iters`` PCG trips, then one extra trip whose matvec is on ``x``
    and gives the true residual (``alpha = 0`` there, so ``x`` and ``r``
    take a zero step and nothing else changes).  Restart replaces ``r``
    with the carried true residual; breakdown sets the sticky stop; a done
    trip masks to a no-op."""
    atol2 = atol2.reshape(())
    x = st.x
    r = st.rt if restart else st.r
    if restart:
        z = _precond_ref(pre, r)
        p, rz = z, (r * z).sum()
    else:
        p, rz = st.p, st.rz.reshape(())
    rr = (r * r).sum()
    stop = st.stop.reshape(()) > 0
    it = st.it.reshape(())
    for _ in range(chunk_iters):
        ap = band_matvec_ref(op, p)
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
    # the extra trip: the matvec on x, and the reference's zero step (which
    # carries a non-finite ap into r, as the kernel does)
    ap = band_matvec_ref(op, x)
    r_true = rhs - ap
    x = x + 0.0 * p
    r = r - 0.0 * ap
    return ChunkState(
        x=x, r=r, p=p, rt=r_true, it=it.reshape(1), rz=rz.reshape(1),
        stop=stop.to(_i32).reshape(1),
        rr=(r_true * r_true).sum().reshape(1),
    )


# --- the band chunk: kernel ------------------------------------------------

_BAND_DIMS = ("dp", "np", "n_chunks", "k_win", "w_row", "b_dl", "mw",
              "nlevels", "nc", "cover_cap", "chunk_iters", "maxit",
              "restart", "grid", "cols")
_BAND_PTRS = 31
BAND_TIMERS = ("xwin", "copy_wait", "partial_t", "w_pass", "wide",
               "gather", "precond", "grid_sync",
               "other")   # the kernel's timer kinds, in order


@functools.cache
def _band_library() -> ctypes.CDLL:
    """The band kernel's shared library (built at first use), with its C
    signatures declared."""
    from toyslam_torch import kernels

    lib = kernels.load("band_fused_pcg_chunk").lib
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    pi = ctypes.POINTER(ci)
    lib.band_fused_pcg_chunk_device.argtypes = [ci, pi, pi]
    lib.band_fused_pcg_chunk_device.restype = ci
    lib.band_fused_pcg_chunk_smem_bytes.argtypes = [ci, ci, ci]
    lib.band_fused_pcg_chunk_smem_bytes.restype = cll
    lib.band_fused_pcg_chunk_grid.argtypes = [ci, ci, cll, pi]
    lib.band_fused_pcg_chunk_grid.restype = ci
    lib.band_fused_pcg_chunk_workspace_floats.argtypes = [pi, ci]
    lib.band_fused_pcg_chunk_workspace_floats.restype = cll
    lib.band_grid_sync_probe.argtypes = [ci, cll, ci, vp]
    lib.band_grid_sync_probe.restype = ci
    lib.band_fused_pcg_chunk_launch.argtypes = [
        pi, ci, ctypes.POINTER(vp), ci, vp]
    lib.band_fused_pcg_chunk_launch.restype = ci
    return lib


@functools.cache
def band_schedule(device_index: int, n_chunks: int, k_win: int, dp: int,
                  w_row: int, b_dl: int,
                  mw: int) -> tuple[int, BandSlabPlan]:
    """The band kernel's grid (one block per SM) and slab schedule on the
    device, for a layout; queried from the card once per (device, layout)
    and cached (the occupancy query is made for the dp instantiation)."""
    lib = _band_library()
    sms, optin = ctypes.c_int(0), ctypes.c_int(0)
    err = lib.band_fused_pcg_chunk_device(device_index, ctypes.byref(sms),
                                          ctypes.byref(optin))
    if err != 0:
        raise RuntimeError(
            f"band_fused_pcg_chunk: device query failed: cudaError_t {err}")
    plan = band_slab_plan(n_chunks, k_win, dp, w_row, b_dl, mw, optin.value,
                          sms.value)
    if lib.band_fused_pcg_chunk_smem_bytes(plan.rows, plan.cols, mw) \
            != plan.smem_bytes:
        raise RuntimeError("band_fused_pcg_chunk: band_smem_bytes does not "
                           "mirror the kernel's shared-memory layout")
    grid = ctypes.c_int(0)
    err = lib.band_fused_pcg_chunk_grid(dp, device_index, plan.smem_bytes,
                                        ctypes.byref(grid))
    if err != 0:
        raise RuntimeError(
            f"band_fused_pcg_chunk: occupancy query failed: cudaError_t {err}")
    if grid.value < 1:
        raise ValueError(
            f"band_fused_pcg_chunk: the cooperative grid does not fit on "
            f"{torch.cuda.get_device_name(device_index)} ("
            f"{plan.smem_bytes} B of shared memory per block)")
    return grid.value, plan


def band_grid_sync_probe(device: torch.device, iters: int) -> None:
    """Launch ``iters`` grid barriers alone on the band kernel's grid (one
    block per SM at the 10k layout's shared memory), to time one barrier."""
    grid, plan = band_schedule(device.index or 0, 39, 2, 3, 512, 512, 2)
    err = _band_library().band_grid_sync_probe(
        grid, plan.smem_bytes, iters,
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"band_grid_sync_probe failed: cudaError_t {err}")


_slab_major_last = None   # (weakref to a stack, its version, cols, copy)


def _slab_major(tiles: torch.Tensor, cols: int) -> torch.Tensor:
    """The tile stack re-laid slab-major, ``[n_chunks, B*dl / cols, K*dp*Wrow,
    cols]``: each slab the band kernel copies is one contiguous run.  Made
    once per stack (one read and one write of it on the card) and kept
    for the last stack while that tensor lives unmodified."""
    global _slab_major_last
    if _slab_major_last is not None:
        ref, version, last_cols, slabs = _slab_major_last
        if ref() is tiles and tiles._version == version and last_cols == cols:
            return slabs
    nch, k_win, dp, w_row, b_dl = tiles.shape
    slabs = (tiles.reshape(nch, k_win * dp * w_row, b_dl // cols, cols)
             .permute(0, 2, 1, 3).contiguous())
    _slab_major_last = (weakref.ref(tiles), tiles._version, cols, slabs)
    return slabs


def _band_launch(op, pre, rhs, st, atol2, maxit, restart, chunk_iters,
                 timing=None):
    """Check, allocate and launch one band chunk.  ``timing``, an int64
    tensor [grid, len(BAND_TIMERS)] on the device (grid from
    :func:`band_schedule`), receives each block's clock64 cycles per kind."""
    dev = rhs.device
    dp, n = rhs.shape
    nch, k_win, _, w_row, b_dl = op.tiles.shape
    mw = 0 if op.u is None else op.u.shape[1]
    nl = pre.alphas.shape[0]
    has_coarse = pre.cinv is not None
    nc = pre.cinv.shape[-1] if has_coarse else 0
    cap = op.cover.shape[-1]
    if dp not in KERNEL_DPS:
        raise ValueError(
            f"band_fused_pcg_chunk kernel: dp={dp}; it is built for dp in "
            f"{KERNEL_DPS} (SE(2), SE(3))"
        )
    if b_dl % 128 or w_row < 1:
        raise ValueError(
            f"band_fused_pcg_chunk: B*dl={b_dl} must be a multiple of 128 "
            f"and Wrow={w_row} positive"
        )
    if nch * k_win * dp * max(w_row, b_dl) >= 2**31:
        raise ValueError("band_fused_pcg_chunk: the partial buffers "
                         "overflow the kernel's 32-bit offsets")
    vec = (dp, n)
    planes = (dp, dp, n)
    checks = [
        ("rhs", rhs, vec, _f32), ("x", st.x, vec, _f32),
        ("r", st.r, vec, _f32), ("p", st.p, vec, _f32),
        ("rt", st.rt, vec, _f32), ("it", st.it, (1,), _i32),
        ("rz", st.rz, (1,), _f32), ("stop", st.stop, (1,), _i32),
        ("atol2", atol2, (1,), _f32),
        ("tiles", op.tiles, (nch, k_win, dp, w_row, b_dl), _f32),
        ("win_off", op.win_off, (nch, k_win), _i32),
        ("cover", op.cover, (n, cap), _i32),
        ("tdiag", op.tdiag, planes, _f32), ("tupper", op.tupper, planes, _f32),
        ("tlower", op.tlower, planes, _f32),
        ("alphas", pre.alphas, (nl,) + planes, _f32),
        ("gammas", pre.gammas, (nl,) + planes, _f32),
        ("binv", pre.binv, planes, _f32),
    ]
    if mw:
        checks.append(("u", op.u, (dp, mw, n), _f32))
    if has_coarse:
        checks += [("cinv", pre.cinv, (dp, dp, nc, nc), _f32),
                   ("rmat", pre.rmat, (n, nc), _f32)]
    elif pre.rmat is not None:
        raise ValueError("rmat given without cinv")
    for name, t, shape, dtype in checks:
        _check(name, t, shape, dtype, dev)

    lib = _band_library()
    grid, plan = band_schedule(dev.index or 0, nch, k_win, dp, w_row, b_dl,
                               mw)
    if timing is not None:
        _check("timing", timing, (grid, len(BAND_TIMERS)), torch.int64, dev)
    dims = dict(dp=dp, np=n, n_chunks=nch, k_win=k_win, w_row=w_row,
                b_dl=b_dl, mw=mw, nlevels=nl, nc=nc, cover_cap=cap,
                chunk_iters=chunk_iters, maxit=int(maxit),
                restart=int(bool(restart)), grid=grid, cols=plan.cols)
    c_dims = (ctypes.c_int * len(_BAND_DIMS))(*(dims[k] for k in _BAND_DIMS))
    ws_floats = lib.band_fused_pcg_chunk_workspace_floats(
        c_dims, len(_BAND_DIMS))
    if ws_floats < 0:
        raise ValueError("band_fused_pcg_chunk: the kernel refused the "
                         f"dimensions {dims}")
    if ws_floats != band_workspace_floats(dp, n, nch, plan, b_dl, mw, nc,
                                          grid):
        raise RuntimeError("band_fused_pcg_chunk: band_workspace_floats "
                           "does not mirror the kernel's workspace layout")
    work = torch.empty(ws_floats, dtype=_f32, device=dev)
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

    ptrs = [
        atol2, st.it, st.rz, st.stop, rhs, st.x, st.r, st.p, st.rt,
        _slab_major(op.tiles, plan.cols), op.win_off, op.cover, op.u,
        op.tdiag, op.tupper,
        op.tlower, pre.alphas, pre.gammas, pre.binv, pre.cinv, pre.rmat,
        out.x, out.r, out.p, out.rt, out.it, out.rz, out.stop, out.rr, work,
        timing,
    ]
    assert len(ptrs) == _BAND_PTRS
    c_ptrs = (ctypes.c_void_p * _BAND_PTRS)(*(ptr(t) for t in ptrs))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.band_fused_pcg_chunk_launch(
        c_dims, len(_BAND_DIMS), c_ptrs, _BAND_PTRS, stream)
    if err != 0:
        raise RuntimeError(
            f"band_fused_pcg_chunk launch failed: cudaError_t {err}")
    band_fused_pcg_chunk.launches += 1
    return out


def band_fused_pcg_chunk(
    op: BandOperator,
    pre: FusedPrecond,
    rhs: torch.Tensor,
    st: ChunkState,
    atol2: torch.Tensor,
    maxit: int,
    restart: bool,
    chunk_iters: int,
) -> ChunkState:
    """One chunk of PCG on the banded operator.  On CUDA tensors this
    launches the hand-written kernel (csrc/band_fused_pcg_chunk.cu) and
    counts it in ``band_fused_pcg_chunk.launches``; on CPU tensors it runs
    :func:`band_fused_pcg_chunk_ref`."""
    if rhs.device.type == "cpu":
        return band_fused_pcg_chunk_ref(op, pre, rhs, st, atol2, maxit,
                                        restart, chunk_iters)
    if rhs.device.type != "cuda":
        raise ValueError(f"band_fused_pcg_chunk: no kernel for {rhs.device}")
    return _band_launch(op, pre, rhs, st, atol2, maxit, restart, chunk_iters)


band_fused_pcg_chunk.launches = 0


# --- the host loop -----------------------------------------------------------


def _chunked_pcg(chunk, op, pre, rhs2, tol, max_iters, chunk_iters,
                 restart_every) -> schur.PCGResult:
    """PCG in launches of ``chunk``: true-residual replacement and direction
    restart every ``restart_every`` iterations (in whole chunks), masked
    no-op iterations after convergence or breakdown.  The convergence test
    reads one flag per chunk to the host."""
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
        st = chunk(op, pre, rhs2, st, atol2, max_iters,
                   k % restart_chunks == 0, chunk_iters)
        k += 1
    return schur.PCGResult(
        x=st.x, iterations=st.it[0], residual_norm=torch.sqrt(st.rr[0]),
    )


def fused_pcg(
    op: FusedOperator,
    pre: FusedPrecond,
    rhs2: torch.Tensor,        # f32[dp, Np]
    tol: float,
    max_iters: int,
    chunk_iters: int,
    restart_every: int = 64,
) -> schur.PCGResult:
    """PCG on the resident fused operator, one :func:`fused_pcg_chunk`
    per chunk."""
    return _chunked_pcg(fused_pcg_chunk, op, pre, rhs2, tol, max_iters,
                        chunk_iters, restart_every)


def band_fused_pcg(
    op: BandOperator,
    pre: FusedPrecond,
    rhs2: torch.Tensor,        # f32[dp, Np]
    tol: float,
    max_iters: int,
    chunk_iters: int,
    restart_every: int = 64,
) -> schur.PCGResult:
    """PCG on the streamed banded operator, one
    :func:`band_fused_pcg_chunk` per chunk; the same control as
    :func:`fused_pcg`."""
    return _chunked_pcg(band_fused_pcg_chunk, op, pre, rhs2, tol, max_iters,
                        chunk_iters, restart_every)


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
    pre: FusedPrecond | None = None,
    mode: str = "resident",
) -> tuple[torch.Tensor, torch.Tensor, schur.SolveStats]:
    """Damp, eliminate the landmarks, run the fused PCG on the reduced
    pose system, back-substitute the landmarks.  ``mode`` (from
    :func:`fused_mode`) picks the resident or the streamed band operator;
    a prebuilt ``pre`` skips the preconditioner build (the stateful
    refresh path).  Returns ``(dx_poses [N, dp], dx_landmarks [M, dl],
    stats)``."""
    if mode not in ("resident", "band"):
        raise ValueError(f"fused mode {mode!r}: 'resident' or 'band'")
    plan = graph.plan
    d = schur.damp(sys, lam)
    hll_inv = schur.inv_blocks(d.hll)
    rhs = -d.bp + schur.hpl_matvec(
        d, graph.lm_edges.lm, bm.mv(hll_inv, d.bl), plan
    )
    if pre is None:
        s_diag = schur.schur_s_diag(d, hll_inv, graph)
        pre = build_fused_precond(d, hll_inv, graph, s_diag, precond,
                                  coarse_group)
    rhs2 = rhs.T.contiguous()
    if mode == "band":
        bop = build_band_operator(d, hll_inv, graph)
        res = band_fused_pcg(bop, pre, rhs2, tol, max_iters, chunk_iters,
                             restart_every)
    else:
        op = build_fused_operator(d, hll_inv, graph)
        res = fused_pcg(op, pre, rhs2, tol, max_iters, chunk_iters,
                        restart_every)
    dx_p = res.x.T
    u = schur.hlp_matvec(d, graph.lm_edges.pose, dx_p, plan)
    dx_l = bm.mv(hll_inv, -d.bl - u)
    stats = schur.SolveStats(pcg_iters=res.iterations,
                             pcg_residual=res.residual_norm)
    return dx_p, dx_l, stats
