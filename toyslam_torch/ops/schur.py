"""Block-sparse normal equations with Schur-complement landmark elimination.

The landmark-landmark block ``Hll`` is block-diagonal (2x2 per landmark in
SE(2), 3x3 in SE(3) BA), so landmarks are eliminated locally and the
reduced pose system

    S = Hpp - Hpl Hll^-1 Hlp,     S dx_p = -b_p + Hpl Hll^-1 b_l

is solved by preconditioned conjugate gradients.  This module holds the
blocks, their per-vertex sums, the damping, the small-block inverses, the
matrix-free Schur matvec (``schur_matvec``, and ``plan_matvec`` on the
vertex-major ``PlanOperator``), the preconditioners (block-Jacobi, the
block-tridiagonal PCR, the chunked block inverse, and the Galerkin coarse
level of ``build_coarse_precond``/``spd_inverse``), the plain PCG loop
(``pcg``, ``schur_solve``) and the linearize-solve that ``GaussNewton``
calls, stateful when the preconditioner is refreshed only every
``pcg_precond_refresh`` iterations.  The linearize-solve runs the fused
kernels of ``ops/fused_pcg.py`` where their gate (``fused_mode``) admits
the graph and the plain loop elsewhere, as the JAX package does.

Port of ``toyslam_tpu.ops.schur``.  Its ``axis_name`` hooks are the
optional ``group`` arguments here: a ``torch.distributed`` process group
over which the edge-sharded solve (``parallel/distributed.py``) sums its
per-vertex partials and the partitioned one (``parallel/partition.py``) its
PCG inner products, through ``ops/collective.py``; None is one process.
Under a group the solve is stateless and never takes the kernels, as in the
JAX package.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from toyslam_torch import tracing
from toyslam_torch.config import OptimizerConfig
from toyslam_torch.models.graph import FactorGraph2D
from toyslam_torch.ops import blockmath as bm
from toyslam_torch.ops import edge_blocks
from toyslam_torch.ops.collective import all_reduce
from toyslam_torch.ops import gather_plan as gp
from toyslam_torch.ops import pcr
from toyslam_torch.ops import residuals as res_ops


def _plan(graph: FactorGraph2D) -> gp.GatherPlan:
    if graph.plan is None:
        raise ValueError(
            "the graph has no gather plan: call "
            "toyslam_torch.ops.gather_plan.attach_plan(graph) first "
            "(GaussNewton does so itself)"
        )
    return graph.plan


class BlockSystem(NamedTuple):
    """Undamped block-sparse normal equations (gauge priors included), with
    pose blocks of dp (3 in SE(2), 6 in SE(3)) and landmark blocks of dl
    (2 or 3)."""

    hpp_diag: torch.Tensor   # f32[N,dp,dp] pose diagonal blocks
    hpp_off: torch.Tensor    # f32[E1,dp,dp] odometry off-diagonal block at (i, j)
    hll: torch.Tensor        # f32[M,dl,dl] landmark diagonal blocks
    hpl: torch.Tensor        # f32[E2,dp,dl] pose-landmark coupling per edge
    bp: torch.Tensor         # f32[N,dp] pose gradient
    bl: torch.Tensor         # f32[M,dl] landmark gradient
    err: torch.Tensor        # f32[] robust chi^2


def assemble_blocks(
    graph: FactorGraph2D,
    huber_delta: float,
    fixed_prior: float = 1e6,
    exact_odom_jacobians: bool = False,
    group=None,
) -> BlockSystem:
    """Linearize every edge and sum the blocks per vertex through the
    graph's gather tables.  Under ``group`` (edge arrays sharded, states
    replicated) the per-vertex sums and chi^2 are summed across the ranks
    in one collective, so every rank holds the complete diagonal blocks and
    gradients; the per-edge blocks ``hpp_off`` and ``hpl`` stay local."""
    plan = _plan(graph)
    t_oi, t_oj = plan.odom_by_i, plan.odom_by_j
    t_lp, t_ll = plan.lm_by_pose, plan.lm_by_lm

    if exact_odom_jacobians:
        # general odometry Jacobians: the full products
        od = res_ops.eval_odom_edges(
            graph.poses, graph.odom.i, graph.odom.j, graph.odom.meas,
            graph.odom.info, graph.odom.mask, huber_delta, exact=True,
        )
        w_od = od.w[:, None, None] * graph.odom.info
        ata = bm.quad(od.JA, w_od)
        btb = bm.quad(od.JB, w_od)
        atb = bm.mtm(od.JA, bm.mm(w_od, od.JB))
        wr_i = bm.mtv(od.JA, bm.mv(w_od, od.r))
        wr_j = bm.mtv(od.JB, bm.mv(w_od, od.r))
        odom_err = od.robust_err.sum()
    else:
        # A=-I, B=I collapses every odometry product to ±W'
        ob = edge_blocks.odom_edge_blocks(
            graph.poses, graph.odom.i, graph.odom.j, graph.odom.meas,
            graph.odom.info, graph.odom.mask, huber_delta,
        )
        ata = btb = ob.w_info
        atb = -ob.w_info
        wr_i, wr_j = -ob.wr, ob.wr
        odom_err = ob.robust_err.sum()
    bp = gp.table_sum(wr_i, t_oi) + gp.table_sum(wr_j, t_oj)
    hpp_diag = gp.table_sum(ata, t_oi) + gp.table_sum(btb, t_oj)
    hpp_off = atb

    lb = edge_blocks.lm_edge_blocks(
        graph.poses, graph.landmarks, graph.lm_edges.pose, graph.lm_edges.lm,
        graph.lm_edges.meas, graph.lm_edges.info, graph.lm_edges.mask,
        huber_delta,
    )
    hpp_diag = hpp_diag + gp.table_sum(lb.w_ata, t_lp)
    hll = gp.table_sum(lb.w_btb, t_ll)
    bp = bp + gp.table_sum(lb.bp_c, t_lp)
    bl = gp.table_sum(lb.bl_c, t_ll)
    hpp_diag, hll, bp, bl, err = all_reduce(
        group, hpp_diag, hll, bp, bl, odom_err + lb.robust_err.sum())

    # gauge priors + padding regularization
    eye3 = torch.eye(3, dtype=hpp_diag.dtype, device=hpp_diag.device)
    eye2 = torch.eye(2, dtype=hll.dtype, device=hll.device)
    pose_reg = fixed_prior * graph.pose_fixed + (1.0 - graph.pose_mask)
    lm_reg = fixed_prior * graph.lm_fixed + (1.0 - graph.lm_mask)
    hpp_diag = hpp_diag + pose_reg[:, None, None] * eye3
    hll = hll + lm_reg[:, None, None] * eye2
    bp = bp * (1.0 - graph.pose_fixed)[:, None]
    bl = bl * (1.0 - graph.lm_fixed)[:, None]
    return BlockSystem(
        hpp_diag=hpp_diag, hpp_off=hpp_off, hll=hll, hpl=lb.w_hpl,
        bp=bp, bl=bl, err=err,
    )


def damp(sys: BlockSystem, lam: torch.Tensor) -> BlockSystem:
    """Add ``lam I`` to every diagonal block."""
    eye_p = torch.eye(sys.hpp_diag.shape[-1], dtype=sys.hpp_diag.dtype,
                      device=sys.hpp_diag.device)
    eye_l = torch.eye(sys.hll.shape[-1], dtype=sys.hll.dtype,
                      device=sys.hll.device)
    return sys._replace(
        hpp_diag=sys.hpp_diag + lam * eye_p,
        hll=sys.hll + lam * eye_l,
    )


def inv2x2(blocks: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 2x2 inverse — the Schur pivot."""
    a = blocks[..., 0, 0]
    b = blocks[..., 0, 1]
    c = blocks[..., 1, 0]
    d = blocks[..., 1, 1]
    inv_det = 1.0 / (a * d - b * c)
    row0 = torch.stack([d * inv_det, -b * inv_det], dim=-1)
    row1 = torch.stack([-c * inv_det, a * inv_det], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def _adjugate3(m):
    """Adjugate rows and inverse determinant of 3x3 blocks; ``m(r, c)``
    reads the (r, c) entry."""
    c00 = m(1, 1) * m(2, 2) - m(1, 2) * m(2, 1)
    c01 = m(1, 2) * m(2, 0) - m(1, 0) * m(2, 2)
    c02 = m(1, 0) * m(2, 1) - m(1, 1) * m(2, 0)
    c10 = m(0, 2) * m(2, 1) - m(0, 1) * m(2, 2)
    c11 = m(0, 0) * m(2, 2) - m(0, 2) * m(2, 0)
    c12 = m(0, 1) * m(2, 0) - m(0, 0) * m(2, 1)
    c20 = m(0, 1) * m(1, 2) - m(0, 2) * m(1, 1)
    c21 = m(0, 2) * m(1, 0) - m(0, 0) * m(1, 2)
    c22 = m(0, 0) * m(1, 1) - m(0, 1) * m(1, 0)
    inv_det = 1.0 / (m(0, 0) * c00 + m(0, 1) * c01 + m(0, 2) * c02)
    rows = [[c00, c10, c20], [c01, c11, c21], [c02, c12, c22]]
    return rows, inv_det


def inv3x3(blocks: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse via the adjugate."""
    rows, inv_det = _adjugate3(lambda r, c: blocks[..., r, c])
    out = torch.stack([torch.stack(row, dim=-1) for row in rows], dim=-2)
    return out * inv_det[..., None, None]


def inv_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """Batched small-block inverse: closed forms for 2x2/3x3, larger blocks
    (the 6x6 SE(3) pose blocks) through ``torch.linalg.inv``, where the
    reference has ``jnp.linalg.inv``."""
    k = blocks.shape[-1]
    if k == 2:
        return inv2x2(blocks)
    if k == 3:
        return inv3x3(blocks)
    return torch.linalg.inv(blocks)


def hlp_matvec(
    sys: BlockSystem, lm_pose: torch.Tensor, x: torch.Tensor, plan,
    group=None,
) -> torch.Tensor:
    """``Hlp @ x = Hpl^T @ x`` for ``x [N, dp]`` -> [M, dl] (block sizes
    read off ``hpl``), summed across ``group``."""
    return all_reduce(
        group, gp.table_sum(bm.mtv(sys.hpl, x[lm_pose]), plan.lm_by_lm))[0]


def hpl_matvec(
    sys: BlockSystem, lm_lm: torch.Tensor, y: torch.Tensor, plan,
    group=None,
) -> torch.Tensor:
    """``Hpl @ y`` for ``y [M, dl]`` -> [N, dp] (block sizes read off
    ``hpl``), summed across ``group``."""
    return all_reduce(
        group, gp.table_sum(bm.mv(sys.hpl, y[lm_lm]), plan.lm_by_pose))[0]


def hpp_matvec(
    sys: BlockSystem, odom_i: torch.Tensor, odom_j: torch.Tensor,
    x: torch.Tensor, plan, group=None,
) -> torch.Tensor:
    """``Hpp @ x`` for ``x [N, dp]`` from the blocks alone: the diagonal
    blocks plus the odometry off-diagonal products, summed per vertex
    through the gather tables (and across ``group``; the diagonal blocks
    are complete on every rank)."""
    off = gp.table_sum(bm.mv(sys.hpp_off, x[odom_j]), plan.odom_by_i)
    off = off + gp.table_sum(bm.mtv(sys.hpp_off, x[odom_i]), plan.odom_by_j)
    return bm.mv(sys.hpp_diag, x) + all_reduce(group, off)[0]


def schur_matvec(
    sys: BlockSystem, hll_inv: torch.Tensor, graph: FactorGraph2D,
    x: torch.Tensor, group=None,
) -> torch.Tensor:
    """``S @ x`` without materializing S, in edge order (the oracle of the
    vertex-major :func:`plan_matvec`)."""
    plan = _plan(graph)
    u = hlp_matvec(sys, graph.lm_edges.pose, x, plan, group)
    w = hpl_matvec(sys, graph.lm_edges.lm, bm.mv(hll_inv, u), plan, group)
    return hpp_matvec(sys, graph.odom.i, graph.odom.j, x, plan, group) - w


def schur_s_diag(
    sys: BlockSystem, hll_inv: torch.Tensor, graph: FactorGraph2D,
    group=None,
) -> torch.Tensor:
    """Diagonal blocks of S: ``[N, d, d]`` (exact when each (pose, landmark)
    pair is observed by one edge, as in the per-frame frontend)."""
    contrib = bm.mm(bm.mm(sys.hpl, hll_inv[graph.lm_edges.lm]),
                    sys.hpl.transpose(-1, -2))
    return sys.hpp_diag - all_reduce(
        group, gp.table_sum(contrib, _plan(graph).lm_by_pose))[0]


class PlanOperator(NamedTuple):
    """The damped Schur operator in vertex-major layout: the per-edge blocks
    laid out once per linearization into landmark-major ``[M, Kl, ...]``
    and pose-major ``[N, Kp, ...]`` grids (masked), so a PCG matvec reads
    dense grids and gathers rows of the small state vectors only."""

    hpp_diag: torch.Tensor   # [N, dp, dp] damped
    hll_inv: torch.Tensor    # [M, dl, dl]
    hpl_L: torch.Tensor      # [M, Kl, dp, dl] landmark-major blocks
    pose_L: torch.Tensor     # int64[M, Kl] observing pose per slot
    hpl_P: torch.Tensor      # [N, Kp, dp, dl] pose-major blocks
    lm_P: torch.Tensor       # int64[N, Kp]
    off_I: torch.Tensor      # [N, Ko, dp, dp] odometry blocks at (i, .)
    j_I: torch.Tensor        # int64[N, Ko]
    off_J: torch.Tensor      # [N, Ko, dp, dp] blocks at (., j), used transposed
    i_J: torch.Tensor        # int64[N, Ko]


def make_plan_operator(
    d: BlockSystem, hll_inv: torch.Tensor, graph: FactorGraph2D
) -> PlanOperator:
    plan = _plan(graph)
    lb, pb = plan.lm_by_lm, plan.lm_by_pose
    oi, oj = plan.odom_by_i, plan.odom_by_j
    return PlanOperator(
        hpp_diag=d.hpp_diag,
        hll_inv=hll_inv,
        hpl_L=d.hpl[lb.idx] * lb.mask[..., None, None],
        pose_L=graph.lm_edges.pose[lb.idx],
        hpl_P=d.hpl[pb.idx] * pb.mask[..., None, None],
        lm_P=graph.lm_edges.lm[pb.idx],
        off_I=d.hpp_off[oi.idx] * oi.mask[..., None, None],
        j_I=graph.odom.j[oi.idx],
        off_J=d.hpp_off[oj.idx] * oj.mask[..., None, None],
        i_J=graph.odom.i[oj.idx],
    )


def plan_matvec(op: PlanOperator, x: torch.Tensor,
                group=None) -> torch.Tensor:
    """``S @ x`` on the vertex-major grids.  Under ``group`` the grids hold
    this rank's edge shard (per-shard tables, ``build_sharded_plan``): the
    landmark intermediate ``u`` and the pose-space edge partials are summed
    across the ranks, two collectives ([M, dl] and [N, dp]) per matvec."""
    u = all_reduce(group, bm.mtv(op.hpl_L, x[op.pose_L]).sum(1))[0]
    v = bm.mv(op.hll_inv, u)
    w = bm.mv(op.hpl_P, v[op.lm_P]).sum(1)
    off = (bm.mv(op.off_I, x[op.j_I]).sum(1)
           + bm.mtv(op.off_J, x[op.i_J]).sum(1))
    return bm.mv(op.hpp_diag, x) + all_reduce(group, off - w)[0]


def plan_s_diag(op: PlanOperator, group=None) -> torch.Tensor:
    """Diagonal blocks of S from the pose-major grid (the edge terms summed
    across ``group``)."""
    contrib = bm.mm(bm.mm(op.hpl_P, op.hll_inv[op.lm_P]),
                    op.hpl_P.transpose(-1, -2)).sum(1)
    return op.hpp_diag - all_reduce(group, contrib)[0]


def _shift_down(x: torch.Tensor, s: int) -> torch.Tensor:
    """``y[i] = x[i-s]`` with zero fill (block arrays, axis 0)."""
    if s >= x.shape[0]:
        return torch.zeros_like(x)
    return torch.cat([torch.zeros_like(x[:s]), x[:-s]], dim=0)


def _shift_up(x: torch.Tensor, s: int) -> torch.Tensor:
    """``y[i] = x[i+s]`` with zero fill."""
    if s >= x.shape[0]:
        return torch.zeros_like(x)
    return torch.cat([x[s:], torch.zeros_like(x[:s])], dim=0)


class TridiagPrecond(NamedTuple):
    """Block-tridiagonal preconditioner factored by parallel cyclic
    reduction (PCR), in block layout.  ``alphas[l] / gammas[l]``: the
    level-``l`` elimination coefficients for the lower/upper neighbour at
    stride ``2^l``; ``binv``: the fully reduced diagonal, inverted."""

    alphas: torch.Tensor  # [L, N, d, d]
    gammas: torch.Tensor  # [L, N, d, d]
    binv: torch.Tensor    # [N, d, d]


def _pl_shift_down(x: torch.Tensor, s: int) -> torch.Tensor:
    """Plane-layout ``y[..., v] = x[..., v - s]`` with zero fill."""
    if s >= x.shape[-1]:
        return torch.zeros_like(x)
    return torch.cat([torch.zeros_like(x[..., :s]), x[..., :-s]], dim=-1)


def _pl_shift_up(x: torch.Tensor, s: int) -> torch.Tensor:
    """Plane-layout ``y[..., v] = x[..., v + s]`` with zero fill."""
    if s >= x.shape[-1]:
        return torch.zeros_like(x)
    return torch.cat([x[..., s:], torch.zeros_like(x[..., :s])], dim=-1)


def _pl_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Block product on component planes: [d,d,N] x [d,d,N] -> [d,d,N]."""
    return (a[:, :, None, :] * b[None, :, :, :]).sum(1)


def _pl_t(a: torch.Tensor) -> torch.Tensor:
    """Blockwise transpose on planes."""
    return a.transpose(0, 1)


def _pl_inv(p: torch.Tensor) -> torch.Tensor:
    """Inverse of blocks in plane layout [d,d,N]: closed forms for 2x2/3x3,
    :func:`inv_blocks` for larger ones."""
    d = p.shape[0]
    if d == 2:
        a, b2 = p[0, 0], p[0, 1]
        c, e = p[1, 0], p[1, 1]
        inv_det = 1.0 / (a * e - b2 * c)
        return torch.stack([
            torch.stack([e, -b2]), torch.stack([-c, a]),
        ]) * inv_det
    if d == 3:
        rows, inv_det = _adjugate3(lambda r, c: p[r, c])
        return torch.stack([torch.stack(row) for row in rows]) * inv_det
    return inv_blocks(p.permute(2, 0, 1)).permute(1, 2, 0)


def build_tridiag_planes(
    diag_p: torch.Tensor, upper_p: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """PCR factorization in component-plane layout ``[d, d, N]``.  Returns
    ``(alphas [L,d,d,N], gammas [L,d,d,N], binv [d,d,N])`` — the layout
    the fused kernels read.  On CUDA tensors one launch of the
    hand-written kernel (``ops/pcr.py::pcr_factor``, which reads the
    block layout ``[N, d, d]`` the callers hold and raises for a dtype
    other than float32 or a d it is not built for); on the CPU the plain
    version :func:`build_tridiag_planes_ref`."""
    if diag_p.is_cuda:
        return pcr.pcr_factor(diag_p.permute(2, 0, 1).contiguous(),
                              upper_p.permute(2, 0, 1).contiguous())
    return build_tridiag_planes_ref(diag_p, upper_p)


def build_tridiag_planes_ref(
    diag_p: torch.Tensor, upper_p: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of :func:`build_tridiag_planes`: every level's
    block products as PyTorch operations on the planes."""
    n = diag_p.shape[-1]
    levels = max(1, (n - 1).bit_length())
    a = _pl_t(_pl_shift_down(upper_p, 1))   # A[v] = upper[v-1]^T
    b = diag_p
    c = upper_p
    alphas, gammas = [], []
    s = 1
    for _ in range(levels):
        binv = _pl_inv(b)
        alpha = -_pl_mm(a, _pl_shift_down(binv, s))
        gamma = -_pl_mm(c, _pl_shift_up(binv, s))
        b = (
            b
            + _pl_mm(alpha, _pl_shift_down(c, s))
            + _pl_mm(gamma, _pl_shift_up(a, s))
        )
        a = _pl_mm(alpha, _pl_shift_down(a, s))
        c = _pl_mm(gamma, _pl_shift_up(c, s))
        alphas.append(alpha)
        gammas.append(gamma)
        s *= 2
    return torch.stack(alphas), torch.stack(gammas), _pl_inv(b)


def build_tridiag_precond(
    diag: torch.Tensor, upper: torch.Tensor
) -> TridiagPrecond:
    """Factor ``M = tridiag(upper^T, diag, upper)``: ``diag [N,d,d]``,
    ``upper[v]`` the (v, v+1) block (last row zero)."""
    al, ga, binv = build_tridiag_planes(
        diag.permute(1, 2, 0), upper.permute(1, 2, 0)
    )
    return TridiagPrecond(
        alphas=al.permute(0, 3, 1, 2),
        gammas=ga.permute(0, 3, 1, 2),
        binv=binv.permute(2, 0, 1),
    )


def tridiag_apply(pre: TridiagPrecond, r: torch.Tensor) -> torch.Tensor:
    """Solve ``M z = r`` with the PCR factors (exact up to f32): L
    shift-multiply-adds on ``r [N, d]``, then the block-diagonal ``binv``."""
    s = 1
    for l in range(pre.alphas.shape[0]):
        r = (
            r
            + bm.mv(pre.alphas[l], _shift_down(r, s))
            + bm.mv(pre.gammas[l], _shift_up(r, s))
        )
        s *= 2
    return bm.mv(pre.binv, r)


def chain_upper(
    sys: BlockSystem, odom_i: torch.Tensor, odom_j: torch.Tensor, n: int,
    group=None,
) -> torch.Tensor:
    """Superdiagonal ``[n, dp, dp]`` of the pose-chain part of S: the
    odometry off-diagonal blocks of consecutive poses (loop closures j != i+1 are excluded).  The
    reference's ``segment_sum``; each chain vertex has one such edge, and
    the padded edges add exact zeros, so the sum has one order."""
    m = (odom_j == odom_i + 1).to(sys.hpp_off.dtype)
    up = torch.zeros((n,) + sys.hpp_off.shape[1:], dtype=sys.hpp_off.dtype,
                     device=sys.hpp_off.device)
    up.index_add_(0, odom_i, sys.hpp_off * m[:, None, None])
    return all_reduce(group, up)[0]


def build_chunk_precond(
    diag: torch.Tensor, upper: torch.Tensor, chunk: int
) -> torch.Tensor:
    """The chunked local preconditioner: the explicit inverse of the
    block-tridiagonal part of S restricted to consecutive ``chunk``-pose
    chunks (the chain coupling across chunk boundaries is dropped).

    The diag/upper blocks go into dense ``[nb, chunk*d, chunk*d]`` chunk
    matrices (row ``t*d + a``, t the pose within its chunk; the ragged
    tail padded with identity rows), which are Jacobi-equilibrated (the
    1e6 gauge prior would otherwise cost the f32 inverse its digits),
    inverted and un-equilibrated.  ``diag [N,d,d]``, ``upper[v]`` the (v,
    v+1) chain block.  Returns ``inv [nb, chunk*d, chunk*d]``."""
    n, dp, _ = diag.shape
    nb = -(-n // chunk)
    pad = nb * chunk - n
    t = torch.arange(n, device=diag.device)
    keep = ((t % chunk) != (chunk - 1)) & (t < n - 1)
    up = upper * keep[:, None, None].to(upper.dtype)
    if pad:
        eye = torch.eye(dp, dtype=diag.dtype, device=diag.device)
        diag = torch.cat([diag, eye.expand(pad, dp, dp)], dim=0)
        up = torch.cat([up, up.new_zeros((pad, dp, dp))], dim=0)
    sd = diag.reshape(nb, chunk, dp, dp)
    su = up.reshape(nb, chunk, dp, dp)
    kd = chunk * dp
    b = diag.new_zeros((nb, kd, kd))
    tl = torch.arange(chunk, device=diag.device)
    for a in range(dp):
        for c in range(dp):
            b[:, tl * dp + a, tl * dp + c] = sd[:, :, a, c]
            b[:, tl[:-1] * dp + a, (tl[:-1] + 1) * dp + c] = su[:, :-1, a, c]
            b[:, (tl[:-1] + 1) * dp + a, tl[:-1] * dp + c] = su[:, :-1, c, a]
    s = torch.rsqrt(torch.clamp(torch.diagonal(b, dim1=-2, dim2=-1),
                                min=1e-30))
    scale = s[:, :, None] * s[:, None, :]
    return torch.linalg.inv(b * scale) * scale


def chunk_apply(inv: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``z = M^-1 r`` for the chunked preconditioner: one batched product,
    in full float32 (M^-1 must stay symmetric definite for PCG)."""
    n, dp = r.shape
    nb, kd, _ = inv.shape
    rp = F.pad(r, (0, 0, 0, nb * (kd // dp) - n))
    with _full_f32_matmul():
        zb = torch.einsum("bij,bj->bi", inv, rp.reshape(nb, kd))
    return zb.reshape(-1, dp)[:n]


@contextlib.contextmanager
def _full_f32_matmul():
    """Dense float32 products in full float32: TF32 off on the GPU for the
    duration (the reference asks XLA for HIGHEST precision), restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _block_pivot_floor(a: torch.Tensor) -> torch.Tensor:
    """Per-block pivot floor relative to the block's diagonal scale, so a
    clamped pivot stays on the block's own scale."""
    scale = torch.diagonal(a, dim1=-2, dim2=-1).abs().amax(-1)
    return torch.clamp(1.2e-7 * scale, min=1e-30)


def _chol2x2(a: torch.Tensor) -> torch.Tensor:
    """Closed-form Cholesky of batched SPD 2x2 blocks (clamped pivots, the
    sub-diagonal of a clamped column zeroed)."""
    tiny = _block_pivot_floor(a)
    d0 = a[..., 0, 0]
    s = torch.sqrt(torch.maximum(d0, tiny))
    l10 = torch.where(d0 > tiny, a[..., 1, 0] / s, 0.0)
    l11 = torch.sqrt(torch.maximum(a[..., 1, 1] - l10 * l10, tiny))
    z = torch.zeros_like(s)
    return torch.stack(
        [torch.stack([s, z], dim=-1), torch.stack([l10, l11], dim=-1)],
        dim=-2,
    )


def _chol_small(a: torch.Tensor) -> torch.Tensor:
    """Batched Cholesky of tiny SPD blocks with clamped pivots: the bounded,
    exact factor of a nearby SPD matrix.  Closed forms for 2x2/3x3."""
    k = a.shape[-1]
    if k == 2:
        return _chol2x2(a)
    if k == 3:
        tiny = _block_pivot_floor(a)
        d0 = a[..., 0, 0]
        ok0 = d0 > tiny
        l00 = torch.sqrt(torch.maximum(d0, tiny))
        l10 = torch.where(ok0, a[..., 1, 0] / l00, 0.0)
        l20 = torch.where(ok0, a[..., 2, 0] / l00, 0.0)
        d1 = a[..., 1, 1] - l10 * l10
        ok1 = d1 > tiny
        l11 = torch.sqrt(torch.maximum(d1, tiny))
        l21 = torch.where(ok1, (a[..., 2, 1] - l20 * l10) / l11, 0.0)
        l22 = torch.sqrt(
            torch.maximum(a[..., 2, 2] - l20 * l20 - l21 * l21, tiny)
        )
        z = torch.zeros_like(l00)
        return torch.stack([
            torch.stack([l00, z, z], -1),
            torch.stack([l10, l11, z], -1),
            torch.stack([l20, l21, l22], -1),
        ], -2)
    return torch.linalg.cholesky(a)


def spd_inverse(
    sc: torch.Tensor, ns_iters: int | None = None, cond_bound: float = 2e4,
) -> torch.Tensor:
    """Explicit inverse of a dense SPD matrix by Jacobi equilibration and
    Newton-Schulz, ``X <- X (2 I - A X)`` from ``X = I / ||A||_inf``.

    Every iterate is a polynomial in A, so the result is SPD at any
    iteration count.  ``ceil(log2(cond_bound)) + 10`` steps cover the slow
    phase and the quadratic tail; callers bound cond by a 1e-4 relative
    diagonal boost.  The products run in full float32."""
    if ns_iters is None:
        ns_iters = int(math.ceil(math.log2(cond_bound))) + 10
    s = torch.rsqrt(torch.clamp(torch.diagonal(sc), min=1e-30))
    a = sc * s[:, None] * s[None, :]
    lmax = a.abs().sum(1).max()
    eye = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    x = (1.0 / lmax) * eye
    two_eye = 2.0 * eye
    with _full_f32_matmul():
        for _ in range(ns_iters):
            x = x @ (two_eye - a @ x)
    # rescale first, symmetrize last: the result is exactly symmetric
    x = x * (s[:, None] * s[None, :])
    return 0.5 * (x + x.T)


def build_coarse_precond(
    d: BlockSystem,
    hll_inv: torch.Tensor,
    graph: FactorGraph2D,
    coarse_group: int,
    group=None,
) -> torch.Tensor:
    """Galerkin coarse operator of the two-level preconditioner, returned as
    its dense explicit inverse ``[dp*nc, dp*nc]`` (component-major: row
    ``a*nc + c``).

    Every ``coarse_group`` consecutive poses aggregate into one super-pose (0/1
    restriction R), and ``S_c = R^T S R`` is built from the block pieces:
    ``R^T Hpp R`` by sums over group pairs, and the fill
    ``R^T Hpl Hll^-1 Hlp R = V V^T`` with ``U = R^T Hpl`` (one sum over the
    edges) and ``V = U chol(Hll^-1)``: one ``[dp*nc, dl*M]`` product.  The
    reference's ``segment_sum``s are ``index_add_`` here.  Under ``group``
    the sums over the edge shards are summed across the ranks in one
    collective, so every rank holds the same coarse inverse."""
    n, m = graph.num_poses, graph.num_landmarks
    dp = d.hpp_diag.shape[-1]
    dl = d.hll.shape[-1]
    dev, dt = d.hpp_diag.device, d.hpp_diag.dtype
    nc = -(-n // coarse_group)     # the last aggregate may hold fewer poses

    gid = torch.arange(n, device=dev) // coarse_group
    gi = graph.odom.i // coarse_group
    gj = graph.odom.j // coarse_group
    hc = torch.zeros((nc * nc, dp, dp), dtype=dt, device=dev)
    hc.index_add_(0, gid * nc + gid, d.hpp_diag)
    hc.index_add_(0, gi * nc + gj, d.hpp_off)
    hc.index_add_(0, gj * nc + gi, d.hpp_off.transpose(-1, -2))
    ids = (graph.lm_edges.pose // coarse_group) * m + graph.lm_edges.lm
    u = torch.zeros((nc * m, dp * dl), dtype=dt, device=dev)
    u.index_add_(0, ids, d.hpl.reshape(-1, dp * dl))
    # as in the JAX package, the sum across ranks takes in the diagonal
    # blocks, which are complete on every rank: S_c's diagonal terms count
    # once per rank under a group (a preconditioner, not the operator)
    hc, u = all_reduce(group, hc, u)
    sc = hc.reshape(nc, nc, dp, dp).permute(2, 0, 3, 1).reshape(
        dp * nc, dp * nc
    )

    u = u.reshape(nc, m, dp, dl)                    # U[c, lm, a, b]
    el = _chol_small(hll_inv)                       # [m, dl, dl] lower
    # V[a*nc + c, b2*m + lm] = sum_b U[c, lm, a, b] L[lm, b, b2]
    v = sum(u[..., b, None] * el[None, :, None, b, :] for b in range(dl))
    vf = v.permute(2, 0, 3, 1).reshape(dp * nc, dl * m)
    with _full_f32_matmul():
        sc = sc - vf @ vf.T
    # scale-relative jitter: an SPD margin against f32 rounding
    sc = sc + torch.diag(1e-4 * torch.diagonal(sc))
    return spd_inverse(sc)


def coarse_apply(cinv: torch.Tensor, group: int,
                 r: torch.Tensor) -> torch.Tensor:
    """``R S_c^-1 R^T r``, the coarse correction ``[N, d] -> [N, d]``:
    sums over the groups, one product with the component-major explicit
    inverse (see :func:`build_coarse_precond`), and the broadcast back."""
    n, dp = r.shape
    nc = -(-n // group)      # the last group may be ragged
    rc = F.pad(r, (0, 0, 0, nc * group - n)).reshape(nc, group, dp).sum(1)
    with _full_f32_matmul():
        zc = cinv @ rc.T.reshape(-1)
    z = zc.reshape(dp, nc).T                            # [nc, dp]
    return z[:, None, :].expand(nc, group, dp).reshape(nc * group, dp)[:n]


class PCGResult(NamedTuple):
    x: torch.Tensor
    iterations: torch.Tensor
    residual_norm: torch.Tensor


class SolveStats(NamedTuple):
    """Per-solve telemetry carried through the linearize-solve interface."""

    pcg_iters: torch.Tensor      # i32[] PCG iterations used (0 = direct)
    pcg_residual: torch.Tensor   # f32[] final PCG residual norm (0 = direct)

    @staticmethod
    def direct(dtype=torch.float32, device=None) -> "SolveStats":
        """The stats of a direct (factorized) solve."""
        return SolveStats(
            pcg_iters=torch.zeros((), dtype=torch.int32, device=device),
            pcg_residual=torch.zeros((), dtype=dtype, device=device),
        )


def pcg(
    matvec, precond_apply, rhs: torch.Tensor, tol: float, max_iters: int,
    restart_every: int = 64, unroll: bool = False, group=None,
    dot_group=None,
) -> PCGResult:
    """Preconditioned conjugate gradients over pose-space ``[N, d]``
    tensors: the plain loop, the kernels' baseline and oracle.

    The loop runs in chunks of ``restart_every`` iterations.  After each
    chunk the true residual ``rhs - S x`` replaces the recurrence residual
    and the search direction restarts: in float32 the recurrence drifts
    from the true residual on ill-conditioned systems.  Within a chunk an
    iteration that is done (converged, at ``max_iters``, or after a
    breakdown, ``p^T S p <= 0`` or not finite, which stops the solve for
    good) is a masked no-op, so the loop reads one flag to the host per
    chunk and none per iteration.  ``unroll`` is the reference's XLA
    cost-analysis harness and is not ported (ROADMAP.md "Do not port").

    ``group`` is the process group of a sharded solve, whose ``matvec``
    sums across the ranks: there each iteration waits for the ranks anyway,
    so the loop reads the iteration's flag to the host and leaves the chunk
    at its first no-op iteration (the rest of the chunk would change
    nothing) instead of running its collectives.  ``dot_group`` set means
    the PCG state itself is sharded (the partitioned solve,
    ``parallel/partition.py``): the inner products sum their rank-local
    parts across the group, ``p^T A p`` and ``r^T r`` in one collective.
    Every flag read is of values that came out of an all-reduce or were
    computed alike on every rank, so the ranks take the same decisions."""
    if unroll:
        raise NotImplementedError(
            "pcg_unroll: the JAX package's cost-analysis harness is not "
            "ported (ROADMAP.md, 'Do not port')")

    def dots(*pairs):
        return all_reduce(dot_group, *((a * b).sum() for a, b in pairs))

    def dot(a, b):
        return dots((a, b))[0]

    atol2 = (tol ** 2) * dot(rhs, rhs)
    n_chunks = -(-max_iters // restart_every)
    x = torch.zeros_like(rhs)
    r = rhs
    z = precond_apply(r)
    p = z
    rz = dot(r, z)
    it = torch.zeros((), dtype=torch.int32, device=rhs.device)
    stop = torch.zeros((), dtype=torch.bool, device=rhs.device)
    zero = torch.zeros_like(rz)
    chunk = 0
    while chunk < n_chunks and bool(
        ((dot(r, r) > atol2) & ~stop).item()    # host sync, once a chunk
    ):
        for _ in range(restart_every):
            ap = matvec(p)
            pap, rr = dots((p, ap), (r, r))
            breakdown = ~(pap > 0.0) | ~torch.isfinite(pap)
            done = stop | breakdown | (rr <= atol2) | (it >= max_iters)
            if group is not None and bool(done.item()):
                stop = stop | breakdown
                break
            alpha = torch.where(done, zero, rz / pap)
            x = x + alpha * p
            r = r - alpha * ap
            z = precond_apply(r)
            rz_new = dot(r, z)
            beta = torch.where(
                done, zero, rz_new / torch.where(rz == 0.0, 1.0, rz))
            p = torch.where(done, p, z + beta * p)
            rz = torch.where(done, rz, rz_new)
            it = it + (~done).to(it.dtype)
            stop = stop | breakdown
        # true-residual replacement and direction restart
        r = rhs - matvec(x)
        z = precond_apply(r)
        rz = dot(r, z)
        p = z
        chunk += 1
    return PCGResult(x=x, iterations=it, residual_norm=torch.sqrt(dot(r, r)))


class PrecondState(NamedTuple):
    """The preconditioner of the plain PCG loop, built at one
    linearization (the carry of the stateful solve when the gate declines
    the kernels).  ``local``: a :class:`TridiagPrecond` ("tridiag"), the
    chunk inverses ("chunk") or the inverse diagonal blocks of S
    ("jacobi"); ``coarse``: the coarse level's explicit inverse, or None."""

    local: object
    coarse: torch.Tensor | None


def _matvec_and_sdiag(d: BlockSystem, hll_inv: torch.Tensor,
                      graph: FactorGraph2D, group=None):
    """The S operator at the current (damped) linearization on the
    vertex-major grids, and a thunk for the diagonal blocks of S (only a
    preconditioner build needs them); under ``group`` on this rank's edge
    shard, with its partials summed across the ranks."""
    op = make_plan_operator(d, hll_inv, graph)
    return ((lambda x: plan_matvec(op, x, group)),
            (lambda: plan_s_diag(op, group)))


def build_precond(
    d: BlockSystem,
    hll_inv: torch.Tensor,
    graph: FactorGraph2D,
    s_diag: torch.Tensor,
    precond: str,
    coarse_group: int,
    chunk: int = 64,
    group=None,
) -> PrecondState:
    """The plain loop's preconditioner at the current linearization:
    "jacobi" (inverse diagonal blocks of S), "tridiag" (PCR on the
    block-tridiagonal part of S), "chunk" (:func:`build_chunk_precond`),
    each optionally "+coarse" (the additive Galerkin coarse level over
    groups of ``coarse_group`` poses)."""
    local_kind, _, coarse_kind = precond.partition("+")
    if local_kind in ("tridiag", "chunk"):
        upper = chain_upper(d, graph.odom.i, graph.odom.j, graph.num_poses,
                            group)
        local = (build_tridiag_precond(s_diag, upper)
                 if local_kind == "tridiag"
                 else build_chunk_precond(s_diag, upper, chunk))
    else:
        local = inv_blocks(s_diag)
    coarse = None
    if coarse_kind == "coarse":
        coarse = build_coarse_precond(d, hll_inv, graph, coarse_group,
                                      group)
    return PrecondState(local=local, coarse=coarse)


def precond_apply_fn(pstate: PrecondState, precond: str, coarse_group: int):
    """The ``z = M^-1 r`` closure of a built :class:`PrecondState`."""
    local_kind, _, coarse_kind = precond.partition("+")
    if local_kind == "tridiag":
        local_apply = lambda r: tridiag_apply(pstate.local, r)  # noqa: E731
    elif local_kind == "chunk":
        local_apply = lambda r: chunk_apply(pstate.local, r)  # noqa: E731
    else:
        local_apply = lambda r: bm.mv(pstate.local, r)  # noqa: E731
    if coarse_kind == "coarse":
        return lambda r: (
            local_apply(r) + coarse_apply(pstate.coarse, coarse_group, r)
        )
    return local_apply


def schur_solve(
    sys: BlockSystem,
    graph: FactorGraph2D,
    lam: torch.Tensor,
    tol: float,
    max_iters: int,
    restart_every: int = 64,
    precond: str = "tridiag",
    coarse_group: int = 64,
    pstate: PrecondState | None = None,
    chunk: int = 64,
    unroll: bool = False,
    group=None,
) -> tuple[torch.Tensor, torch.Tensor, SolveStats]:
    """Solve ``(H + lam I) dx = -b`` by Schur elimination and the plain PCG
    loop.  A prebuilt ``pstate`` skips the preconditioner build (the
    stateful refresh path).  Under ``group`` (the edge-sharded solve) the
    PCG state is replicated on every rank and only the edge partials cross
    the ranks.  Returns ``(dx_poses [N, dp], dx_landmarks [M, dl],
    stats)``."""
    with tracing.span("toyslam.ops.eliminate"):
        plan = _plan(graph)
        d = damp(sys, lam)
        hll_inv = inv_blocks(d.hll)
        rhs = -d.bp + hpl_matvec(d, graph.lm_edges.lm, bm.mv(hll_inv, d.bl),
                                 plan, group)
        matvec, s_diag_fn = _matvec_and_sdiag(d, hll_inv, graph, group)
    if pstate is None:
        with tracing.span("toyslam.ops.precond"):
            pstate = build_precond(d, hll_inv, graph, s_diag_fn(), precond,
                                   coarse_group, chunk, group)
    with tracing.span("toyslam.ops.pcg"):
        res = pcg(matvec, precond_apply_fn(pstate, precond, coarse_group),
                  rhs, tol, max_iters, restart_every, unroll, group=group)
    with tracing.span("toyslam.ops.backsub"):
        u = hlp_matvec(d, graph.lm_edges.pose, res.x, plan, group)
        dx_l = bm.mv(hll_inv, -d.bl - u)
    return res.x, dx_l, SolveStats(pcg_iters=res.iterations,
                                   pcg_residual=res.residual_norm)


def schur_linearize_solve(cfg: OptimizerConfig, group=None):
    """The linearize-solve that ``GaussNewton`` calls each iteration:
    assemble, then the fused PCG solve in the mode the gate
    (``fused_pcg.fused_mode``) picks, the resident or the streamed band
    kernel, or the plain PCG loop (:func:`schur_solve`) where the gate
    declines them.  ``pcg_backend="fused"`` where it declines raises
    ``ValueError``.

    With ``cfg.pcg_precond_refresh != 1`` the solve is *stateful*: it
    exposes ``init_state(graph)`` and takes and returns a
    ``(FusedPrecond | PrecondState, call_count)`` carry, so
    ``GaussNewton`` threads one preconditioner through its loop.  It is
    rebuilt (at the current graph and lambda) when ``calls % refresh == 0
    and calls > 0``, so only for ``refresh > 1``; ``refresh <= 0`` keeps
    the first one.

    Under ``group`` (the edge-sharded solve) the solve is stateless and
    the gate declines the kernels, as the JAX package's does under an
    ``axis_name``."""
    from toyslam_torch.ops import fused_pcg as fp

    def _assemble(graph: FactorGraph2D) -> BlockSystem:
        with tracing.span("toyslam.ops.assemble"):
            return assemble_blocks(
                graph, huber_delta=cfg.huber_delta,
                fixed_prior=cfg.fixed_prior,
                exact_odom_jacobians=cfg.exact_odom_jacobians, group=group,
            )

    def _solve(graph, lam, pre=None):
        mode = fp.gated_mode(cfg, graph, group)
        sys = _assemble(graph)
        if mode is not None:
            dx_p, dx_l, stats = fp.fused_schur_solve(
                sys, graph, lam, cfg.pcg_tol, cfg.pcg_max_iters,
                cfg.pcg_precond, cfg.pcg_coarse_group, cfg.pcg_fused_chunk,
                cfg.pcg_restart_every, pre=pre, mode=mode,
            )
        else:
            dx_p, dx_l, stats = schur_solve(
                sys, graph, lam, cfg.pcg_tol, cfg.pcg_max_iters,
                cfg.pcg_restart_every, cfg.pcg_precond, cfg.pcg_coarse_group,
                pstate=pre, chunk=cfg.pcg_chunk, unroll=cfg.pcg_unroll,
                group=group,
            )
        return dx_p, dx_l, sys.err, stats

    refresh = cfg.pcg_precond_refresh
    if refresh == 1 or group is not None:

        def solve(graph: FactorGraph2D, lam: torch.Tensor):
            return _solve(graph, lam)

        return solve

    def _build(graph: FactorGraph2D, lam: torch.Tensor):
        with tracing.span("toyslam.ops.precond"):
            if fp.gated_mode(cfg, graph) is not None:
                return fp.fused_precond_from_graph(cfg, graph, lam)
            d = damp(_assemble(graph), lam)
            hll_inv = inv_blocks(d.hll)
            _, s_diag_fn = _matvec_and_sdiag(d, hll_inv, graph)
            return build_precond(d, hll_inv, graph, s_diag_fn(),
                                 cfg.pcg_precond, cfg.pcg_coarse_group,
                                 cfg.pcg_chunk)

    def init_state(graph: FactorGraph2D):
        lam0 = torch.tensor(cfg.lambda_init, dtype=graph.poses.dtype,
                            device=graph.device)
        return (_build(graph, lam0), 0)

    def solve_stateful(graph: FactorGraph2D, lam: torch.Tensor, state):
        pre, calls = state
        # calls == 0 is excluded: init_state built at this graph and lambda
        if refresh > 1 and calls % refresh == 0 and calls > 0:
            pre = _build(graph, lam)
        return _solve(graph, lam, pre) + ((pre, calls + 1),)

    solve_stateful.stateful = True
    solve_stateful.init_state = init_state
    return solve_stateful
