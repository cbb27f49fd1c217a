"""Block-sparse normal equations with Schur-complement landmark elimination.

The landmark-landmark block ``Hll`` is block-diagonal (2x2 per landmark), so
landmarks are eliminated locally and the reduced pose system

    S = Hpp - Hpl Hll^-1 Hlp,     S dx_p = -b_p + Hpl Hll^-1 b_l

is solved by preconditioned conjugate gradients.  This module holds the
blocks, their per-vertex sums, the damping, the small-block inverses, the
block-tridiagonal PCR preconditioner build and the linearize-solve that
``GaussNewton`` calls; the PCG loop itself is the fused kernel of
``ops/fused_pcg.py``.

Subset of ``toyslam_tpu.ops.schur`` on the main path.  Not here yet
(ROADMAP.md §A): the plain ``schur_solve``/``pcg`` loop, the chunk and coarse
preconditioners, and the stateful ``pcg_precond_refresh != 1`` solve.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from toyslam_torch.config import OptimizerConfig
from toyslam_torch.models.graph import FactorGraph2D
from toyslam_torch.ops import blockmath as bm
from toyslam_torch.ops import edge_blocks
from toyslam_torch.ops import gather_plan as gp


def _plan(graph: FactorGraph2D) -> gp.GatherPlan:
    if graph.plan is None:
        raise ValueError(
            "the graph has no gather plan: call "
            "toyslam_torch.ops.gather_plan.attach_plan(graph) first "
            "(GaussNewton does so itself)"
        )
    return graph.plan


class BlockSystem(NamedTuple):
    """Undamped block-sparse normal equations (gauge priors included)."""

    hpp_diag: torch.Tensor   # f32[N,3,3] pose diagonal blocks
    hpp_off: torch.Tensor    # f32[E1,3,3] odometry off-diagonal block at (i, j)
    hll: torch.Tensor        # f32[M,2,2] landmark diagonal blocks
    hpl: torch.Tensor        # f32[E2,3,2] pose-landmark coupling per edge
    bp: torch.Tensor         # f32[N,3] pose gradient
    bl: torch.Tensor         # f32[M,2] landmark gradient
    err: torch.Tensor        # f32[] robust chi^2


def assemble_blocks(
    graph: FactorGraph2D,
    huber_delta: float,
    fixed_prior: float = 1e6,
    exact_odom_jacobians: bool = False,
) -> BlockSystem:
    """Linearize every edge and sum the blocks per vertex through the
    graph's gather tables."""
    if exact_odom_jacobians:
        raise NotImplementedError(
            "exact_odom_jacobians=True is not ported yet (ROADMAP.md, "
            "queue A: exact_odom_jacobians)"
        )
    plan = _plan(graph)
    t_oi, t_oj = plan.odom_by_i, plan.odom_by_j
    t_lp, t_ll = plan.lm_by_pose, plan.lm_by_lm

    # A=-I, B=I collapses every odometry product to ±W'
    ob = edge_blocks.odom_edge_blocks(
        graph.poses, graph.odom.i, graph.odom.j, graph.odom.meas,
        graph.odom.info, graph.odom.mask, huber_delta,
    )
    bp = gp.table_sum(-ob.wr, t_oi) + gp.table_sum(ob.wr, t_oj)
    hpp_diag = gp.table_sum(ob.w_info, t_oi) + gp.table_sum(ob.w_info, t_oj)
    hpp_off = -ob.w_info

    lb = edge_blocks.lm_edge_blocks(
        graph.poses, graph.landmarks, graph.lm_edges.pose, graph.lm_edges.lm,
        graph.lm_edges.meas, graph.lm_edges.info, graph.lm_edges.mask,
        huber_delta,
    )
    hpp_diag = hpp_diag + gp.table_sum(lb.w_ata, t_lp)
    hll = gp.table_sum(lb.w_btb, t_ll)
    bp = bp + gp.table_sum(lb.bp_c, t_lp)
    bl = gp.table_sum(lb.bl_c, t_ll)

    # gauge priors + padding regularization
    eye3 = torch.eye(3, dtype=hpp_diag.dtype, device=hpp_diag.device)
    eye2 = torch.eye(2, dtype=hll.dtype, device=hll.device)
    pose_reg = fixed_prior * graph.pose_fixed + (1.0 - graph.pose_mask)
    lm_reg = fixed_prior * graph.lm_fixed + (1.0 - graph.lm_mask)
    hpp_diag = hpp_diag + pose_reg[:, None, None] * eye3
    hll = hll + lm_reg[:, None, None] * eye2
    bp = bp * (1.0 - graph.pose_fixed)[:, None]
    bl = bl * (1.0 - graph.lm_fixed)[:, None]

    err = ob.robust_err.sum() + lb.robust_err.sum()
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
    """Batched small-block inverse: closed forms for 2x2/3x3."""
    k = blocks.shape[-1]
    if k == 2:
        return inv2x2(blocks)
    if k == 3:
        return inv3x3(blocks)
    return torch.linalg.inv(blocks)


def hlp_matvec(
    sys: BlockSystem, lm_pose: torch.Tensor, x: torch.Tensor, plan
) -> torch.Tensor:
    """``Hlp @ x = Hpl^T @ x`` for ``x [N, 3]`` -> [M, 2]."""
    return gp.table_sum(bm.mtv(sys.hpl, x[lm_pose]), plan.lm_by_lm)


def hpl_matvec(
    sys: BlockSystem, lm_lm: torch.Tensor, y: torch.Tensor, plan
) -> torch.Tensor:
    """``Hpl @ y`` for ``y [M, 2]`` -> [N, 3]."""
    return gp.table_sum(bm.mv(sys.hpl, y[lm_lm]), plan.lm_by_pose)


def schur_s_diag(
    sys: BlockSystem, hll_inv: torch.Tensor, graph: FactorGraph2D
) -> torch.Tensor:
    """Diagonal blocks of S: ``[N, d, d]`` (exact when each (pose, landmark)
    pair is observed by one edge, as in the per-frame frontend)."""
    contrib = bm.mm(bm.mm(sys.hpl, hll_inv[graph.lm_edges.lm]),
                    sys.hpl.transpose(-1, -2))
    return sys.hpp_diag - gp.table_sum(contrib, _plan(graph).lm_by_pose)


def _shift_down(x: torch.Tensor, s: int) -> torch.Tensor:
    """``y[i] = x[i-s]`` with zero fill (block arrays, axis 0)."""
    if s >= x.shape[0]:
        return torch.zeros_like(x)
    return torch.cat([torch.zeros_like(x[:s]), x[:-s]], dim=0)


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
    """Closed-form inverse of 2x2/3x3 blocks in plane layout [d,d,N]."""
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
    the fused kernel reads."""
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


def chain_upper(
    sys: BlockSystem, odom_i: torch.Tensor, odom_j: torch.Tensor, n: int
) -> torch.Tensor:
    """Superdiagonal of the pose-chain part of S: the odometry off-diagonal
    blocks of consecutive poses (loop closures j != i+1 are excluded).  The
    reference's ``segment_sum``; each chain vertex has one such edge, and
    the padded edges add exact zeros, so the sum has one order."""
    m = (odom_j == odom_i + 1).to(sys.hpp_off.dtype)
    up = torch.zeros((n,) + sys.hpp_off.shape[1:], dtype=sys.hpp_off.dtype,
                     device=sys.hpp_off.device)
    return up.index_add_(0, odom_i, sys.hpp_off * m[:, None, None])


class PCGResult(NamedTuple):
    x: torch.Tensor
    iterations: torch.Tensor
    residual_norm: torch.Tensor


class SolveStats(NamedTuple):
    """Per-solve telemetry carried through the linearize-solve interface."""

    pcg_iters: torch.Tensor      # i32[] PCG iterations used
    pcg_residual: torch.Tensor   # f32[] final PCG residual norm


def schur_linearize_solve(cfg: OptimizerConfig):
    """The linearize-solve that ``GaussNewton`` calls each iteration:
    assemble, then the fused resident PCG solve.

    Only the reference's ``pcg_precond_refresh == 1`` branch exists here;
    the gate (``fused_pcg.fused_mode``) raises where the reference would
    take its plain PCG loop or the streamed band kernel."""
    if cfg.pcg_precond_refresh != 1:
        raise NotImplementedError(
            f"pcg_precond_refresh={cfg.pcg_precond_refresh}: only 1 "
            "(rebuild every iteration) is ported (ROADMAP.md, queue A: "
            "pcg_precond_refresh != 1)"
        )
    from toyslam_torch.ops import fused_pcg as fp

    def solve(graph: FactorGraph2D, lam: torch.Tensor):
        mode = fp.fused_mode(cfg, graph)
        sys = assemble_blocks(
            graph, huber_delta=cfg.huber_delta,
            fixed_prior=cfg.fixed_prior,
            exact_odom_jacobians=cfg.exact_odom_jacobians,
        )
        dx_p, dx_l, stats = fp.fused_schur_solve(
            sys, graph, lam, cfg.pcg_tol, cfg.pcg_max_iters,
            cfg.pcg_precond, cfg.pcg_coarse_group, cfg.pcg_fused_chunk,
            cfg.pcg_restart_every, mode=mode,
        )
        return dx_p, dx_l, sys.err, stats

    return solve
