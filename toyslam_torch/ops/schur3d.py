"""Block-sparse SE(3) BA normal equations: assembly and the Schur/fused-PCG
solve.

The 3D counterpart of ``ops/schur.py``'s ``assemble_blocks``: pose blocks
are 6-dof (dt, omega), landmark blocks 3-dof, and reprojection edges couple
them.  Everything past the assembly (damping, landmark elimination, the
PCR preconditioner, the fused operators and both kernels) reads the block
sizes off the arrays, so the SE(2) solve machinery runs unchanged on the
6/3 systems built here, with the kernels instantiated at dp=6.

Port of ``toyslam_tpu.ops.schur3d``.  The per-vertex sums go through the
graph's gather tables, as ``schur.assemble_blocks`` does.  Spans: the
solve's assembly is ``toyslam.ops.assemble``, and the edges' residuals and
Jacobians inside it, and the residuals of :func:`total_error_3d` (the step
rejection's chi^2), are ``toyslam.ops.edges3d``.  Where the gate
declines the kernels (``pcg_backend="xla"``, loop closures in an SE(3)
graph, layouts past the budgets) the solve takes the plain PCG loop of
``schur.schur_solve`` at dp=6, dl=3, as the reference does.  The
reference's ``axis_name`` hooks are the optional ``group`` arguments, as in
``ops/schur.py``: the edge-sharded SE(3) solve
(``parallel.distributed_linearize_solve_3d``) sums its per-vertex partials
across a ``torch.distributed`` process group.
"""

from __future__ import annotations

import torch

from toyslam_torch import tracing
from toyslam_torch.config import OptimizerConfig
from toyslam_torch.models.graph3d import FactorGraph3D
from toyslam_torch.ops import blockmath as bm
from toyslam_torch.ops import edge_blocks3d as eb3
from toyslam_torch.ops import gather_plan as gp
from toyslam_torch.ops import residuals3d as res3
from toyslam_torch.ops import schur
from toyslam_torch.ops.collective import all_reduce
from toyslam_torch.ops.schur import BlockSystem, _plan


def assemble_blocks_3d(
    graph: FactorGraph3D,
    huber_delta: float,
    fixed_prior: float = 1e6,
    exact_odom_jacobians: bool = False,
    group=None,
) -> BlockSystem:
    """Linearize every edge and sum the 6/3 blocks per vertex through the
    graph's gather tables (and across ``group``, in one collective, as
    ``schur.assemble_blocks`` does)."""
    plan = _plan(graph)
    t_oi, t_oj = plan.odom_by_i, plan.odom_by_j
    t_lp, t_ll = plan.lm_by_pose, plan.lm_by_lm
    with tracing.span("toyslam.ops.edges3d"):
        od = res3.eval_odom3d_edges(
            graph.poses, graph.odom.i, graph.odom.j, graph.odom.meas,
            graph.odom.info, graph.odom.mask, huber_delta,
            exact=exact_odom_jacobians,
        )
        rb = eb3.reproj_edge_blocks(
            graph.poses, graph.landmarks, graph.intrinsics,
            graph.lm_edges.pose, graph.lm_edges.lm, graph.lm_edges.meas,
            graph.lm_edges.info, graph.lm_edges.mask, huber_delta,
        )

    # relative-pose contributions
    w_od = od.w[:, None, None] * graph.odom.info        # [E1, 6, 6]
    wr = bm.mv(w_od, od.r)
    bp = (gp.table_sum(bm.mtv(od.JA, wr), t_oi)
          + gp.table_sum(bm.mtv(od.JB, wr), t_oj))
    hpp_diag = (gp.table_sum(bm.quad(od.JA, w_od), t_oi)
                + gp.table_sum(bm.quad(od.JB, w_od), t_oj))
    hpp_off = bm.mtm(od.JA, bm.mm(w_od, od.JB))

    # reprojection contributions
    hpp_diag = hpp_diag + gp.table_sum(rb.w_ata, t_lp)
    hll = gp.table_sum(rb.w_btb, t_ll)
    bp = bp + gp.table_sum(rb.bp_c, t_lp)
    bl = gp.table_sum(rb.bl_c, t_ll)
    hpp_diag, hll, bp, bl, err = all_reduce(
        group, hpp_diag, hll, bp, bl,
        od.robust_err.sum() + rb.robust_err.sum())

    # gauge priors + padding regularization
    eye6 = torch.eye(6, dtype=hpp_diag.dtype, device=hpp_diag.device)
    eye3 = torch.eye(3, dtype=hll.dtype, device=hll.device)
    pose_reg = fixed_prior * graph.pose_fixed + (1.0 - graph.pose_mask)
    lm_reg = fixed_prior * graph.lm_fixed + (1.0 - graph.lm_mask)
    hpp_diag = hpp_diag + pose_reg[:, None, None] * eye6
    hll = hll + lm_reg[:, None, None] * eye3
    bp = bp * (1.0 - graph.pose_fixed)[:, None]
    bl = bl * (1.0 - graph.lm_fixed)[:, None]
    return BlockSystem(
        hpp_diag=hpp_diag, hpp_off=hpp_off, hll=hll, hpl=rb.w_hpl,
        bp=bp, bl=bl, err=err,
    )


def total_error_3d(
    graph: FactorGraph3D,
    huber_delta: float,
    exact_odom_jacobians: bool = False,
) -> torch.Tensor:
    """Robustified chi^2 of the current state (residuals only, no solve):
    the ``error_fn`` of the Levenberg-Marquardt step rejection.  The
    Jacobians are not needed, so the odometry residuals skip them whatever
    ``exact_odom_jacobians`` says, as in the reference."""
    with tracing.span("toyslam.ops.edges3d"):
        od = res3.eval_odom3d_edges(
            graph.poses, graph.odom.i, graph.odom.j, graph.odom.meas,
            graph.odom.info, graph.odom.mask, huber_delta, exact=False,
        )
        rp = res3.eval_reproj_edges(
            graph.poses, graph.landmarks, graph.intrinsics,
            graph.lm_edges.pose, graph.lm_edges.lm, graph.lm_edges.meas,
            graph.lm_edges.info, graph.lm_edges.mask, huber_delta,
        )
    return od.robust_err.sum() + rp.robust_err.sum()


def schur3d_linearize_solve(cfg: OptimizerConfig, group=None):
    """The linearize-solve of ``GaussNewton`` for SE(3) graphs (with
    ``retract=se3.retract``): assemble, then the fused PCG solve in the mode
    the gate picks, with both kernels at dp=6, or the plain PCG loop where
    the gate declines them (``pcg_backend="fused"`` there raises
    ``ValueError``).  Returns ``(dx_poses [N, 6], dx_landmarks [M, 3], err,
    stats)``.  Like the reference's, this solve carries no preconditioner
    state: it builds one per call whatever ``pcg_precond_refresh`` says.
    Under ``group`` it runs on this rank's edge shard with the plain loop."""
    from toyslam_torch.ops import fused_pcg as fp

    def solve(graph: FactorGraph3D, lam: torch.Tensor):
        mode = fp.gated_mode(cfg, graph, group)
        with tracing.span("toyslam.ops.assemble"):
            sys = assemble_blocks_3d(
                graph, huber_delta=cfg.huber_delta,
                fixed_prior=cfg.fixed_prior,
                exact_odom_jacobians=cfg.exact_odom_jacobians, group=group,
            )
        if mode is not None:
            dx_p, dx_l, stats = fp.fused_schur_solve(
                sys, graph, lam, cfg.pcg_tol, cfg.pcg_max_iters,
                cfg.pcg_precond, cfg.pcg_coarse_group, cfg.pcg_fused_chunk,
                cfg.pcg_restart_every, mode=mode,
            )
        else:
            dx_p, dx_l, stats = schur.schur_solve(
                sys, graph, lam, cfg.pcg_tol, cfg.pcg_max_iters,
                cfg.pcg_restart_every, cfg.pcg_precond, cfg.pcg_coarse_group,
                chunk=cfg.pcg_chunk, unroll=cfg.pcg_unroll, group=group,
            )
        return dx_p, dx_l, sys.err, stats

    return solve
