"""Grid-order Schur assembly and solve (``solver="schur_grid"``).

The general Schur path (``ops/schur.py``) linearizes edges in insertion
order, so every per-vertex sum is a gather over edge-order arrays, the
vertex-major PCG operator is re-laid out every GN iteration, and the chain
part of the matvec gathers neighbours that are adjacent rows.  This module
fixes the edge order on the host instead: the landmark edges are stored
twice, sorted by landmark into a ``[M, Kl]`` grid and by pose into
``[N, Kp]``, and the odometry chain positionally (row v = edge (v, v+1)).
The per-edge formulas (``ops/edge_blocks.py``) run on flat views of the
grids, every reduction is a dense sum over the slot axis, and the chain
part of the matvec is two shifts.

Scope: SE(2), chain-only odometry (``build_grid_plan`` refuses anything
else).  The PCG runs in the plain loop of ``ops/schur.py`` or, where
:func:`_band_mode` admits it, in the band kernel B2 on the operator of
``fused_pcg.build_band_operator_grid``.

Port of ``toyslam_tpu.ops.grid_schur``.  The reference gates the band
kernel by a cost model fitted on a TPU v5e and by its on-chip memory; here
the model is re-fitted on an H100 and the gate is that of the band branch
of ``fused_pcg.fused_mode``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from toyslam_torch import tracing
from toyslam_torch.config import OptimizerConfig
from toyslam_torch.models.graph import FactorGraph2D, TensorTree
from toyslam_torch.ops import band_plan
from toyslam_torch.ops import blockmath as bm
from toyslam_torch.ops import edge_blocks
from toyslam_torch.ops import fused_pcg
from toyslam_torch.ops import residuals as res_ops
from toyslam_torch.ops import schur

_f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class GridPlan(TensorTree):
    """Host-built dual-order edge storage (see the module docstring).
    Landmark-major arrays are ``[M * Kl]``, pose-major ``[N * Kp]``; the
    grids are reshapes."""

    # landmark-major copy: slot (m, k) = the k-th observation of landmark m
    L_pose: torch.Tensor   # int64[M*Kl] observing pose
    L_lm: torch.Tensor     # int64[M*Kl]
    L_meas: torch.Tensor   # f32[M*Kl, 2]
    L_info: torch.Tensor   # f32[M*Kl, 2, 2]
    L_mask: torch.Tensor   # f32[M*Kl]
    # pose-major copy: slot (p, k) = the k-th observation from pose p
    P_pose: torch.Tensor   # int64[N*Kp]
    P_lm: torch.Tensor     # int64[N*Kp]
    P_meas: torch.Tensor
    P_info: torch.Tensor
    P_mask: torch.Tensor
    # odometry chain, positional (row v = edge (v, v+1); last row masked)
    C_meas: torch.Tensor   # f32[N, 3]
    C_info: torch.Tensor   # f32[N, 3, 3]
    C_mask: torch.Tensor   # f32[N]
    # the band layout re-addressed to the pose-major grid
    # (band_plan.GridBandAux), on large graphs with run-local observations
    band: object = None


def build_grid_plan(graph: FactorGraph2D,
                    want_band: bool | None = None) -> GridPlan:
    """Host-side dual-order construction.  Raises ``ValueError`` if a real
    odometry edge is not a chain edge (j = i+1) or a chain pair carries
    two edges.  From 2048 poses the band layout is searched too, unless
    ``want_band`` is False (the config pins the plain loop)."""
    n, m = graph.num_poses, graph.num_landmarks

    def host(t):
        return t.detach().cpu().numpy()

    lp, ll = host(graph.lm_edges.pose), host(graph.lm_edges.lm)
    lmeas, linfo = host(graph.lm_edges.meas), host(graph.lm_edges.info)
    real = host(graph.lm_edges.mask) > 0

    def order_copy(key_ids, num):
        ids = key_ids[real]
        sel = np.nonzero(real)[0]
        counts = np.bincount(ids, minlength=num)
        k = max(int(counts.max()) if counts.size else 0, 1)
        slot_pose = np.zeros(num * k, np.int64)
        slot_lm = np.zeros(num * k, np.int64)
        slot_meas = np.zeros((num * k, 2), np.float32)
        slot_info = np.zeros((num * k, 2, 2), np.float32)
        slot_mask = np.zeros(num * k, np.float32)
        order = np.argsort(ids, kind="stable")
        sid, sedge = ids[order], sel[order]
        starts = np.searchsorted(sid, np.arange(num))
        flat = sid * k + (np.arange(sid.shape[0]) - starts[sid])
        slot_pose[flat] = lp[sedge]
        slot_lm[flat] = ll[sedge]
        slot_meas[flat] = lmeas[sedge]
        slot_info[flat] = linfo[sedge]
        slot_mask[flat] = 1.0
        return slot_pose, slot_lm, slot_meas, slot_info, slot_mask

    L = order_copy(ll, m)
    P = order_copy(lp, n)

    oi, oj = host(graph.odom.i), host(graph.odom.j)
    oreal = host(graph.odom.mask) > 0
    if not np.all(oj[oreal] == oi[oreal] + 1):
        raise ValueError("grid_schur requires chain-only odometry")
    rows = oi[oreal]
    if np.unique(rows).size != rows.size:
        # one edge per (v, v+1) pair is stored; a second would be dropped
        # where the general path sums it
        raise ValueError("grid_schur requires at most one odometry edge "
                         "per (v, v+1) pair")
    C_meas = np.zeros((n, 3), np.float32)
    C_info = np.zeros((n, 3, 3), np.float32)
    C_mask = np.zeros(n, np.float32)
    C_meas[rows] = host(graph.odom.meas)[oreal]
    C_info[rows] = host(graph.odom.info)[oreal]
    C_mask[rows] = 1.0
    band = None
    if n >= 2048 and want_band is not False:
        # the scale threshold of the gather plan's band
        band = band_plan.build_grid_band(graph, P[0], P[1], P[4],
                                         P[0].shape[0] // n)
    dev = graph.device

    def t(a):
        return torch.as_tensor(a, device=dev)

    return GridPlan(
        *(t(a) for a in L), *(t(a) for a in P),
        C_meas=t(C_meas), C_info=t(C_info), C_mask=t(C_mask), band=band,
    )


@dataclasses.dataclass(frozen=True)
class _GridSystem:
    """Per-solve linearized quantities in grid order."""

    hpp_diag: torch.Tensor   # [N, 3, 3]
    tupper: torch.Tensor     # [N, 3, 3] chain (v, v+1) blocks
    hll: torch.Tensor        # [M, 2, 2]
    bp: torch.Tensor         # [N, 3]
    bl: torch.Tensor         # [M, 2]
    err: torch.Tensor        # []
    hpl_L: torch.Tensor      # [M, Kl, 3, 2]
    hpl_P: torch.Tensor      # [N, Kp, 3, 2]
    kl: int
    kp: int


def _assemble(graph: FactorGraph2D, gp: GridPlan,
              cfg: OptimizerConfig) -> _GridSystem:
    n, m = graph.num_poses, graph.num_landmarks
    kl = gp.L_pose.shape[0] // m
    kp = gp.P_pose.shape[0] // n

    # landmark edges in both orders, the formulas of the general path
    lb_L = edge_blocks.lm_edge_blocks(
        graph.poses, graph.landmarks, gp.L_pose, gp.L_lm, gp.L_meas,
        gp.L_info, gp.L_mask, cfg.huber_delta,
    )
    lb_P = edge_blocks.lm_edge_blocks(
        graph.poses, graph.landmarks, gp.P_pose, gp.P_lm, gp.P_meas,
        gp.P_info, gp.P_mask, cfg.huber_delta,
    )
    hll = lb_L.w_btb.reshape(m, kl, 2, 2).sum(1)
    bl = lb_L.bl_c.reshape(m, kl, 2).sum(1)
    hpp_lm = lb_P.w_ata.reshape(n, kp, 3, 3).sum(1)
    bp_lm = lb_P.bp_c.reshape(n, kp, 3).sum(1)

    # odometry chain: row v = edge (v, v+1); the per-row blocks combine
    # into the diagonal and superdiagonal by shifts
    vidx = torch.arange(n, device=graph.device)
    jidx = torch.clamp(vidx + 1, max=n - 1)
    if cfg.exact_odom_jacobians:
        od = res_ops.eval_odom_edges(
            graph.poses, vidx, jidx, gp.C_meas, gp.C_info, gp.C_mask,
            cfg.huber_delta, exact=True,
        )
        w_od = od.w[:, None, None] * gp.C_info
        ata = bm.quad(od.JA, w_od)
        btb = bm.quad(od.JB, w_od)
        tupper = bm.mtm(od.JA, bm.mm(w_od, od.JB))
        wr = bm.mv(w_od, od.r)
        bp_i, bp_j = bm.mtv(od.JA, wr), bm.mtv(od.JB, wr)
        odom_err = od.robust_err.sum()
    else:
        ob = edge_blocks.odom_edge_blocks(
            graph.poses, vidx, jidx, gp.C_meas, gp.C_info, gp.C_mask,
            cfg.huber_delta,
        )
        ata = btb = ob.w_info
        tupper = -ob.w_info
        bp_i, bp_j = -ob.wr, ob.wr
        odom_err = ob.robust_err.sum()

    hpp_diag = hpp_lm + ata + schur._shift_down(btb, 1)
    bp = bp_lm + bp_i + schur._shift_down(bp_j, 1)

    # gauge priors and padding regularization, as in assemble_blocks
    eye3 = torch.eye(3, dtype=_f32, device=graph.device)
    eye2 = torch.eye(2, dtype=_f32, device=graph.device)
    pose_reg = cfg.fixed_prior * graph.pose_fixed + (1.0 - graph.pose_mask)
    lm_reg = cfg.fixed_prior * graph.lm_fixed + (1.0 - graph.lm_mask)
    return _GridSystem(
        hpp_diag=hpp_diag + pose_reg[:, None, None] * eye3,
        tupper=tupper,
        hll=hll + lm_reg[:, None, None] * eye2,
        bp=bp * (1.0 - graph.pose_fixed)[:, None],
        bl=bl * (1.0 - graph.lm_fixed)[:, None],
        err=odom_err + lb_L.robust_err.sum(),
        hpl_L=lb_L.w_hpl.reshape(m, kl, 3, 2),
        hpl_P=lb_P.w_hpl.reshape(n, kp, 3, 2),
        kl=kl, kp=kp,
    )


def _flat_system(g: _GridSystem) -> schur.BlockSystem:
    """Flat view of the grid quantities, so that
    ``schur.build_coarse_precond`` runs on them unchanged."""
    return schur.BlockSystem(
        hpp_diag=g.hpp_diag, hpp_off=g.tupper, hll=g.hll,
        hpl=g.hpl_P.reshape(-1, 3, 2), bp=g.bp, bl=g.bl, err=g.err,
    )


class _FlatGraphView:
    """Graph view over the pose-major grid for the coarse build: the chain
    as odometry edges (v, v+1) and the grid slots as landmark edges."""

    class _O:
        def __init__(self, n, device):
            self.i = torch.arange(n, device=device)
            self.j = torch.clamp(self.i + 1, max=n - 1)

    class _E:
        def __init__(self, pose, lm):
            self.pose = pose
            self.lm = lm

    def __init__(self, graph, gp: GridPlan):
        self.num_poses = graph.num_poses
        self.num_landmarks = graph.num_landmarks
        self.odom = self._O(graph.num_poses, graph.device)
        self.lm_edges = self._E(gp.P_pose, gp.P_lm)
        self.plan = None


def _damp(g: _GridSystem, lam: torch.Tensor) -> _GridSystem:
    eye3 = torch.eye(3, dtype=_f32, device=g.hpp_diag.device)
    eye2 = torch.eye(2, dtype=_f32, device=g.hll.device)
    return dataclasses.replace(g, hpp_diag=g.hpp_diag + lam * eye3,
                               hll=g.hll + lam * eye2)


def _matvec_factory(d: _GridSystem, hll_inv: torch.Tensor, gp: GridPlan,
                    n: int, m: int):
    """The S matvec on the grids, and a thunk for the diagonal blocks of
    S."""
    pose_L = gp.L_pose.reshape(m, d.kl)
    lm_P = gp.P_lm.reshape(n, d.kp)
    tlow = schur._shift_down(d.tupper, 1).transpose(-1, -2)

    def matvec(x):
        u = bm.mtv(d.hpl_L, x[pose_L]).sum(1)          # [M, 2]
        v = bm.mv(hll_inv, u)
        w = bm.mv(d.hpl_P, v[lm_P]).sum(1)             # [N, 3]
        y = bm.mv(d.hpp_diag, x)
        y = y + bm.mv(d.tupper, schur._shift_up(x, 1))
        y = y + bm.mv(tlow, schur._shift_down(x, 1))
        return y - w

    def s_diag():
        contrib = bm.mm(bm.mm(d.hpl_P, hll_inv[lm_P]),
                        d.hpl_P.transpose(-1, -2)).sum(1)
        return d.hpp_diag - contrib

    return matvec, s_diag


# The band-vs-grid cost model of pcg_backend="auto", per GN iteration of
# ``iters`` PCG iterations, fitted on an NVIDIA H100 80GB HBM3 at a 700 W
# power limit from the grid_gate_fit, band100k_gate_fit and
# incr100k_gate_fit lines of chip_smoke.py (PERF.md) at four layouts (tile
# stacks of 49, 179 and 245 MB and 3.05 GB):
#   band = _BAND_GN_S + iters * (_BAND_TRIP_S + stack_bytes / _BAND_STREAM_BW)
#   grid = iters * _GRID_ITER_S
# A B2 trip took 88-196 us at 49-245 MB and 1.63-1.69 ms at 3.05 GB with
# jacobi+coarse, whose least-squares line is 72 us + bytes at 1.93 TB/s
# (2.01-2.03 ms at 3.05 GB with tridiag+coarse: 17 PCR levels, 1568
# coarse groups); the band operator's build (the tile write) 0.42-1.42 ms
# at 49-245 MB.  The plain grid loop is launch-bound: an iteration took
# 1.34-4.82 ms with tridiag+coarse at 4096 and 10240 poses and 2.40-2.80
# at 100352, and 0.55-1.45 ms with jacobi+coarse at 100352.  The model
# takes the cheapest, 0.55 ms: "auto" takes the band only where it beats
# the plain loop at its best.
#
# Stacks above the 10k rows' 245 MB are declined.  At the one larger
# layout measured (3.05 GB, 100k poses) B2 lost to the plain loop with
# jacobi+coarse (8.0 against 16.5 GN-iter/s, band100k_path); with
# tridiag+coarse it ran more GN iterations a second (4.5-4.8 against
# 3.2-3.7) but the route, which restarts the PCG direction at every chunk
# of 16 where the loop restarts every 30, left the 100k plateau rows at a
# worse chi^2 (plateau-100k-revisit-incr-init stopped by the penalty rule
# at 1.77e6 after 33 of 80 iterations, failing its gate; the plain loop
# ends at 2.25e5-2.29e5): no faster to their stated quality.  Stacks between 245
# MB and 3.05 GB are not measured.
_BAND_GN_S = 1.0e-3
_BAND_TRIP_S = 7.2e-5
_BAND_STREAM_BW = 1.93e12
_GRID_ITER_S = 0.55e-3
_BAND_FIT_MAX_BYTES = 250_000_000


def _cost_model(cfg, gp: GridPlan) -> tuple[float, float]:
    """Modeled seconds per GN iteration of the band kernel (operator build
    and stream) and of the plain grid loop."""
    iters = max(1, cfg.pcg_max_iters)
    t_band = _BAND_GN_S + iters * (_BAND_TRIP_S
                                   + gp.band.tile_bytes / _BAND_STREAM_BW)
    return t_band, iters * _GRID_ITER_S


def _band_cost_wins(cfg, gp: GridPlan, n: int) -> bool:
    """Whether the band kernel is modeled cheaper than the plain grid loop
    (:func:`_cost_model`) on a stack within the range where its route was
    measured to pay.  Used for ``pcg_backend="auto"`` only; "fused" forces
    the band."""
    if gp.band.tile_bytes > _BAND_FIT_MAX_BYTES:
        return False
    t_band, t_grid = _cost_model(cfg, gp)
    return t_band < t_grid


def _band_mode(cfg, gp: GridPlan, n: int) -> bool:
    """The static gate of the band kernel inside the grid solver: the plan
    found a band layout, the backend asks for it ("fused" forces it,
    "auto" applies :func:`_band_cost_wins`), the preconditioner maps into
    the kernel (a "jacobi" or "tridiag" local part; a coarse level whose
    group divides Np), and the layout fits the kernel's shared memory and
    device-memory budgets (``fused_pcg.band_fits``, as in
    ``fused_pcg.fused_mode``)."""
    band = gp.band
    if band is None or cfg.pcg_backend == "xla" or cfg.pcg_unroll:
        return False
    local_kind, _, coarse_kind = cfg.pcg_precond.partition("+")
    if local_kind not in ("jacobi", "tridiag"):
        return False
    if coarse_kind == "coarse" and n % cfg.pcg_coarse_group:
        return False
    if cfg.pcg_backend == "auto" and not _band_cost_wins(cfg, gp, n):
        return False
    nlevels = max(1, (n - 1).bit_length()) if local_kind == "tridiag" else 0
    nc = -(-n // cfg.pcg_coarse_group) if coarse_kind == "coarse" else 0
    return fused_pcg.band_fits(3, n, band, 2 * band.n_wide, nlevels, nc)


def _build_precond(cfg, d: _GridSystem, hll_inv, s_diag, graph, gp):
    """The preconditioner at the current linearization: ``(local,
    coarse)`` for the plain loop, or a ``fused_pcg.FusedPrecond`` (plane
    layout, coarse level as ``cinv`` and ``rmat``) when :func:`_band_mode`
    holds; the choice is static in the config, so the stateful carry keeps
    one kind."""
    local_kind, _, coarse_kind = cfg.pcg_precond.partition("+")
    upper = d.tupper * gp.C_mask[:, None, None]
    if local_kind == "tridiag":
        local = schur.build_tridiag_precond(s_diag, upper)
    elif local_kind == "chunk":
        local = schur.build_chunk_precond(s_diag, upper, cfg.pcg_chunk)
    else:
        local = schur.inv_blocks(s_diag)
    coarse = None
    if coarse_kind == "coarse":
        coarse = schur.build_coarse_precond(
            _flat_system(d), hll_inv, _FlatGraphView(graph, gp),
            cfg.pcg_coarse_group,
        )
    if _band_mode(cfg, gp, graph.num_poses):
        return fused_pcg.fused_precond_from_parts(
            local_kind, local, coarse, graph.num_poses, 3,
            cfg.pcg_coarse_group)
    return (local, coarse)


def _precond_apply(cfg, pre):
    """The plain loop's ``z = M^-1 r`` for a built ``(local, coarse)``."""
    return schur.precond_apply_fn(schur.PrecondState(*pre), cfg.pcg_precond,
                                  cfg.pcg_coarse_group)


def _solve_once(cfg, graph: FactorGraph2D, gp: GridPlan, lam, pre=None):
    n, m = graph.num_poses, graph.num_landmarks
    with tracing.span("toyslam.ops.assemble"):
        sys_g = _assemble(graph, gp, cfg)
    with tracing.span("toyslam.ops.eliminate"):
        d = _damp(sys_g, lam)
        hll_inv = schur.inv_blocks(d.hll)
        matvec, s_diag_fn = _matvec_factory(d, hll_inv, gp, n, m)

        pose_L = gp.L_pose.reshape(m, d.kl)
        lm_P = gp.P_lm.reshape(n, d.kp)
        v0 = bm.mv(hll_inv, d.bl)
        rhs = -d.bp + bm.mv(d.hpl_P, v0[lm_P]).sum(1)

    if pre is None:
        with tracing.span("toyslam.ops.precond"):
            pre = _build_precond(cfg, d, hll_inv, s_diag_fn(), graph, gp)
    with tracing.span("toyslam.ops.pcg"):
        if _band_mode(cfg, gp, n):
            upper = d.tupper * gp.C_mask[:, None, None]
            bop = fused_pcg.build_band_operator_grid(
                d.hll, d.hpl_P, lm_P, d.hpp_diag, upper, gp.band, n)
            res = fused_pcg.band_fused_pcg(
                bop, pre, rhs.T.contiguous(), cfg.pcg_tol,
                cfg.pcg_max_iters, cfg.pcg_fused_chunk,
                cfg.pcg_restart_every)
            dx_p = res.x.T
        else:
            res = schur.pcg(matvec, _precond_apply(cfg, pre), rhs,
                            cfg.pcg_tol, cfg.pcg_max_iters,
                            cfg.pcg_restart_every, cfg.pcg_unroll)
            dx_p = res.x
    with tracing.span("toyslam.ops.backsub"):
        u = bm.mtv(d.hpl_L, dx_p[pose_L]).sum(1)
        dx_l = bm.mv(hll_inv, -d.bl - u)
    stats = schur.SolveStats(pcg_iters=res.iterations,
                             pcg_residual=res.residual_norm)
    return dx_p, dx_l, sys_g.err, stats


def grid_linearize_solve(cfg: OptimizerConfig):
    """The linearize-solve of ``solver="schur_grid"``.  Its ``prepare``
    (called by ``GaussNewton`` before the loop) builds the
    :class:`GridPlan` on the host once per graph structure.

    Honors ``cfg.pcg_precond_refresh`` as the general path does: K != 1
    returns a stateful solve that rebuilds the preconditioner every K-th
    iteration (0: never after the first build)."""
    refresh = cfg.pcg_precond_refresh

    def _prepare(graph: FactorGraph2D) -> FactorGraph2D:
        if isinstance(graph.plan, GridPlan):
            return graph
        return dataclasses.replace(
            graph,
            plan=build_grid_plan(graph, want_band=cfg.pcg_backend != "xla"),
        )

    if refresh == 1:

        def solve(graph: FactorGraph2D, lam):
            return _solve_once(cfg, graph, graph.plan, lam)

        solve.prepare = _prepare
        return solve

    def _build(graph, lam):
        gp = graph.plan
        with tracing.span("toyslam.ops.precond"):
            with tracing.span("toyslam.ops.assemble"):
                sys_g = _assemble(graph, gp, cfg)
            d = _damp(sys_g, lam)
            hll_inv = schur.inv_blocks(d.hll)
            _, s_diag_fn = _matvec_factory(d, hll_inv, gp, graph.num_poses,
                                           graph.num_landmarks)
            return _build_precond(cfg, d, hll_inv, s_diag_fn(), graph, gp)

    def init_state(graph):
        lam0 = torch.tensor(cfg.lambda_init, dtype=graph.poses.dtype,
                            device=graph.device)
        return (_build(graph, lam0), 0)

    def solve_stateful(graph: FactorGraph2D, lam, state):
        pre, calls = state
        if refresh > 1 and calls % refresh == 0 and calls > 0:
            pre = _build(graph, lam)
        return _solve_once(cfg, graph, graph.plan, lam, pre=pre) + (
            (pre, calls + 1),)

    solve_stateful.stateful = True
    solve_stateful.init_state = init_state
    solve_stateful.prepare = _prepare
    return solve_stateful
