"""Damped Gauss-Newton over a :class:`FactorGraph2D` or, with
``solver="schur3d"``, a :class:`FactorGraph3D`.

Control flow is that of ``toyslam_tpu.optimizer.gauss_newton._run``, as a
Python loop in place of ``lax.while_loop``:

* adaptive lambda damping, factor ``lambda_factor`` in
  [lambda_min, lambda_max], increased when the error grew since the
  previous iteration, updated *after* the iteration's solve;
* early stop after ``penalty_limit`` consecutive error increases (the old
  state is kept on that iteration);
* convergence when ``||lr * dx|| < convergence_eps``;
* with ``reject_worse_steps``, Levenberg-Marquardt step rejection;
* a stateful solve (``pcg_precond_refresh != 1``) gets its carry from
  ``solve.init_state(graph)`` and threads it through the iterations.

All loop state stays on the graph's device; the loop reads the
``converged``/``diverged`` flags to the host once per iteration.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple

import torch

from toyslam_torch.config import OptimizerConfig
from toyslam_torch.models.graph import FactorGraph2D
from toyslam_torch.ops import se2, se3


class OptimizeResult(NamedTuple):
    graph: FactorGraph2D
    errors: torch.Tensor          # f32[iterations] robust chi^2 (nan-padded)
    iterations_run: int
    converged: bool               # stopped via ||dx|| < eps
    diverged: bool                # stopped via the worsening-error penalty
    pcg_iters: torch.Tensor       # i32[iterations] PCG iters per GN iter
    pcg_residuals: torch.Tensor   # f32[iterations] final PCG residual
    lambdas: torch.Tensor         # f32[iterations] damping per GN iter


def dense_linearize_solve(cfg: OptimizerConfig):
    """Dense H assembly (``ops/assemble.py``) and a direct solve:
    ``dense_factorization="cholesky"`` (the default) or "lu"."""
    from toyslam_torch.ops import assemble
    from toyslam_torch.ops.schur import SolveStats

    def solve(graph: FactorGraph2D, lam: torch.Tensor):
        sys = assemble.assemble_dense(
            graph, huber_delta=cfg.huber_delta, fixed_prior=cfg.fixed_prior,
            exact_odom_jacobians=cfg.exact_odom_jacobians,
        )
        d = sys.H.shape[0]
        h_reg = sys.H + lam * torch.eye(d, dtype=sys.H.dtype,
                                        device=sys.H.device)
        if cfg.dense_factorization == "cholesky":
            chol = torch.linalg.cholesky(h_reg)
            dx = torch.cholesky_solve(-sys.b[:, None], chol)[:, 0]
        else:
            dx = torch.linalg.solve(h_reg, -sys.b)
        n = graph.num_poses
        dx_p = dx[: 3 * n].reshape(n, 3)
        dx_l = dx[3 * n:].reshape(graph.num_landmarks, 2)
        return dx_p, dx_l, sys.err, SolveStats.direct(sys.H.dtype,
                                                      sys.H.device)

    return solve


@dataclasses.dataclass(frozen=True)
class GaussNewton:
    """Configured optimizer.  ``solve`` is a linearize-solve
    ``(graph, lam) -> (dx_poses, dx_landmarks, err, stats)``; by default
    that of ``config.solver``: "dense" (:func:`dense_linearize_solve`),
    "schur" (Schur elimination with the fused-PCG kernels or the plain PCG
    loop), "schur_grid" (``ops/grid_schur.py``), all on SE(2) graphs with
    ``se2.retract``, or "schur3d" (SE(3) BA graphs, ``se3.retract``).
    Landmarks update additively in all.  A solve with a ``prepare``
    attribute lays out the graph for itself before the loop."""

    config: OptimizerConfig = OptimizerConfig()
    solve: Callable | None = None
    retract: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None = None
    # graph -> robust chi^2; used when config.reject_worse_steps
    error_fn: Callable | None = None

    def __post_init__(self):
        object.__setattr__(self, "_builtin_solver", self.solve is None)
        cfg = self.config
        se3d = cfg.solver == "schur3d"
        if self.solve is None:
            if cfg.solver == "schur":
                from toyslam_torch.ops.schur import schur_linearize_solve

                solve = schur_linearize_solve(cfg)
            elif cfg.solver == "schur_grid":
                from toyslam_torch.ops.grid_schur import grid_linearize_solve

                solve = grid_linearize_solve(cfg)
            elif se3d:
                from toyslam_torch.ops.schur3d import schur3d_linearize_solve

                solve = schur3d_linearize_solve(cfg)
            else:
                solve = dense_linearize_solve(cfg)
            object.__setattr__(self, "solve", solve)
        if self.retract is None:
            object.__setattr__(self, "retract",
                               se3.retract if se3d else se2.retract)
        if cfg.reject_worse_steps and self.error_fn is None:
            if se3d:
                from toyslam_torch.ops.schur3d import total_error_3d

                err = functools.partial(
                    total_error_3d, huber_delta=cfg.huber_delta,
                    exact_odom_jacobians=cfg.exact_odom_jacobians)
            else:
                from toyslam_torch.ops.assemble import total_error

                err = functools.partial(
                    total_error, huber_delta=cfg.huber_delta,
                    exact_odom_jacobians=cfg.exact_odom_jacobians)
            object.__setattr__(self, "error_fn", err)

    def _prepare(self, graph: FactorGraph2D) -> FactorGraph2D:
        """Lay the graph out for the solve, host-side, once per graph
        structure: the solve's own ``prepare`` where it has one (the grid
        plan of "schur_grid"), else, for the built-in Schur solves, the
        gather tables and, on large graphs, the band layout.  The band
        search is skipped when the config pins the plain PCG loop, which
        never streams it."""
        prep = getattr(self.solve, "prepare", None)
        if prep is not None:
            return prep(graph)
        if (self._builtin_solver and self.config.solver in ("schur", "schur3d")
                and graph.plan is None):
            from toyslam_torch.ops.gather_plan import attach_plan

            graph = attach_plan(
                graph, want_band=self.config.pcg_backend != "xla")
        return graph

    def optimize(self, graph: FactorGraph2D) -> OptimizeResult:
        return _run(self.config, self.solve, self.retract, self.error_fn,
                    self._prepare(graph))

    def step(
        self, graph: FactorGraph2D, lam: float | None = None
    ) -> tuple[FactorGraph2D, torch.Tensor]:
        """One GN step at damping ``lam`` (default ``lambda_init``)."""
        cfg = self.config
        graph = self._prepare(graph)
        lam_t = torch.tensor(cfg.lambda_init if lam is None else lam,
                             dtype=graph.poses.dtype, device=graph.device)
        if getattr(self.solve, "stateful", False):
            # a single step builds and discards a preconditioner state
            dx_p, dx_l, err, _, _ = self.solve(
                graph, lam_t, self.solve.init_state(graph))
        else:
            dx_p, dx_l, err, _ = self.solve(graph, lam_t)
        poses = self.retract(graph.poses, dx_p * cfg.lr)
        landmarks = graph.landmarks + dx_l * cfg.lr
        return graph.with_state(poses, landmarks), err


def _run(cfg, solve, retract, error_fn, graph: FactorGraph2D) -> OptimizeResult:
    dev, dtype = graph.device, graph.poses.dtype

    def scalar(v, dt=dtype):
        return torch.tensor(v, dtype=dt, device=dev)

    poses, landmarks = graph.poses, graph.landmarks
    prev_err = scalar(-1.0)
    penalty = scalar(0, torch.int32)
    lam = scalar(cfg.lambda_init)
    errors = torch.full((cfg.iterations,), float("nan"), dtype=dtype,
                        device=dev)
    pcg_iters = torch.zeros((cfg.iterations,), dtype=torch.int32, device=dev)
    pcg_residuals = torch.full_like(errors, float("nan"))
    lambdas = torch.full_like(errors, float("nan"))
    it, converged, diverged = 0, False, False
    # the carry of a stateful solve (the refreshed PCG preconditioner)
    stateful = getattr(solve, "stateful", False)
    sstate = solve.init_state(graph) if stateful else None

    while it < cfg.iterations and not converged and not diverged:
        g = graph.with_state(poses, landmarks)
        if stateful:
            dx_p, dx_l, err, stats, sstate = solve(g, lam, sstate)
        else:
            dx_p, dx_l, err, stats = solve(g, lam)
        step_p = dx_p * cfg.lr
        step_l = dx_l * cfg.lr
        dx_norm = torch.sqrt((step_p**2).sum() + (step_l**2).sum())
        errors[it] = err
        pcg_iters[it] = stats.pcg_iters
        pcg_residuals[it] = stats.pcg_residual
        lambdas[it] = lam

        if cfg.reject_worse_steps:
            new_poses = retract(poses, step_p)
            new_landmarks = landmarks + step_l
            err_new = error_fn(graph.with_state(new_poses, new_landmarks))
            accept = err_new <= err
            lam = torch.where(
                accept,
                torch.clamp(lam / cfg.lambda_factor, min=cfg.lambda_min),
                torch.clamp(lam * cfg.lambda_reject_factor,
                            max=cfg.lambda_max),
            )
            poses = torch.where(accept, new_poses, poses)
            landmarks = torch.where(accept, new_landmarks, landmarks)
            prev_err = torch.where(accept, err_new, err)
            penalty = torch.where(accept, 0, penalty + 1).to(torch.int32)
            conv_t = accept & (dx_norm < cfg.convergence_eps)
            div_t = torch.zeros_like(conv_t)  # lambda control bounds steps
        else:
            increased = (prev_err >= 0.0) & (err > prev_err)
            lam = torch.where(
                increased,
                torch.clamp(lam * cfg.lambda_factor, max=cfg.lambda_max),
                torch.clamp(lam / cfg.lambda_factor, min=cfg.lambda_min),
            )
            penalty = torch.where(increased, penalty + 1, 0).to(torch.int32)
            div_t = penalty > cfg.penalty_limit
            conv_t = (dx_norm < cfg.convergence_eps) & ~div_t
            # on a divergence break the old state is kept
            poses = torch.where(div_t, poses, retract(poses, step_p))
            landmarks = torch.where(div_t, landmarks, landmarks + step_l)
            prev_err = err
        it += 1
        converged, diverged = (
            bool(v) for v in torch.stack([conv_t, div_t]).tolist()
        )   # host sync, once per iteration

    return OptimizeResult(
        graph=graph.with_state(poses, landmarks),
        errors=errors,
        iterations_run=it,
        converged=converged,
        diverged=diverged,
        pcg_iters=pcg_iters,
        pcg_residuals=pcg_residuals,
        lambdas=lambdas,
    )
