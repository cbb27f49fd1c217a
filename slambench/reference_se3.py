"""The plain reference that decides ``correct`` for SE(3) bundle
adjustment: the damped Gauss-Newton solve that a configuration of family
``se3`` states, written from its definition in plain PyTorch, with no
kernel, no layout and nothing of the program.

It takes the generated arrays (``graphs/camera_ring.py``: the arguments of
the port's ``graph3d_from_numpy``), the configuration's ``optimizer``
section and a precision, and works everything out again:

* poses ``[P, 12]``: the row-major rotation R, then the translation t; the
  retraction of a step ``(dt, omega)`` is ``t' = t + dt``,
  ``R' = R exp(omega^)``, and a relative pose is read in the chart
  ``(t, log R)``;
* relative-pose edges: ``r = log(M^-1 T_i^-1 T_j)`` with, for
  ``exact_odom_jacobians``, its exact Jacobians in closed form (with
  ``A = R_i^T R_j``, ``q = R_i^T (t_j - t_i)``, ``phi`` the rotation part
  of ``r`` and ``Jr^-1`` the inverse right Jacobian of SO(3)):
  ``dr_t/d(dt_i, omega_i) = (-R_m^T R_i^T, R_m^T [q]x)``,
  ``dr_t/d(dt_j, omega_j) = (R_m^T R_i^T, 0)``,
  ``dphi/domega_i = -Jr^-1(phi) A^T``, ``dphi/domega_j = Jr^-1(phi)``;
  otherwise ``-I`` and ``I``;
* pinhole reprojection of a world point into the camera at a pose (pose =
  camera to world) with the graph's intrinsics: ``x_c = R^T (X - t)``,
  ``r = (fx x/z + cx, fy y/z + cy) - uv`` with ``z`` clamped at the near
  plane (a fifth intrinsic, else 1e-6), and its 2x6 / 2x3 Jacobians
  ``J_proj (-R^T, [x_c]x)`` and ``J_proj R^T``, ``J_proj`` with no depth
  column below a given near plane;
* Huber weights on ``r^T W r``; the normal equations per vertex, the gauge
  prior ``fixed_prior`` on fixed poses, unit blocks on padded vertices,
  ``lambda I`` damping;
* Schur elimination of the 3x3 point blocks, PCG on the 6-dof pose system
  in the kernels' chunked control and the block-tridiagonal
  preconditioner of S solved exactly by cyclic reduction: ``Reduced``,
  ``Preconditioner`` and ``pcg`` of ``reference.py``, which read the block
  sizes off the arrays;
* back-substitution, and the Levenberg-Marquardt loop of
  ``reject_worse_steps``: a step whose robust chi^2 exceeds the
  linearization's is rejected and lambda multiplied by
  ``lambda_reject_factor``, an accepted one divides lambda by
  ``lambda_factor``; the loop stops where an accepted step is shorter than
  ``convergence_eps``.

Departures from the program, none of which changes the solve's
mathematics: the relative-pose Jacobians are in closed form where the
program differentiates its residual with ``torch.func.jacfwd``; ``log R``
takes its angle from ``atan2(|vee(R - R^T)| / 2, (tr R - 1) / 2)`` where
the program takes ``arccos`` (with a series near the identity); the
preconditioner is rebuilt at every GN iteration, as the program's
``schur3d`` solve does whatever ``pcg_precond_refresh`` says; only
``reject_worse_steps`` loops are solved (another raises).

Precision: float64 is the reference; float32 with TF32-rounded matrix
products (``reference.Ops``) is the control.  ``optimize(..., pcg_prec=)``
runs the PCG and its preconditioner alone at another precision (the
reduced system rounded to it), the rest at ``prec``: a control of the
linear solve's precision (kernel B2's part in the program).  TF32 is
switched off in PyTorch while a solve runs, so the rounding is this
module's alone.

Imports: torch, numpy and ``slambench.reference``.
"""

from __future__ import annotations

import contextlib
import copy
import math

import numpy as np
import torch

from slambench import reference
from slambench.reference import Precision, Result

REFERENCE = reference.REFERENCE
CONTROL = reference.CONTROL


# --- SO(3) -------------------------------------------------------------------


def hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], z, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _eye(x, d=3):
    return torch.eye(d, dtype=x.dtype, device=x.device)


def exp_so3(ops, w):
    """Rodrigues' formula, with its series below an angle of 1e-4."""
    th2 = (w * w).sum(-1)
    small = th2 < 1e-8
    safe = torch.where(small, torch.ones_like(th2), th2).sqrt()
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(safe) / safe)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(safe)) / safe**2)
    k = hat(w)
    return (_eye(w) + a[..., None, None] * k
            + b[..., None, None] * ops.mm(k, k))


def log_so3(R):
    """The rotation vector of ``R`` (angles below pi), with the series
    of ``th / sin th`` below a sine of 1e-6."""
    v = 0.5 * torch.stack([R[..., 2, 1] - R[..., 1, 2],
                           R[..., 0, 2] - R[..., 2, 0],
                           R[..., 1, 0] - R[..., 0, 1]], -1)
    s2 = (v * v).sum(-1)
    small = s2 < 1e-12
    s = torch.where(small, torch.ones_like(s2), s2).sqrt()
    c = 0.5 * (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0)
    th = torch.atan2(s, c)
    scale = torch.where(small, 1.0 + s2 / 6.0, th / s)
    return v * scale[..., None]


def jr_inv(ops, phi):
    """The inverse right Jacobian of SO(3) at ``phi``:
    ``I + [phi]x / 2 + (1/th^2 - (1 + cos th) / (2 th sin th)) [phi]x^2``,
    its last coefficient by its series below an angle of 1e-2."""
    th2 = (phi * phi).sum(-1)
    small = th2 < 1e-4
    safe = torch.where(small, torch.ones_like(th2), th2).sqrt()
    c = torch.where(
        small, 1.0 / 12.0 + th2 / 720.0 + th2 * th2 / 30240.0,
        1.0 / safe**2 - (1.0 + torch.cos(safe)) / (2.0 * safe
                                                   * torch.sin(safe)))
    k = hat(phi)
    return (_eye(phi) + 0.5 * k + c[..., None, None] * ops.mm(k, k))


def rot(p):
    return p[..., :9].reshape(p.shape[:-1] + (3, 3))


def trans(p):
    return p[..., 9:12]


def retract(ops, poses, step):
    r = ops.mm(rot(poses), exp_so3(ops, step[..., 3:6]))
    return torch.cat([r.reshape(r.shape[:-2] + (9,)),
                      trans(poses) + step[..., :3]], -1)


# --- edges -------------------------------------------------------------------


def _t(x):
    return x.transpose(-1, -2)


def odom_residual(ops, pi, pj, meas, exact: bool = False):
    """``r = log(M^-1 T_i^-1 T_j)`` in the ``(t, log R)`` chart, ``[E,
    6]``; with ``exact``, also its Jacobians ``dr/d(step_i)``,
    ``dr/d(step_j)``, each ``[E, 6, 6]``."""
    ri_t, rm_t = _t(rot(pi)), _t(rot(meas))
    a = ops.mm(ri_t, rot(pj))                        # R_i^T R_j
    q = ops.mv(ri_t, trans(pj) - trans(pi))          # R_i^T (t_j - t_i)
    r_t = ops.mv(rm_t, q - trans(meas))
    phi = log_so3(ops.mm(rm_t, a))
    r = torch.cat([r_t, phi], -1)
    if not exact:
        return r
    jinv = jr_inv(ops, phi)
    rmri = ops.mm(rm_t, ri_t)
    zero = torch.zeros_like(rmri)
    ja = torch.cat([torch.cat([-rmri, ops.mm(rm_t, hat(q))], -1),
                    torch.cat([zero, -ops.mm(jinv, _t(a))], -1)], -2)
    jb = torch.cat([torch.cat([rmri, zero], -1),
                    torch.cat([zero, jinv], -1)], -2)
    return r, ja, jb


def reprojection(ops, poses, points, intrinsics, meas, jacobians=False):
    """Pinhole residual ``[E, 2]`` of world points seen from the cameras
    at ``poses``; with ``jacobians``, also ``dr/d(step)`` ``[E, 2, 6]``
    and ``dr/dX`` ``[E, 2, 3]``."""
    r_t = _t(rot(poses))
    xc = ops.mv(r_t, points - trans(poses))
    fx, fy, cx, cy = intrinsics[:4]
    near = intrinsics[4] if len(intrinsics) > 4 else 1e-6
    inv_z = 1.0 / torch.clamp(xc[..., 2], min=near)
    u, v = xc[..., 0] * inv_z, xc[..., 1] * inv_z
    r = torch.stack([fx * u + cx, fy * v + cy], -1) - meas
    if not jacobians:
        return r
    z = torch.zeros_like(u)
    # below a given near plane the projection does not move with the depth
    dz = inv_z if len(intrinsics) == 4 else inv_z * (xc[..., 2] > near)
    jp = torch.stack([torch.stack([fx * inv_z, z, -fx * u * dz], -1),
                      torch.stack([z, fy * inv_z, -fy * v * dz], -1)], -2)
    ja = torch.cat([-ops.mm(jp, r_t), ops.mm(jp, hat(xc))], -1)
    return r, ja, ops.mm(jp, r_t)


# --- the problem -------------------------------------------------------------


class Problem:
    """The generated arrays on ``device`` at ``prec``: every vertex
    (padding included, as the program solves it) and the real edges, with
    the fields ``reference.Reduced`` and ``reference.Preconditioner``
    read."""

    def __init__(self, arrays: dict, device, prec: Precision):
        dt = prec.dtype

        def f(a):
            return torch.as_tensor(np.asarray(a), device=device).to(dt)

        def i(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        oi, oj, om, oinf, omask = arrays["odom"]
        lp, ll, lmeas, linf, lmask = arrays["lm_edges"]
        ko, kl = np.asarray(omask) > 0, np.asarray(lmask) > 0
        self.ops = reference.Ops(prec)
        self.poses0, self.landmarks0 = f(arrays["poses"]), f(arrays["landmarks"])
        self.pose_fixed, self.lm_fixed = (f(arrays["pose_fixed"]),
                                          f(arrays["lm_fixed"]))
        self.pose_mask, self.lm_mask = f(arrays["pose_mask"]), f(arrays["lm_mask"])
        self.intrinsics = [float(x) for x in np.asarray(arrays["intrinsics"])]
        self.oi, self.oj = i(np.asarray(oi)[ko]), i(np.asarray(oj)[ko])
        self.omeas, self.oinfo = f(np.asarray(om)[ko]), f(np.asarray(oinf)[ko])
        self.lp, self.ll = i(np.asarray(lp)[kl]), i(np.asarray(ll)[kl])
        self.lmeas, self.linfo = f(np.asarray(lmeas)[kl]), f(np.asarray(linf)[kl])
        self.n, self.m = self.poses0.shape[0], self.landmarks0.shape[0]
        self.dtype, self.device = dt, self.poses0.device


def _chi2(r, info):
    return torch.einsum("ea,eab,eb->e", r, info, r)


def robust_chi2(pb: Problem, poses, landmarks, huber_delta) -> torch.Tensor:
    """The objective: robust chi^2 of the real edges at a state."""
    ops = pb.ops
    r = odom_residual(ops, poses[pb.oi], poses[pb.oj], pb.omeas)
    e_o, _ = reference.huber(_chi2(r, pb.oinfo), huber_delta)
    r = reprojection(ops, poses[pb.lp], landmarks[pb.ll], pb.intrinsics,
                     pb.lmeas)
    e_l, _ = reference.huber(_chi2(r, pb.linfo), huber_delta)
    return e_o.sum() + e_l.sum()


def linearize(pb: Problem, poses, landmarks, opt: dict) -> reference.System:
    ops, delta, scatter = pb.ops, opt["huber_delta"], reference._scatter
    pi, pj = poses[pb.oi], poses[pb.oj]
    if opt["exact_odom_jacobians"]:
        r, ja, jb = odom_residual(ops, pi, pj, pb.omeas, exact=True)
    else:
        r = odom_residual(ops, pi, pj, pb.omeas)
        eye = _eye(r, 6)
        ja, jb = (-eye).expand(r.shape[0], 6, 6), eye.expand(r.shape[0], 6, 6)
    err_o, w = reference.huber(_chi2(r, pb.oinfo), delta)
    wi = w[:, None, None] * pb.oinfo
    wr = ops.mv(wi, r)
    hpp = (scatter(pb.oi, ops.mm(_t(ja), ops.mm(wi, ja)), pb.n)
           + scatter(pb.oj, ops.mm(_t(jb), ops.mm(wi, jb)), pb.n))
    off = ops.mm(_t(ja), ops.mm(wi, jb))
    bp = (scatter(pb.oi, ops.mv(_t(ja), wr), pb.n)
          + scatter(pb.oj, ops.mv(_t(jb), wr), pb.n))

    r, ja, jb = reprojection(ops, poses[pb.lp], landmarks[pb.ll],
                             pb.intrinsics, pb.lmeas, jacobians=True)
    err_l, w = reference.huber(_chi2(r, pb.linfo), delta)
    wi = w[:, None, None] * pb.linfo
    wjb, wr = ops.mm(wi, jb), ops.mv(wi, r)
    hpp = hpp + scatter(pb.lp, ops.mm(_t(ja), ops.mm(wi, ja)), pb.n)
    hll = scatter(pb.ll, ops.mm(_t(jb), wjb), pb.m)
    hpl = ops.mm(_t(ja), wjb)
    bp = bp + scatter(pb.lp, ops.mv(_t(ja), wr), pb.n)
    bl = scatter(pb.ll, ops.mv(_t(jb), wr), pb.m)

    prior = opt["fixed_prior"]
    pose_reg = prior * pb.pose_fixed + 1.0 - pb.pose_mask
    lm_reg = prior * pb.lm_fixed + 1.0 - pb.lm_mask
    hpp = hpp + pose_reg[:, None, None] * _eye(hpp, 6)
    hll = hll + lm_reg[:, None, None] * _eye(hll)
    return reference.System(hpp, off, hll, hpl,
                            bp * (1.0 - pb.pose_fixed)[:, None],
                            bl * (1.0 - pb.lm_fixed)[:, None],
                            err_o.sum() + err_l.sum())


def damp(sys: reference.System, lam) -> reference.System:
    return sys._replace(hpp=sys.hpp + lam * _eye(sys.hpp, 6),
                        hll=sys.hll + lam * _eye(sys.hll))


def solve_step(pb: Problem, poses, landmarks, lam, opt: dict,
               pcg_pb: Problem | None = None):
    """One damped linearize-solve: ``(dx_poses [P, 6], dx_points [L, 3],
    robust chi^2, PCG iterations)``.  With ``pcg_pb``, the reduced system
    is handed to the PCG and its preconditioner at ``pcg_pb``'s precision,
    and everything else stays at ``pb``'s."""
    sys = linearize(pb, poses, landmarks, opt)
    red = reference.Reduced(pb, damp(sys, lam))
    rhs = red.rhs()
    solver = red
    if pcg_pb is not None:
        # S's blocks, Hll^-1 and the right-hand side rounded to pcg_pb's
        # precision, whose products the PCG and the preconditioner take
        dt = pcg_pb.dtype
        solver = copy.copy(red)
        solver.pb, solver.hll_inv = pcg_pb, red.hll_inv.to(dt)
        solver.d = red.d._replace(
            **{k: v.to(dt) for k, v in red.d._asdict().items()})
        rhs = rhs.to(dt)
    pre = reference.Preconditioner(solver, opt["pcg_precond"],
                                   opt["pcg_coarse_group"])
    dx_p, n_it = reference.pcg(solver, pre, rhs, opt)
    dx_p = dx_p.to(pb.dtype)
    return dx_p, red.back_substitute(dx_p), sys.err, n_it


@contextlib.contextmanager
def _no_tf32():
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved


def optimize(arrays: dict, opt: dict, device="cpu",
             prec: Precision = REFERENCE,
             pcg_prec: Precision | None = None) -> Result:
    """The configuration's solve of the generated graph ``arrays``; with
    ``pcg_prec``, its PCG alone at that precision."""
    if opt["solver"] != "schur3d" or not opt["reject_worse_steps"]:
        raise ValueError("the SE(3) reference solves 'schur3d' with "
                         "reject_worse_steps")
    if opt["pcg_precond"] != "tridiag":
        raise ValueError("the SE(3) reference builds the 'tridiag' "
                         "preconditioner")
    with _no_tf32():
        pb = Problem(arrays, device, prec)
        pcg_pb = None if pcg_prec is None else Problem(arrays, device,
                                                       pcg_prec)
        poses, landmarks = pb.poses0, pb.landmarks0
        lam = opt["lambda_init"]
        errors, iters = [], []
        it = 0
        while it < opt["iterations"]:
            dx_p, dx_l, err, n_it = solve_step(pb, poses, landmarks, lam, opt,
                                                pcg_pb)
            err = float(err)
            errors.append(err)
            iters.append(n_it)
            step_p, step_l = dx_p * opt["lr"], dx_l * opt["lr"]
            dx_norm = math.sqrt(float((step_p**2).sum() + (step_l**2).sum()))
            new_p = retract(pb.ops, poses, step_p)
            new_l = landmarks + step_l
            accept = float(robust_chi2(pb, new_p, new_l,
                                       opt["huber_delta"])) <= err
            it += 1
            if accept:
                poses, landmarks = new_p, new_l
                lam = max(lam / opt["lambda_factor"], opt["lambda_min"])
                if dx_norm < opt["convergence_eps"]:
                    break
            else:
                lam = min(lam * opt["lambda_reject_factor"],
                          opt["lambda_max"])
    return Result(poses, landmarks, errors, iters, it)
