"""The plain reference that decides ``correct``: the damped Gauss-Newton
solve that a configuration states, written from its definition in plain
PyTorch, with no kernel, no layout and nothing of the program.

It takes the generated arrays (``generators.py``), the configuration's
``optimizer`` section and a precision, and works everything out again:

* linearization: SE(2) odometry residuals ``m^-1 (+) (p_i^-1 (+) p_j)`` with
  the upstream approximation ``A = -I, B = I`` or their exact Jacobians,
  range-bearing residuals with their exact Jacobians, Huber weights on
  ``r^T W r``;
* the normal equations per vertex, the 1e6 gauge prior on pose 0, unit
  blocks on padded vertices, ``lambda I`` damping;
* Schur elimination of the landmarks, the reduced pose system solved by
  preconditioned CG in the kernels' chunked control (``chunk`` iterations
  per launch, the true residual after each, the direction restarted every
  ``restart_every // chunk`` chunks, masked iterations once the recurrence
  residual meets ``tol``);
* the preconditioner: the block-tridiagonal part of S (its diagonal blocks,
  and the odometry blocks of consecutive poses) solved exactly by cyclic
  reduction, plus with ``+coarse`` the additive Galerkin level
  ``R (R^T S R + 1e-4 diag)^-1 R^T`` over groups of consecutive poses,
  inverted exactly; rebuilt every ``pcg_precond_refresh`` GN iterations;
* back-substitution, the additive-xy / wrapped-angle retraction, the
  adaptive damping and the penalty stop of the GN loop.

Precision: float64 is the reference.  ``tf32=True`` with float32 is the
control: every matrix product rounds its operands to TF32 (10 mantissa
bits, round to nearest even), as the tensor cores do with
``allow_tf32``, and accumulates in float32.  The rounding is done here,
so the control reads the same on any device.

Imports: torch and numpy only.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class Precision(NamedTuple):
    dtype: torch.dtype = torch.float64
    tf32: bool = False


REFERENCE = Precision(torch.float64, False)
CONTROL = Precision(torch.float32, True)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32: keep 10 mantissa bits, to nearest
    even."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0xFFF + lsb) & -8192).view(torch.float32)


class Ops:
    """Block products at one precision."""

    def __init__(self, prec: Precision):
        self.prec = prec

    def mm(self, a, b):
        if self.prec.tf32:
            a, b = tf32_round(a), tf32_round(b)
        return torch.matmul(a, b)

    def mv(self, a, x):
        return self.mm(a, x[..., None])[..., 0]

    def mtv(self, a, x):
        return self.mv(a.transpose(-1, -2), x)


# --- SE(2) -----------------------------------------------------------------


def _wrap(t):
    return torch.atan2(torch.sin(t), torch.cos(t))


def _compose(a, b):
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    return torch.stack([a[..., 0] + ca * b[..., 0] - sa * b[..., 1],
                        a[..., 1] + sa * b[..., 0] + ca * b[..., 1],
                        _wrap(a[..., 2] + b[..., 2])], -1)


def _inverse(a):
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    return torch.stack([-(ca * a[..., 0] + sa * a[..., 1]),
                        -(-sa * a[..., 0] + ca * a[..., 1]), -a[..., 2]], -1)


def odom_residual(pi, pj, meas):
    return _compose(_inverse(meas), _compose(_inverse(pi), pj))


def odom_jacobians(pi, pj, meas):
    """Exact ``dr/dp_i``, ``dr/dp_j`` of :func:`odom_residual`: with
    ``q = R(th_i)^T (t_j - t_i)``, ``r_xy = R(th_m)^T (q - t_m)`` and
    ``r_th = th_j - th_i - th_m`` (wrapped)."""
    ci, si = torch.cos(pi[..., 2]), torch.sin(pi[..., 2])
    cm, sm = torch.cos(meas[..., 2]), torch.sin(meas[..., 2])
    dx, dy = pj[..., 0] - pi[..., 0], pj[..., 1] - pi[..., 1]
    qx, qy = ci * dx + si * dy, -si * dx + ci * dy
    # M = R(th_m)^T R(th_i)^T
    m00, m01 = cm * ci - sm * si, cm * si + sm * ci
    m10, m11 = -sm * ci - cm * si, -sm * si + cm * ci
    z, one = torch.zeros_like(ci), torch.ones_like(ci)
    # d q / d th_i = (q_y, -q_x); rotated by R(th_m)^T
    jth_x, jth_y = cm * qy - sm * qx, -sm * qy - cm * qx
    ja = torch.stack([torch.stack([-m00, -m01, jth_x], -1),
                      torch.stack([-m10, -m11, jth_y], -1),
                      torch.stack([z, z, -one], -1)], -2)
    jb = torch.stack([torch.stack([m00, m01, z], -1),
                      torch.stack([m10, m11, z], -1),
                      torch.stack([z, z, one], -1)], -2)
    return ja, jb


def landmark_residual(p, lm, meas):
    c, s = torch.cos(p[..., 2]), torch.sin(p[..., 2])
    dx, dy = lm[..., 0] - p[..., 0], lm[..., 1] - p[..., 1]
    pred = torch.stack([c * dx + s * dy, -s * dx + c * dy], -1)
    obs = torch.stack([meas[..., 0] * torch.cos(meas[..., 1]),
                       meas[..., 0] * torch.sin(meas[..., 1])], -1)
    return pred - obs


def landmark_jacobians(p, lm):
    """Exact ``dr/dp`` (2x3) and ``dr/dlm`` (2x2) of
    :func:`landmark_residual`."""
    c, s = torch.cos(p[..., 2]), torch.sin(p[..., 2])
    dx, dy = lm[..., 0] - p[..., 0], lm[..., 1] - p[..., 1]
    ja = torch.stack([torch.stack([-c, -s, -s * dx + c * dy], -1),
                      torch.stack([s, -c, -c * dx - s * dy], -1)], -2)
    jb = torch.stack([torch.stack([c, s], -1),
                      torch.stack([-s, c], -1)], -2)
    return ja, jb


def huber(chi2, delta):
    """``(robust error, weight)`` of the Huber kernel on ``chi2``."""
    root = torch.sqrt(torch.clamp(chi2, min=1e-30))
    inside = chi2 <= delta * delta
    return (torch.where(inside, chi2, 2.0 * root * delta - delta * delta),
            torch.where(inside, torch.ones_like(chi2), delta / root))


# --- the problem -------------------------------------------------------------


class Problem:
    """The generated arrays on ``device`` at ``prec``: every vertex
    (padding included, as the program solves it) and the real edges."""

    def __init__(self, arrays: dict, device, prec: Precision):
        dt = prec.dtype

        def f(a):
            return torch.as_tensor(np.asarray(a), device=device).to(dt)

        def i(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        oi, oj, om, oinf, omask = arrays["odom"]
        lp, ll, lmeas, linf, lmask = arrays["lm_edges"]
        ko, kl = np.asarray(omask) > 0, np.asarray(lmask) > 0
        self.ops = Ops(prec)
        self.poses0, self.landmarks0 = f(arrays["poses"]), f(arrays["landmarks"])
        self.pose_fixed, self.lm_fixed = (f(arrays["pose_fixed"]),
                                          f(arrays["lm_fixed"]))
        self.pose_mask, self.lm_mask = f(arrays["pose_mask"]), f(arrays["lm_mask"])
        self.oi, self.oj = i(np.asarray(oi)[ko]), i(np.asarray(oj)[ko])
        self.omeas, self.oinfo = f(np.asarray(om)[ko]), f(np.asarray(oinf)[ko])
        self.lp, self.ll = i(np.asarray(lp)[kl]), i(np.asarray(ll)[kl])
        self.lmeas, self.linfo = f(np.asarray(lmeas)[kl]), f(np.asarray(linf)[kl])
        self.n, self.m = self.poses0.shape[0], self.landmarks0.shape[0]
        self.dtype, self.device = dt, self.poses0.device


class System(NamedTuple):
    hpp: torch.Tensor    # [N, 3, 3] pose diagonal blocks
    off: torch.Tensor    # [E1, 3, 3] odometry block at (i, j)
    hll: torch.Tensor    # [M, 2, 2]
    hpl: torch.Tensor    # [E2, 3, 2]
    bp: torch.Tensor     # [N, 3]
    bl: torch.Tensor     # [M, 2]
    err: torch.Tensor    # robust chi^2


def _scatter(index, values, rows):
    out = values.new_zeros((rows,) + values.shape[1:])
    return out.index_add_(0, index, values)


def robust_chi2(pb: Problem, poses, landmarks, huber_delta) -> torch.Tensor:
    """The objective: robust chi^2 of the real edges at a state."""
    r = odom_residual(poses[pb.oi], poses[pb.oj], pb.omeas)
    e_o, _ = huber(torch.einsum("ea,eab,eb->e", r, pb.oinfo, r), huber_delta)
    r = landmark_residual(poses[pb.lp], landmarks[pb.ll], pb.lmeas)
    e_l, _ = huber(torch.einsum("ea,eab,eb->e", r, pb.linfo, r), huber_delta)
    return e_o.sum() + e_l.sum()


def linearize(pb: Problem, poses, landmarks, opt: dict) -> System:
    ops, delta = pb.ops, opt["huber_delta"]
    pi, pj = poses[pb.oi], poses[pb.oj]
    r = odom_residual(pi, pj, pb.omeas)
    if opt["exact_odom_jacobians"]:
        ja, jb = odom_jacobians(pi, pj, pb.omeas)
    else:
        eye = torch.eye(3, dtype=pb.dtype, device=pb.device)
        ja, jb = (-eye).expand(r.shape[0], 3, 3), eye.expand(r.shape[0], 3, 3)
    err_o, w = huber(torch.einsum("ea,eab,eb->e", r, pb.oinfo, r), delta)
    wi = w[:, None, None] * pb.oinfo
    jat, jbt = ja.transpose(-1, -2), jb.transpose(-1, -2)
    hpp = (_scatter(pb.oi, ops.mm(jat, ops.mm(wi, ja)), pb.n)
           + _scatter(pb.oj, ops.mm(jbt, ops.mm(wi, jb)), pb.n))
    off = ops.mm(jat, ops.mm(wi, jb))
    wr = ops.mv(wi, r)
    bp = _scatter(pb.oi, ops.mv(jat, wr), pb.n) + _scatter(pb.oj,
                                                          ops.mv(jbt, wr), pb.n)

    p, lm = poses[pb.lp], landmarks[pb.ll]
    r = landmark_residual(p, lm, pb.lmeas)
    ja, jb = landmark_jacobians(p, lm)
    err_l, w = huber(torch.einsum("ea,eab,eb->e", r, pb.linfo, r), delta)
    wi = w[:, None, None] * pb.linfo
    jat, jbt = ja.transpose(-1, -2), jb.transpose(-1, -2)
    wjb, wr = ops.mm(wi, jb), ops.mv(wi, r)
    hpp = hpp + _scatter(pb.lp, ops.mm(jat, ops.mm(wi, ja)), pb.n)
    hll = _scatter(pb.ll, ops.mm(jbt, wjb), pb.m)
    hpl = ops.mm(jat, wjb)
    bp = bp + _scatter(pb.lp, ops.mv(jat, wr), pb.n)
    bl = _scatter(pb.ll, ops.mv(jbt, wr), pb.m)

    prior = opt["fixed_prior"]
    eye3 = torch.eye(3, dtype=pb.dtype, device=pb.device)
    eye2 = torch.eye(2, dtype=pb.dtype, device=pb.device)
    hpp = hpp + (prior * pb.pose_fixed + 1.0 - pb.pose_mask)[:, None,
                                                             None] * eye3
    hll = hll + (prior * pb.lm_fixed + 1.0 - pb.lm_mask)[:, None, None] * eye2
    return System(hpp, off, hll, hpl, bp * (1.0 - pb.pose_fixed)[:, None],
                  bl * (1.0 - pb.lm_fixed)[:, None], err_o.sum() + err_l.sum())


def damp(sys: System, lam) -> System:
    eye3 = torch.eye(3, dtype=sys.hpp.dtype, device=sys.hpp.device)
    eye2 = torch.eye(2, dtype=sys.hpp.dtype, device=sys.hpp.device)
    return sys._replace(hpp=sys.hpp + lam * eye3, hll=sys.hll + lam * eye2)


# --- the reduced system ------------------------------------------------------


class Reduced:
    """``S = Hpp - Hpl Hll^-1 Hlp`` of a damped system, matrix-free."""

    def __init__(self, pb: Problem, d: System):
        self.pb, self.d = pb, d
        self.hll_inv = torch.linalg.inv(d.hll)

    def rhs(self):
        pb, ops = self.pb, self.pb.ops
        y = ops.mv(self.hll_inv, self.d.bl)
        return -self.d.bp + _scatter(pb.lp, ops.mv(self.d.hpl, y[pb.ll]), pb.n)

    def hlp(self, x):
        pb, ops = self.pb, self.pb.ops
        return _scatter(pb.ll, ops.mtv(self.d.hpl, x[pb.lp]), pb.m)

    def matvec(self, x):
        pb, ops, d = self.pb, self.pb.ops, self.d
        y = ops.mv(d.hpp, x)
        y = y + _scatter(pb.oi, ops.mv(d.off, x[pb.oj]), pb.n)
        y = y + _scatter(pb.oj, ops.mtv(d.off, x[pb.oi]), pb.n)
        v = ops.mv(self.hll_inv, self.hlp(x))
        return y - _scatter(pb.lp, ops.mv(d.hpl, v[pb.ll]), pb.n)

    def back_substitute(self, dx_p):
        return self.pb.ops.mv(self.hll_inv, -self.d.bl - self.hlp(dx_p))


class Preconditioner:
    """``z = T^-1 r (+ R Sc^-1 R^T r)``: T the block-tridiagonal part of S
    (S's diagonal blocks, the odometry blocks of consecutive poses), solved
    by cyclic reduction; Sc the Galerkin coarse operator, jittered by 1e-4
    of its diagonal and inverted."""

    def __init__(self, red: Reduced, kind: str, group: int):
        pb, ops, d = red.pb, red.pb.ops, red.d
        local, _, coarse = kind.partition("+")
        if local != "tridiag":
            raise ValueError(f"the reference builds 'tridiag' preconditioners,"
                             f" not {kind!r}")
        self.ops, self.n = ops, pb.n
        hpl_t = d.hpl.transpose(-1, -2)
        fill = ops.mm(ops.mm(d.hpl, red.hll_inv[pb.ll]), hpl_t)
        diag = d.hpp - _scatter(pb.lp, fill, pb.n)
        chain = (pb.oj == pb.oi + 1).to(pb.dtype)
        upper = _scatter(pb.oi, d.off * chain[:, None, None], pb.n)
        self._factor(diag, upper)
        self.group = group if coarse == "coarse" else 0
        if self.group:
            self._coarse(red)

    def _factor(self, b, c):
        """Cyclic-reduction factors of ``tridiag(a, b, c)`` with
        ``a[v] = c[v-1]^T``: per level the multipliers of the neighbours at
        stride s, then the inverse of the reduced diagonal."""
        mm = self.ops.mm
        a = _down(c, 1).transpose(-1, -2)
        self.levels = []
        s = 1
        while s < self.n:
            binv = torch.linalg.inv(b)
            alpha = -mm(a, _down(binv, s))
            gamma = -mm(c, _up(binv, s))
            b = b + mm(alpha, _down(c, s)) + mm(gamma, _up(a, s))
            a, c = mm(alpha, _down(a, s)), mm(gamma, _up(c, s))
            self.levels.append((alpha, gamma, s))
            s *= 2
        self.binv = torch.linalg.inv(b)

    def _coarse(self, red: Reduced):
        pb, ops, d, g = red.pb, red.pb.ops, red.d, self.group
        nc = -(-pb.n // g)
        gid = torch.arange(pb.n, device=pb.device) // g
        gi, gj = pb.oi // g, pb.oj // g
        hc = _scatter(gid * nc + gid, d.hpp, nc * nc)
        hc = hc + _scatter(gi * nc + gj, d.off, nc * nc)
        hc = hc + _scatter(gj * nc + gi, d.off.transpose(-1, -2), nc * nc)
        u = _scatter((pb.lp // g) * pb.m + pb.ll, d.hpl, nc * pb.m)
        u = u.reshape(nc, pb.m, 3, 2)
        w = ops.mm(u, red.hll_inv[None])                  # U Hll^-1
        fill = ops.mm(w.permute(0, 2, 1, 3).reshape(nc * 3, pb.m * 2),
                      u.permute(0, 2, 1, 3).reshape(nc * 3, pb.m * 2).T)
        sc = hc.reshape(nc, nc, 3, 3).permute(0, 2, 1, 3).reshape(
            nc * 3, nc * 3) - fill
        sc = 0.5 * (sc + sc.T)
        sc = sc + torch.diag(1e-4 * torch.diagonal(sc))
        self.nc = nc
        self.sc_inv = torch.cholesky_inverse(torch.linalg.cholesky(sc))

    def __call__(self, r):
        mv = self.ops.mv
        t = r
        for alpha, gamma, s in self.levels:
            t = t + mv(alpha, _down(t, s)) + mv(gamma, _up(t, s))
        z = mv(self.binv, t)
        if self.group:
            g, nc = self.group, self.nc
            rp = torch.cat([r, r.new_zeros((nc * g - self.n, 3))])
            rc = rp.reshape(nc, g, 3).sum(1).reshape(-1)
            zc = self.ops.mv(self.sc_inv, rc).reshape(nc, 1, 3)
            z = z + zc.expand(nc, g, 3).reshape(nc * g, 3)[: self.n]
        return z


def _down(x, s):
    """``y[v] = x[v - s]``, zero filled."""
    if s >= x.shape[0]:
        return torch.zeros_like(x)
    return torch.cat([torch.zeros_like(x[:s]), x[:-s]])


def _up(x, s):
    """``y[v] = x[v + s]``, zero filled."""
    if s >= x.shape[0]:
        return torch.zeros_like(x)
    return torch.cat([x[s:], torch.zeros_like(x[:s])])


def pcg(red: Reduced, precond, rhs, opt: dict):
    """CG on ``S x = rhs`` in the kernels' chunked control; returns ``(x,
    iterations)``."""
    chunk = opt["pcg_fused_chunk"]
    max_iters, tol = opt["pcg_max_iters"], opt["pcg_tol"]
    restart_chunks = max(1, opt["pcg_restart_every"] // chunk)
    atol2 = tol * tol * (rhs * rhs).sum()
    x = torch.zeros_like(rhs)
    r = p = rt = rhs
    rz = torch.zeros((), dtype=rhs.dtype, device=rhs.device)
    rr_true = (rhs * rhs).sum()
    it, stop = 0, False
    for k in range(-(-max_iters // chunk)):
        if not (bool(rr_true > atol2) and not stop):
            break
        if k % restart_chunks == 0:
            r = rt
            z = precond(r)
            p, rz = z, (r * z).sum()
        rr = (r * r).sum()
        for _ in range(chunk):
            ap = red.matvec(p)
            pap = (p * ap).sum()
            stop = stop or not bool(pap > 0.0) or not bool(torch.isfinite(pap))
            if stop or bool(rr <= atol2) or it >= max_iters:
                continue
            alpha = rz / pap
            x = x + alpha * p
            r = r - alpha * ap
            z = precond(r)
            rz_new, rr = (r * z).sum(), (r * r).sum()
            p = z + (rz_new / rz) * p
            rz = rz_new
            it += 1
        rt = rhs - red.matvec(x)
        rr_true = (rt * rt).sum()
    return x, it


# --- Gauss-Newton ------------------------------------------------------------


class Result(NamedTuple):
    poses: torch.Tensor         # [N, 3], padding included
    landmarks: torch.Tensor     # [M, 2]
    errors: list                # robust chi^2 at each linearization
    pcg_iters: list
    iterations_run: int


def optimize(arrays: dict, opt: dict, device="cpu",
             prec: Precision = REFERENCE) -> Result:
    """The configuration's solve of the generated graph ``arrays``."""
    if opt["solver"] not in ("schur", "schur_grid") or opt.get(
            "reject_worse_steps"):
        raise ValueError("the reference solves 'schur' and 'schur_grid' "
                         "without step rejection")
    pb = Problem(arrays, device, prec)
    poses, landmarks = pb.poses0, pb.landmarks0
    lam = opt["lambda_init"]
    refresh = opt["pcg_precond_refresh"]
    group = opt["pcg_coarse_group"]

    def build(poses, landmarks, lam):
        d = damp(linearize(pb, poses, landmarks, opt), lam)
        return Preconditioner(Reduced(pb, d), opt["pcg_precond"], group)

    pre = build(poses, landmarks, lam) if refresh != 1 else None
    prev_err, penalty = -1.0, 0
    errors, iters = [], []
    it = 0
    while it < opt["iterations"]:
        if refresh > 1 and it % refresh == 0 and it > 0:
            pre = build(poses, landmarks, lam)
        sys = linearize(pb, poses, landmarks, opt)
        red = Reduced(pb, damp(sys, lam))
        precond = pre if refresh != 1 else Preconditioner(
            red, opt["pcg_precond"], group)
        dx_p, n_it = pcg(red, precond, red.rhs(), opt)
        dx_l = red.back_substitute(dx_p)
        err = float(sys.err)
        errors.append(err)
        iters.append(n_it)
        step_p, step_l = dx_p * opt["lr"], dx_l * opt["lr"]
        dx_norm = math.sqrt(float((step_p**2).sum() + (step_l**2).sum()))
        increased = prev_err >= 0.0 and err > prev_err
        lam = (min(lam * opt["lambda_factor"], opt["lambda_max"]) if increased
               else max(lam / opt["lambda_factor"], opt["lambda_min"]))
        penalty = penalty + 1 if increased else 0
        diverged = penalty > opt["penalty_limit"]
        prev_err = err
        it += 1
        if diverged:
            break
        poses = torch.stack([poses[:, 0] + step_p[:, 0],
                             poses[:, 1] + step_p[:, 1],
                             _wrap(poses[:, 2] + step_p[:, 2])], -1)
        landmarks = landmarks + step_l
        if dx_norm < opt["convergence_eps"]:
            break
    return Result(poses, landmarks, errors, iters, it)
