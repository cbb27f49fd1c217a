"""The SE(3) bundle-adjustment family: camera poses (row-major R, then t)
and 3D points, pinhole reprojection and relative-pose edges, the port's
``FactorGraph3D`` solved by ``solver="schur3d"``; judged by the plain
float64 reference of ``reference_se3.py``.  What a family provides is
listed in ``families/se2.py``.

Bundle adjustment in float32 is chaotic from its first step: a PCG solve
to 1e-6 of a system whose gauge prior is 1e6 ends where float32 rounding
leaves it (its first step lies 0.6-240 % from the converged float64 step),
so the path lags or leads the float64 reference's by orders of magnitude,
and the end lands within a few percent of the reference's on another
point of a flat valley (PERF.md §6).  So the precision is held where
rounding leaves a trace that the path does not move, and the solve at its
end (``check.py`` defines the path's numbers):

* ``chi2_start_gap``: the program's chi^2 at GN iteration 0, the graph's
  own start, against the reference's: the residuals, Huber weights and
  sums of the program's assembly, before any solve;
* ``rotation_drift``: the largest entry of ``R^T R - I`` over the
  answer's real cameras: how far its retractions' products have carried
  the rotations off SO(3);
* ``chi2_final_excess``: the robust chi^2 (computed by the reference in
  float64) at the answer above that at the reference's answer;
* ``iterations_short``: the GN iterations the reference ran less the
  program's;
* ``camera_decrement``: the most the robust chi^2 at the answer falls by
  a Gauss-Newton step of one camera alone (``decrement``), over the
  reference's chi^2 at its answer: a camera the solve left off its
  optimum, which the end's chi^2 alone does not show.

Reported beside them, for the calibration, and compared by no
configuration (float32 alone moves them as far as the faults do):
``chi2_step1_gap``, the program's chi^2 after GN step 1 against the
reference's; ``chi2_path_excess``, the most the program's chi^2 lies
above the reference's at any GN iteration; ``state_gap``, the widest gap
of a real camera centre or point from the reference's over the root mean
square of how far the reference moved them; ``rotation_gap``, the widest
angle (rad) between a real camera's rotation and the reference's.
"""

from __future__ import annotations

import math

import torch

from slambench import check, reference_se3

REFERENCE = reference_se3.REFERENCE
CONTROL = reference_se3.CONTROL
FLOAT32 = reference_se3.Precision(torch.float32, False)
NUMBERS = ("chi2_start_gap", "rotation_drift", "chi2_final_excess",
           "iterations_short", "camera_decrement", "chi2_step1_gap",
           "chi2_path_excess", "state_gap", "rotation_gap")


class Unsupported(RuntimeError):
    """The program cannot solve the configuration as it is stated."""


def near_plane_honoured(near: float) -> bool:
    """Whether the program's reprojection clamps a point's depth at a near
    plane given as a fifth intrinsic, with no depth column below it: a
    point at half the plane's depth in front of the identity camera
    (fx = fy = 1, cx = cy = 0) lands at ``1 / near``, not ``2 / near``."""
    from toyslam_torch.ops import residuals3d

    pose = torch.tensor([[1.0, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0]])
    point = torch.tensor([[1.0, 0.0, near / 2]])
    k = torch.tensor([1.0, 1.0, 0.0, 0.0, near])
    idx = torch.zeros(1, dtype=torch.long)
    e = residuals3d.eval_reproj_edges(
        pose, point, k, idx, idx, torch.zeros(1, 2), torch.eye(2)[None],
        torch.ones(1), 4.0)
    return (math.isclose(float(e.r[0, 0]), 1.0 / near, rel_tol=1e-5)
            and float(e.JB[0, 0, 2]) == 0.0)


def program_graph(arrays: dict):
    """The program's graph of the generated arrays.  A graph with a near
    plane (a fifth intrinsic) is refused by a program that would project
    its points as if there were none: its answers would be to another
    problem than the reference's."""
    from toyslam_torch.models.graph3d import graph3d_from_numpy

    k = arrays["intrinsics"]
    if len(k) > 4 and not near_plane_honoured(float(k[4])):
        raise Unsupported(
            f"the program's reprojection ignores the near plane at depth "
            f"{float(k[4])} that this configuration's intrinsics give")
    return graph3d_from_numpy(**arrays)


def optimize(arrays: dict, opt: dict, device, precision):
    return reference_se3.optimize(arrays, opt, device, precision)


def decrement(pb, poses, landmarks, opt: dict, n: int) -> float:
    """The most the robust chi^2 at a state falls by a Gauss-Newton step of
    one real camera alone, the rest held: ``max_i b_i^T H_ii^-1 b_i`` of
    the float64 normal equations (``H_ii`` the camera's own block)."""
    s = reference_se3.linearize(pb, poses, landmarks, opt)
    b = s.bp[:n, :, None]
    return float((b.transpose(-1, -2) @ torch.linalg.solve(s.hpp[:n], b))
                 .max())


def gaps(arrays: dict, n_poses: int, n_landmarks: int, opt: dict,
         ref, answers, device) -> dict:
    """The numbers over every answer ``(poses, landmarks, errors)``, each
    the worst, with ``steps`` the per-step gaps of the answer whose first
    step is worst (as ``check.gaps``)."""
    rs = reference_se3
    pb = rs.Problem(arrays, device, REFERENCE)
    n, m, delta = n_poses, n_landmarks, opt["huber_delta"]
    rp = ref.poses.to(device, torch.float64)
    rl = ref.landmarks.to(device, torch.float64)
    moved = torch.cat([rs.trans(rp[:n]) - rs.trans(pb.poses0[:n]),
                       rl[:m] - pb.landmarks0[:m]])
    # at least a picometre: a reference that never moves reads no scale
    scale = max(float(moved.norm(dim=1).pow(2).mean().sqrt()), 1e-12)
    chi2_ref = float(rs.robust_chi2(pb, rp, rl, delta))
    worst = {"state_gap": 0.0, "rotation_gap": 0.0, "rotation_drift": 0.0,
             "chi2_final_excess": -math.inf, "camera_decrement": 0.0}
    steps = None
    seen = set()
    for poses, landmarks, errors in answers:
        key = (poses.numpy().tobytes(), landmarks.numpy().tobytes(),
               None if errors is None else errors.numpy().tobytes())
        if key in seen:
            continue
        seen.add(key)
        if errors is not None:
            path = check._trajectory(errors.tolist(), ref.errors)
            path["chi2_start_gap"] = (path["steps"][0] if path["steps"]
                                      else math.inf)
            if path["chi2_step1_gap"] >= worst.get("chi2_step1_gap", 0.0):
                steps = path["steps"]
            for k in ("chi2_start_gap", "chi2_step1_gap", "chi2_path_excess",
                      "iterations_short"):
                worst[k] = max(worst.get(k, -math.inf), path[k])
        p = poses.to(device, torch.float64)
        l_ = landmarks.to(device, torch.float64)
        if not (bool(torch.isfinite(p).all()) and
                bool(torch.isfinite(l_).all())):
            return {k: math.inf for k in NUMBERS}
        d_pos = torch.cat([(rs.trans(p[:n]) - rs.trans(rp[:n])).norm(dim=1),
                           (l_[:m] - rl[:m]).norm(dim=1)])
        r = rs.rot(p[:n])
        d_rot = rs.log_so3(rs.rot(rp[:n]).transpose(-1, -2) @ r).norm(dim=1)
        drift = r.transpose(-1, -2) @ r - torch.eye(3, dtype=r.dtype,
                                                    device=r.device)
        pp = torch.cat([p[:n], pb.poses0[n:]])
        ll = torch.cat([l_[:m], pb.landmarks0[m:]])
        chi2 = float(rs.robust_chi2(pb, pp, ll, delta))
        now = {"state_gap": float(d_pos.max()) / scale,
               "rotation_gap": float(d_rot.max()),
               "rotation_drift": float(drift.abs().max()),
               "chi2_final_excess": (chi2 - chi2_ref) / chi2_ref,
               "camera_decrement": decrement(pb, pp, ll, opt, n) / chi2_ref}
        worst.update({k: max(worst[k], now[k]) for k in now})
    if steps is not None:
        worst["steps"] = steps
    return worst
