"""The comparison that decides ``correct``: the program's answers against
the plain reference's solve of the same generated graph.  ``worst_over_pool``
takes any family's reference and numbers (``families/<name>.py``);
``gaps`` is the SE(2) family's (``families/se2.py``).

Numbers, each over every answer the window produced (the worst one):

* ``state_gap``: the widest gap of a real pose's or landmark's position
  (metres) from the reference's, over the root mean square of how far the
  reference moved the real positions from where the graph started them;
* ``theta_gap``: the widest gap of a real pose's heading (radians,
  wrapped);
* ``chi2_gap``: the gap of the objective (the robust chi^2 of the real
  edges, computed by the reference in float64) at the answer from its
  value at the reference's answer, over the latter;
* ``chi2_final_excess``: how far the objective at the answer lies above
  its value at the reference's answer, over the latter (one-sided: an
  answer better than the reference's reads below 0);

and where the answer carries the program's chi^2 at each GN iteration
(``OptimizeResult.errors``, NaN after the last; the in-process cells):

* ``chi2_step1_gap``: the relative gap of its value after the first GN
  step from the reference's: the objective at the state that one
  linearization, Schur elimination, PCG solve, back-substitution and
  retraction reached from the graph's own start, before truncated solves
  let float32 rounding steer the later steps;
* ``chi2_path_excess``: the most by which the program's chi^2 at any GN
  iteration lies above the reference's at the same iteration, over the
  latter (one-sided);
* ``iterations_short``: the GN iterations the reference ran less those
  the program ran (its finite chi^2 values), one-sided: a solve that
  stops early reads above 0.

``steps`` gives every step's relative gap of the worst answer, for the
calibration.

A configuration's ``correct`` section names the numbers it compares and
their limits; an answer that is not finite fails every number.
"""

from __future__ import annotations

import math

import torch

from slambench import reference

ONE_SIDED = ("chi2_final_excess", "chi2_path_excess", "iterations_short")
NUMBERS = ("state_gap", "theta_gap", "chi2_gap", "chi2_final_excess",
           "chi2_step1_gap", "chi2_path_excess", "iterations_short")


def _finite_prefix(errors: list) -> list:
    out = []
    for e in errors:
        if not math.isfinite(e):
            break
        out.append(e)
    return out


def _trajectory(errors: list, ref_errors: list) -> dict:
    """The numbers of one answer's chi^2 trajectory against the
    reference's."""
    mine = _finite_prefix(errors)
    if len(mine) < min(2, len(ref_errors)):
        return {"chi2_step1_gap": math.inf, "chi2_path_excess": math.inf,
                "iterations_short": float(len(ref_errors) - len(mine)),
                "steps": []}
    rel = [(e - r) / r for e, r in zip(mine, ref_errors)]
    return {"chi2_step1_gap": abs(rel[1]) if len(rel) > 1 else 0.0,
            "chi2_path_excess": max(rel[1:], default=0.0),
            "iterations_short": float(len(ref_errors) - len(mine)),
            "steps": [abs(x) for x in rel]}


def gaps(arrays: dict, n_poses: int, n_landmarks: int, opt: dict,
         ref: reference.Result, answers, device) -> dict:
    """The numbers over every answer ``(poses, landmarks, errors)`` (host
    tensors of the padded graph; ``errors`` the program's chi^2 per GN
    iteration, or None), each the worst: ``{name: value}``, with
    ``steps`` the per-step gaps of the answer whose first step is worst,
    where errors came."""
    pb = reference.Problem(arrays, device, reference.REFERENCE)
    n, m = n_poses, n_landmarks
    rp = ref.poses[:n].to(device, torch.float64)
    rl = ref.landmarks[:m].to(device, torch.float64)
    moved = torch.cat([(rp - pb.poses0[:n])[:, :2], rl - pb.landmarks0[:m]])
    scale = float(moved.norm(dim=1).pow(2).mean().sqrt())
    chi2_ref = float(reference.robust_chi2(pb, ref.poses.to(device),
                                           ref.landmarks.to(device),
                                           opt["huber_delta"]))
    worst = {"state_gap": 0.0, "theta_gap": 0.0, "chi2_gap": 0.0,
             "chi2_final_excess": -math.inf}
    steps = None
    seen = set()
    for poses, landmarks, errors in answers:
        key = (poses.numpy().tobytes(), landmarks.numpy().tobytes(),
               None if errors is None else errors.numpy().tobytes())
        if key in seen:
            continue
        seen.add(key)
        if errors is not None:
            path = _trajectory(errors.tolist(), ref.errors)
            if path["chi2_step1_gap"] >= worst.get("chi2_step1_gap", 0.0):
                steps = path["steps"]
            for k in ("chi2_step1_gap", "chi2_path_excess",
                      "iterations_short"):
                worst[k] = max(worst.get(k, -math.inf), path[k])
        p = poses.to(device, torch.float64)
        l_ = landmarks.to(device, torch.float64)
        if not (bool(torch.isfinite(p).all()) and
                bool(torch.isfinite(l_).all())):
            return {k: math.inf for k in NUMBERS}
        d_xy = torch.cat([(p[:n, :2] - rp[:, :2]).norm(dim=1),
                          (l_[:m] - rl).norm(dim=1)])
        d_th = torch.atan2(torch.sin(p[:n, 2] - rp[:, 2]),
                           torch.cos(p[:n, 2] - rp[:, 2])).abs()
        pp = torch.cat([p[:n], pb.poses0[n:]])
        ll = torch.cat([l_[:m], pb.landmarks0[m:]])
        chi2 = float(reference.robust_chi2(pb, pp, ll, opt["huber_delta"]))
        now = {"state_gap": float(d_xy.max()) / scale,
               "theta_gap": float(d_th.max()),
               "chi2_gap": abs(chi2 - chi2_ref) / chi2_ref,
               "chi2_final_excess": (chi2 - chi2_ref) / chi2_ref}
        worst.update({k: max(worst[k], now[k]) for k in now})
    if steps is not None:
        worst["steps"] = steps
    return worst


def worst_over_pool(family, problems: list, opt: dict, answers,
                    device) -> dict:
    """The numbers over a run's answers ``(graph index, poses, landmarks,
    errors)``: each pool graph's answers against the family's reference
    solve of that graph (``families/<name>.py``), the worst of each number
    over the graphs."""
    worst: dict = {}
    for i, problem in enumerate(problems):
        mine = [a[1:] for a in answers if a[0] == i]
        if not mine:
            continue
        g = problem["graph"]
        ref = family.optimize(g, opt, device, family.REFERENCE)
        got = family.gaps(g, problem["n_poses"], problem["n_landmarks"], opt,
                          ref, mine, device)
        got.pop("steps", None)
        worst = {k: max(worst.get(k, -math.inf), v) for k, v in got.items()}
    return worst


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})`` over the configuration's
    limits."""
    compared = {k: {"value": numbers.get(k, math.inf), "limit": v}
                for k, v in limits.items()}
    ok = all(c["value"] <= c["limit"] for c in compared.values())
    return ok, compared
