"""The benchmark's SE(3) bundle-adjustment configuration on the CPU, at 16
cameras x 64 points: its frozen generator, its plain reference
(``slambench/reference_se3.py``) and its comparison
(``slambench/families/se3.py``) against the port.

* ``graphs/camera_ring.py`` gives ``make_ba_problem``'s graph array for
  array;
* the reference's normal equations equal ``assemble_blocks_3d``'s, both in
  float64;
* one damped step's ``dx``, both PCG solves converged, equals the
  reference's;
* a full ``optimize`` of the configuration passes ``families/se3.gaps``
  under the configuration's own limits;
* at a point inside the configuration's near plane or behind a camera
  the normal equations are the reference's, and a float32 damped step
  descends;
* a GN loop stopped after 2 iterations, one answer camera turned away or
  moved by 0.5, and the solve in a precision below the configuration's
  (the reference's TF32 control) each fail them;
* the reference's PCG alone at another precision.
"""

import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from slambench import check, reference_se3
from slambench.families import se3
from slambench.graphs import camera_ring
from toyslam_torch.config import OptimizerConfig
from toyslam_torch.ops.schur3d import (assemble_blocks_3d,
                                       schur3d_linearize_solve)
from toyslam_torch.optimizer import GaussNewton
from toyslam_torch.sim import synthetic3d

ROOT = Path(__file__).resolve().parent.parent
CONFIG = json.loads(
    (ROOT / "slambench/configs/ba3d-512x4096.json").read_text())
OPT = CONFIG["optimizer"]
NEAR = CONFIG["graph"]["near_plane"]
SEEDS = (0, 1, 2)
SIZE = dict(num_poses=16, num_landmarks=64, obs_per_pose=24)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def _problem(seed):
    """The configuration's graph (with its near plane) at the test size."""
    return camera_ring.generate(seed, near_plane=NEAR, **SIZE)


def _largest_rel(a, b):
    a, b = torch.as_tensor(a, dtype=torch.float64), torch.as_tensor(
        b, dtype=torch.float64)
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("seed", SEEDS)
def test_camera_ring_is_make_ba_problem(seed):
    problem = camera_ring.generate(seed, **SIZE)
    arrays = problem["graph"]
    graph, poses_gt, lms_gt = synthetic3d.make_ba_problem(seed=seed, **SIZE)
    for name in ("poses", "landmarks", "pose_mask", "lm_mask", "pose_fixed",
                 "lm_fixed", "intrinsics"):
        assert np.array_equal(arrays[name], getattr(graph, name).numpy()), name
    for name, edges in (("odom", graph.odom), ("lm_edges", graph.lm_edges)):
        fields = [f.name for f in dataclasses.fields(edges)]
        for field, array in zip(fields, arrays[name], strict=True):
            assert np.array_equal(array, getattr(edges, field).numpy()), (
                name, field)
    assert np.array_equal(problem["poses_gt"], poses_gt)
    assert np.array_equal(problem["landmarks_gt"], lms_gt)
    # the near plane is a fifth intrinsic, and nothing else
    near = _problem(seed)["graph"]
    assert np.array_equal(near["intrinsics"], np.append(
        arrays["intrinsics"], np.float32(NEAR)))
    assert np.array_equal(near["landmarks"], arrays["landmarks"])


# Both in float64 from the same float32 arrays.  The reference's
# relative-pose Jacobians are the closed form on SO(3); the program
# differentiates its residual, whose rotations the arrays hold rounded to
# float32 (orthonormal to ~1e-7), so the two differ by that much of an
# odometry block: measured at most 9.9e-8 of the largest entry of the
# off-diagonal odometry blocks, 5.3e-10 of the pose diagonal's (the
# odometry's share in it is smaller), 1.2e-14 elsewhere.
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("part", ["hpp", "hll", "hpl", "off", "bp", "bl",
                                  "err"])
def test_the_normal_equations_are_the_programs(seed, part):
    arrays = _problem(seed)["graph"]
    graph = GaussNewton(OptimizerConfig(**OPT))._prepare(
        se3.program_graph(arrays)).astype(torch.float64)
    prog = assemble_blocks_3d(graph, OPT["huber_delta"], OPT["fixed_prior"],
                              OPT["exact_odom_jacobians"])
    pb = reference_se3.Problem(arrays, CPU, reference_se3.REFERENCE)
    ref = reference_se3.linearize(pb, pb.poses0, pb.landmarks0, OPT)
    real = graph.odom.mask > 0
    mine = {"hpp": prog.hpp_diag, "hll": prog.hll, "hpl": prog.hpl[
        graph.lm_edges.mask > 0], "off": prog.hpp_off[real], "bp": prog.bp,
        "bl": prog.bl, "err": prog.err}[part]
    assert _largest_rel(mine, getattr(ref, part)) < (
        1e-6 if part == "off" else 1e-8)


def _planted(seed, depth):
    """The configuration's graph (its near plane 0.5) with one observed
    point moved along its camera's ray to ``depth`` in that camera's frame:
    its projection there is unchanged, its other observations are not."""
    arrays = dict(_problem(seed)["graph"])
    lp, ll = arrays["lm_edges"][0], arrays["lm_edges"][1]
    k, j = int(lp[5]), int(ll[5])
    pose = arrays["poses"][k].astype(np.float64)
    r, t = pose[:9].reshape(3, 3), pose[9:]
    x_c = r.T @ (arrays["landmarks"][j].astype(np.float64) - t)
    landmarks = arrays["landmarks"].copy()
    landmarks[j] = t + r @ (x_c * depth / x_c[2])
    arrays["landmarks"] = landmarks
    return arrays


# behind the camera, just in front of its plane, inside the near plane
DEPTHS = (-0.02, 0.011, 0.3)


# At a point inside the near plane (or behind the camera) the program
# clamps the depth and drops the projection's depth column as the
# reference does: the normal equations agree as at the start (same
# tolerances, same reasons).
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("part", ["hpp", "hll", "hpl", "bp", "bl", "err"])
def test_the_near_plane_is_the_programs(depth, part):
    arrays = _planted(0, depth)
    graph = GaussNewton(OptimizerConfig(**OPT))._prepare(
        se3.program_graph(arrays)).astype(torch.float64)
    prog = assemble_blocks_3d(graph, OPT["huber_delta"], OPT["fixed_prior"],
                              OPT["exact_odom_jacobians"])
    pb = reference_se3.Problem(arrays, CPU, reference_se3.REFERENCE)
    ref = reference_se3.linearize(pb, pb.poses0, pb.landmarks0, OPT)
    mine = {"hpp": prog.hpp_diag, "hll": prog.hll, "hpl": prog.hpl[
        graph.lm_edges.mask > 0], "bp": prog.bp, "bl": prog.bl,
        "err": prog.err}[part]
    assert _largest_rel(mine, getattr(ref, part)) < 1e-8


# The float32 program's damped step from such a state, at the largest
# damping the configuration allows, lowers the float64 chi^2 as the
# float64 reference's step does.  Without a near plane (the depth clamped
# at 1e-6) a point behind the camera gives entries of ~1e21 whose 3x3
# inverse overflows in float32, and every step is NaN.
@pytest.mark.parametrize("depth", DEPTHS)
def test_a_float32_step_past_the_near_plane_descends(depth):
    arrays = _planted(0, depth)
    gn = GaussNewton(OptimizerConfig(**OPT))
    graph = gn._prepare(se3.program_graph(arrays))
    stepped, _ = gn.step(graph, OPT["lambda_max"])
    pb = reference_se3.Problem(arrays, CPU, reference_se3.REFERENCE)
    before = float(reference_se3.robust_chi2(
        pb, pb.poses0, pb.landmarks0, OPT["huber_delta"]))
    after = float(reference_se3.robust_chi2(
        pb, stepped.poses.double(), stepped.landmarks.double(),
        OPT["huber_delta"]))
    assert after < before


# One step at lambda 1e-3 from the graph's start, PCG to 1e-12 in both
# (converged: both solve the same linear system); measured at most 7.4e-9
# of the largest entry, the float32 rotations' part above amplified by the
# system's conditioning (the gauge prior is 1e6).
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("part", ["poses", "points"])
def test_one_step_is_the_programs(seed, part):
    opt = dict(OPT, pcg_tol=1e-12, pcg_max_iters=2000,
               pcg_restart_every=2048)
    arrays = _problem(seed)["graph"]
    graph = GaussNewton(OptimizerConfig(**opt))._prepare(
        se3.program_graph(arrays)).astype(torch.float64)
    solve = schur3d_linearize_solve(OptimizerConfig(**opt))
    dx_p, dx_l, _, _ = solve(graph, torch.tensor(1e-3, dtype=torch.float64))
    pb = reference_se3.Problem(arrays, CPU, reference_se3.REFERENCE)
    rp, rl, _, _ = reference_se3.solve_step(pb, pb.poses0, pb.landmarks0,
                                            1e-3, opt)
    mine, ref = (dx_p, rp) if part == "poses" else (dx_l, rl)
    assert _largest_rel(mine, ref) < 1e-7


# R diag(1, -1, -1): the entries of R's second and third columns, row-major
TURN = [1, 2, 4, 5, 7, 8]


def _answer(seed, opt=OPT, move=None):
    arrays = _problem(seed)["graph"]
    gn = GaussNewton(OptimizerConfig(**opt))
    res = gn.optimize(gn._prepare(se3.program_graph(arrays)))
    poses = res.graph.poses.clone()
    k = SIZE["num_poses"] // 2
    if move == "turned":    # turned half a turn about its own x axis
        poses[k, TURN] *= -1.0
    elif move == "moved":   # moved by 0.5 along x, as on the card
        poses[k, 9] += 0.5
    return poses, res.graph.landmarks, res.errors


def _compared(seed, answer):
    problem = _problem(seed)
    ref = se3.optimize(problem["graph"], OPT, CPU, se3.REFERENCE)
    numbers = se3.gaps(problem["graph"], problem["n_poses"],
                       problem["n_landmarks"], OPT, ref, [answer], CPU)
    return check.judge(numbers, CONFIG["correct"])


@pytest.mark.parametrize("seed", SEEDS)
def test_the_program_passes_the_configurations_limits(seed):
    correct, compared = _compared(seed, _answer(seed))
    assert correct, compared
    assert all(math.isfinite(c["value"]) for c in compared.values())


def _control(seed):
    """The reference in float32 with TF32-rounded products (the control),
    put in the program's place."""
    ctl = se3.optimize(_problem(seed)["graph"], OPT, CPU, se3.CONTROL)
    return ctl.poses.float(), ctl.landmarks.float(), torch.tensor(ctl.errors)


# The planted faults: the GN loop stopped after 2 of its 20 iterations;
# one camera of the answer turned to face away from the points, or moved
# by 0.5 (caught by ``camera_decrement``: 1.4-1.9 here, 0.05-0.12 on the
# card's 512 cameras, where the program reads at most 3.5e-5); the solve
# computed in a precision below the configuration's (the control).  A PCG
# capped at half the configuration's 200 iterations is no fault here: a
# solve takes 24-86, and on the card the float32 PCG meets 1e-6 only in
# the first GN iteration and runs to its cap at its floor after it, where
# half the cap ends at the same optimum (PERF.md §6).
FAULTS = {"stop_after_2": lambda seed: _answer(seed, dict(OPT, iterations=2)),
          "turned_camera": lambda seed: _answer(seed, move="turned"),
          "moved_camera": lambda seed: _answer(seed, move="moved"),
          "tf32_control": _control}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_planted_fault_fails_the_limits(seed, fault):
    correct, compared = _compared(seed, FAULTS[fault](seed))
    assert not correct, compared


def test_the_pcg_alone_at_another_precision():
    """``pcg_prec`` at the reference's own precision changes nothing; in
    TF32 it moves the first step but not the start's chi^2."""
    arrays = _problem(0)["graph"]
    opt = dict(OPT, iterations=2)
    ref = reference_se3.optimize(arrays, opt, CPU)
    same = reference_se3.optimize(arrays, opt, CPU,
                                  pcg_prec=reference_se3.REFERENCE)
    assert same.errors == ref.errors
    assert torch.equal(same.poses, ref.poses)
    low = reference_se3.optimize(arrays, opt, CPU,
                                 pcg_prec=reference_se3.CONTROL)
    assert low.errors[0] == ref.errors[0]
    assert low.errors[1] != ref.errors[1]
