"""The SE(3) bundle-adjustment configuration on the CPU: the cell found by
name, the ``se3`` family judging through ``check.worst_over_pool``, and
the SE(3) reference's closed-form Jacobians against autograd.  The cell
runs at 16 cameras x 64 points."""

import io
import math

import pytest
import torch

from slambench import cells, check, reference_se3, run
from slambench.graphs import camera_ring

CPU = torch.device("cpu")
SMALL = {"ba3d-512x4096.batch": {"num_poses": 16, "num_landmarks": 64,
                                 "pool": 2}}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _cell(name):
    c = cells.cell(name)
    return c._replace(graph={**c.graph, **SMALL[name]})


def test_the_se3_cell_resolves_by_name():
    c = cells.cell("ba3d-512x4096.batch")
    assert c.family == "se3" and c.traffic["driver"] == "batch"
    for attr in ("program_graph", "optimize", "gaps", "REFERENCE", "CONTROL",
                 "FLOAT32"):
        assert hasattr(cells.family(c), attr)
    cells.load("graphs", c.graph["kind"])
    for m in c.per_layer:
        assert callable(cells.reader(m["name"]))
    assert "edges3d_ms.solve" in {m["name"] for m in c.per_layer}
    assert {m["name"] for m in c.end_to_end} == {"solve_ms", "solve_ms_p90",
                                                "setup_s"}


def _solved(c, calls):
    driver = cells.driver(c)(c, 11, CPU)
    for _ in range(calls):
        driver.call()
    driver.close(run.Readings())
    return driver


def test_the_se3_family_judges_through_worst_over_pool():
    c = _cell("ba3d-512x4096.batch")
    family = cells.family(c)
    opt = c.config["optimizer"]
    driver = _solved(c, 2)
    got = check.worst_over_pool(family, driver.problems, opt, driver.answers,
                                CPU)
    want: dict = {}
    for i, problem in enumerate(driver.problems):
        g = problem["graph"]
        ref = family.optimize(g, opt, CPU, family.REFERENCE)
        mine = [a[1:] for a in driver.answers if a[0] == i]
        one = family.gaps(g, problem["n_poses"], problem["n_landmarks"], opt,
                          ref, mine, CPU)
        one.pop("steps")
        want = {k: max(want.get(k, -math.inf), v) for k, v in one.items()}
    assert got == want
    correct, compared = check.judge(got, c.config["correct"])
    assert correct, compared
    # one answer's camera turned half a turn about its x axis, to face
    # away from its points: the worst over the pool fails
    i, poses, landmarks, errors = driver.answers[0]
    poses = poses.clone()
    poses[driver.problems[i]["n_poses"] // 2, [1, 2, 4, 5, 7, 8]] *= -1.0
    driver.answers[0] = (i, poses, landmarks, errors)
    moved = check.worst_over_pool(family, driver.problems, opt,
                                  driver.answers, CPU)
    assert not check.judge(moved, c.config["correct"])[0]


def test_a_program_without_the_near_plane_is_refused_at_set_up(monkeypatch):
    """A program that projects the configuration's points as if it had no
    near plane solves another problem than the reference's: the run stops
    at set-up, before any solve, rather than print a result."""
    from toyslam_torch.ops import residuals3d

    c = _cell("ba3d-512x4096.batch")
    family = cells.family(c)
    assert family.near_plane_honoured(c.graph["near_plane"])
    monkeypatch.setattr(residuals3d, "near_plane", lambda k: 1e-6)
    assert not family.near_plane_honoured(c.graph["near_plane"])
    with pytest.raises(RuntimeError, match="near plane"):
        run.run(c, 2**31 + 7, 0.1, False, CPU, out=io.StringIO())


def _orthonormal(poses):
    """The poses with their rotations projected onto SO(3) in float64."""
    r = reference_se3.rot(poses)
    u, _, vh = torch.linalg.svd(r)
    r = u @ vh
    return torch.cat([r.reshape(r.shape[:-2] + (9,)),
                      reference_se3.trans(poses)], -1)


@pytest.mark.parametrize("edge", ["relative_pose", "reprojection"])
def test_the_closed_form_jacobians_are_the_residuals_derivatives(edge):
    """On rotations (poses and measurements) that are orthonormal in
    float64, the closed forms equal autograd's derivatives of the
    residuals through the retraction to 1e-9 of their largest entry
    (float64 rounding of products of size ~1e3)."""
    arrays = camera_ring.generate(5, 16, 64, 24)["graph"]
    pb = reference_se3.Problem(arrays, CPU, reference_se3.REFERENCE)
    ops, poses = pb.ops, _orthonormal(pb.poses0)
    # a state away from the start, so that no rotation residual is tiny
    step = torch.randn(poses.shape[0], 6, dtype=torch.float64,
                       generator=torch.Generator().manual_seed(0)) * 0.05
    poses = reference_se3.retract(ops, poses, step)
    if edge == "relative_pose":
        pi, pj, m = poses[pb.oi], poses[pb.oj], _orthonormal(pb.omeas)

        def f(ea, eb):
            return reference_se3.odom_residual(
                ops, reference_se3.retract(ops, pi, ea),
                reference_se3.retract(ops, pj, eb), m)

        _, ja, jb = reference_se3.odom_residual(ops, pi, pj, m, exact=True)
        zeros = (torch.zeros(pi.shape[0], 6, dtype=torch.float64),) * 2
    else:
        p, x = poses[pb.lp], pb.landmarks0[pb.ll]

        def f(ea, dx):
            return reference_se3.reprojection(
                ops, reference_se3.retract(ops, p, ea), x + dx,
                pb.intrinsics, pb.lmeas)

        _, ja, jb = reference_se3.reprojection(ops, p, x, pb.intrinsics,
                                               pb.lmeas, jacobians=True)
        zeros = (torch.zeros(p.shape[0], 6, dtype=torch.float64),
                 torch.zeros(p.shape[0], 3, dtype=torch.float64))
    full = torch.autograd.functional.jacobian(f, zeros)
    e = torch.arange(zeros[0].shape[0])
    for mine, whole in zip((ja, jb), full):
        auto = whole[e, :, e, :]
        assert float((mine - auto).abs().max() / auto.abs().max()) < 1e-9
