"""The plain reference: independent of the program, right against autograd
and the port's plain path, and failed by its own lower-precision control.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from slambench import cells, check, generators, reference

ROOT = Path(__file__).resolve().parents[2]


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, slambench.reference, slambench.check; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    loaded = set(json.loads(out.replace("'", '"')))
    assert not loaded & {"toyslam_torch", "toyslam_tpu", "jax", "jaxlib",
                         "flax"}


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11,
                      -1.0 - 2**-12])
    want = torch.tensor([1.0, 1.0 + 2**-10, 1.0, 1.0 + 2**-9, -1.0])
    assert torch.equal(reference.tf32_round(x), want)
    y = torch.randn(10_000, generator=torch.Generator().manual_seed(0))
    r = reference.tf32_round(y)
    assert ((r - y).abs() <= y.abs() * 2**-11).all()
    assert ((r.view(torch.int32) & 0x1FFF) == 0).all()


def test_closed_form_jacobians_are_the_residuals_derivatives():
    g = torch.Generator().manual_seed(3)
    pi = torch.rand(7, 3, generator=g, dtype=torch.float64) * 4 - 2
    pj = torch.rand(7, 3, generator=g, dtype=torch.float64) * 4 - 2
    m = torch.rand(7, 3, generator=g, dtype=torch.float64) - 0.5
    lm = torch.rand(7, 2, generator=g, dtype=torch.float64) * 6 - 3
    meas = torch.rand(7, 2, generator=g, dtype=torch.float64) + 0.5
    ja, jb = reference.odom_jacobians(pi, pj, m)
    la, lb = reference.landmark_jacobians(pi, lm)
    for e in range(7):
        fa = torch.func.jacrev(
            lambda a: reference.odom_residual(a, pj[e], m[e]))(pi[e])
        fb = torch.func.jacrev(
            lambda b: reference.odom_residual(pi[e], b, m[e]))(pj[e])
        assert torch.allclose(ja[e], fa) and torch.allclose(jb[e], fb)
        fa = torch.func.jacrev(
            lambda p: reference.landmark_residual(p, lm[e], meas[e]))(pi[e])
        fb = torch.func.jacrev(
            lambda q: reference.landmark_residual(pi[e], q, meas[e]))(lm[e])
        assert torch.allclose(la[e], fa) and torch.allclose(lb[e], fb)


def _plain_program(graph_arrays, opt):
    from toyslam_torch.config import OptimizerConfig
    from toyslam_torch.models.graph import graph_from_numpy
    from toyslam_torch.optimizer import GaussNewton

    gn = GaussNewton(OptimizerConfig(**dict(opt, pcg_backend="xla")))
    res = gn.optimize(gn._prepare(graph_from_numpy(**graph_arrays)))
    return res.graph.poses, res.graph.landmarks, res.errors


# the port's plain PCG loop on the CPU against the float64 reference: the
# main path's graph at its own size, and a serpentine graph of the 10k
# configuration's shape (its optimizer, 2,100 poses), at a seed where the
# truncated solve has reached its plateau (at seeds where it has not, the
# float32 reference itself departs from the float64 one by up to 5e-3)
@pytest.mark.parametrize("name,graph,seed,limit", [
    ("toyslam-150", {}, 0, 1e-4),
    ("sparse-10k", {"num_poses": 2100, "num_landmarks": 2100}, 3, 1e-4),
])
def test_reference_agrees_with_the_ports_plain_path(name, graph, seed,
                                                    limit):
    torch.set_num_threads(2)
    c = cells.cell(f"{name}.batch")
    p = generators.generate({**c.graph, **graph}, seed)
    opt = c.config["optimizer"]
    ref = reference.optimize(p["graph"], opt)
    got = check.gaps(p["graph"], p["n_poses"], p["n_landmarks"], opt, ref,
                     [_plain_program(p["graph"], opt)], "cpu")
    assert got["state_gap"] < limit and got["chi2_gap"] < limit
    assert got["chi2_step1_gap"] < limit


@pytest.mark.parametrize("name", ["toyslam-150", "sparse-10k"])
def test_the_control_fails_the_configurations_limits(name):
    """The reference in float32 with TF32 products, in the program's place,
    is not correct at the cell's size (seed 0)."""
    torch.set_num_threads(2)
    c = cells.cell(f"{name}.batch")
    p = generators.generate(c.graph, 0)
    opt = c.config["optimizer"]
    ref = reference.optimize(p["graph"], opt)
    ctl = reference.optimize(p["graph"], opt, prec=reference.CONTROL)
    got = check.gaps(p["graph"], p["n_poses"], p["n_landmarks"], opt, ref,
                     [(ctl.poses, ctl.landmarks, torch.tensor(ctl.errors))],
                     "cpu")
    correct, _ = check.judge(got, c.config["correct"])
    assert not correct
