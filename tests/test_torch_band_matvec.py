"""B3, the slab-streamed band ``V V^T`` matvec (``toyslam_torch.ops.
band_matvec``), against the JAX package's prototype
``scripts/exp_band_kernel.py``: its Pallas kernel (``make_fn``, in
interpret mode on the CPU) and its numpy ``oracle``, on the same seeded
numpy inputs, at rel 1e-5 of max|want| (the script's own bound; f32 sums
of up to 6*W terms taken in another order).  The CUDA kernel itself is
held against the plain version in ``test_torch_kernel.py`` (marked
``cuda``) and in ``chip_smoke.py`` (phase ``slab_band_matvec``).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from toyslam_torch.ops import band_matvec as bmv
from toyslam_torch.scripts import exp_band_kernel as port_script

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
REL = 1e-5
# (Np, W, B): W < B; W > B; the script's own check shape; Np not a
# multiple of B (the last 40 poses carry no landmark)
CASES = [(1024, 64, 256), (512, 96, 64), (10240, 64, 256), (1000, 40, 64)]


@pytest.fixture(scope="module")
def jax_script():
    """``scripts/exp_band_kernel.py`` as a module.  It imports ``_bootstrap``
    (which sets two JAX cache variables) and ``tputime`` from its own
    directory; both are put back out of the way after the import."""
    env = dict(os.environ)
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import exp_band_kernel
    finally:
        sys.path.remove(str(ROOT / "scripts"))
        os.environ.clear()
        os.environ.update(env)
    return exp_band_kernel


def _inputs(np_, W, B, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, np_)).astype(np.float32)
    slab = rng.normal(size=(np_ // B, W, 6, B)).astype(np.float32)
    return x, slab


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-9))


@pytest.mark.parametrize("np_,W,B", CASES)
def test_plain_version_matches_the_pallas_kernel(jax_script, np_, W, B):
    x, slab = _inputs(np_, W, B)
    want = np.asarray(jax_script.make_fn(np_, W, B, 1)(x, slab))
    got = bmv.slab_band_matvec_ref(torch.from_numpy(x),
                                   torch.from_numpy(slab), W, B)
    assert got.shape == (3, np_) and got.dtype == torch.float32
    assert _rel(got, want) < REL


@pytest.mark.parametrize("np_,W,B", CASES)
def test_port_oracle_matches_plain_version_and_the_jax_oracle(
        jax_script, np_, W, B):
    x, slab = _inputs(np_, W, B, seed=1)
    want = port_script.oracle(slab, x, np_, W, B)
    np.testing.assert_array_equal(
        want, jax_script.oracle(slab, x, np_, W, B))
    got = bmv.slab_band_matvec_ref(torch.from_numpy(x),
                                   torch.from_numpy(slab), W, B)
    assert _rel(got, want) < REL


def test_zero_slab_gives_zero():
    x, slab = _inputs(512, 96, 64)
    out = bmv.slab_band_matvec_ref(torch.from_numpy(x),
                                   torch.zeros_like(torch.from_numpy(slab)),
                                   96, 64)
    assert torch.equal(out, torch.zeros(3, 512))


@pytest.mark.parametrize("np_,W,B", CASES)
def test_operator_is_symmetric_and_positive(np_, W, B):
    """``M = V V^T``: ``<y, M x> = <M y, x>`` at rel 1e-5 of ``|y| |M x|``,
    and ``<x, M x> >= 0``."""
    x, slab = _inputs(np_, W, B, seed=2)
    y = np.random.default_rng(3).normal(size=x.shape).astype(np.float32)
    s = torch.from_numpy(slab)
    mx = bmv.slab_band_matvec_ref(torch.from_numpy(x), s, W, B).double()
    my = bmv.slab_band_matvec_ref(torch.from_numpy(y), s, W, B).double()
    xd, yd = torch.from_numpy(x).double(), torch.from_numpy(y).double()
    lhs, rhs = float((yd * mx).sum()), float((my * xd).sum())
    assert abs(lhs - rhs) <= REL * float(yd.norm() * mx.norm())
    assert float((xd * mx).sum()) >= 0.0


def test_wrapper_on_cpu_runs_plain_version_uncounted():
    x, slab = (torch.from_numpy(a) for a in _inputs(512, 96, 64))
    before = bmv.slab_band_matvec.launches
    out = bmv.slab_band_matvec(x, slab, 96, 64)
    assert torch.equal(out, bmv.slab_band_matvec_ref(x, slab, 96, 64))
    assert bmv.slab_band_matvec.launches == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "strides", "width",
                                 "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x, slab = (torch.from_numpy(a) for a in _inputs(512, 96, 64))
    W, B = 96, 64
    if bad == "dtype":
        slab = slab.double()
    elif bad == "shape":
        slab = slab[:-1]
    elif bad == "strides":
        x = torch.from_numpy(np.asfortranarray(x.numpy()))
    elif bad == "width":
        W = 95
    else:
        x, slab = x.to("meta"), slab.to("meta")
    with pytest.raises((TypeError, ValueError)):
        bmv.slab_band_matvec(x, slab, W, B)


# (W, B): the smoke's five shapes, then W=1, W < 32, W > B with B=40, the
# card tests' W=40 at B=64, a B that is not a multiple of 4, a window on 8
# blocks of 16 warps x 7 rows, and the widest window a cluster of 8 takes
PLAN_CASES = [(64, 256), (320, 512), (320, 1024), (576, 512), (576, 1024),
              (1, 40), (33, 64), (96, 40), (40, 64), (50, 37), (800, 256),
              (1024, 8)]


@pytest.mark.parametrize("W,B", PLAN_CASES)
def test_slab_plan_fits_a_block_and_covers_the_window(W, B):
    p = bmv.slab_plan(W, B)
    assert p.tl == 32 and 1 <= p.cs <= bmv.MAX_CLUSTER
    assert p.smem_bytes <= 232_448
    assert p.cs * p.wb >= W > (p.cs - 1) * p.wb
    assert p.warps in (8, 16) and p.warps * p.nw >= p.wb
    assert 1 <= p.nw <= bmv.MAX_NW
    assert p.sp == p.wb + 31
    assert p.part_shape(7, B) == (7 * -(-B // 32), p.cs, 3, p.wb + 31)
    # the least cluster whose blocks stay within the plan's rows
    rows = (bmv.ROWS_1 if W <= bmv.ROWS_1 else
            bmv.ROWS_8 if W <= 8 * bmv.ROWS_8 else bmv.ROWS_16)
    if p.cs > 1 and p.wb <= rows:
        assert -(-W // (p.cs - 1)) > rows


def test_slab_plan_at_the_sweep_shapes():
    """Clusters of 6 blocks of 16 warps x 6 rows at W=576, 6 blocks of 8
    warps x 7 rows at W=320, one block of 8 warps x 8 rows at W=64."""
    assert bmv.slab_plan(576, 512) == bmv.SlabPlan(32, 6, 16, 96, 6, 13_236)
    assert bmv.slab_plan(320, 1024) == bmv.SlabPlan(32, 6, 8, 54, 7, 7_252)
    assert bmv.slab_plan(64, 256) == bmv.SlabPlan(32, 1, 8, 64, 8, 7_444)


def test_slab_plan_takes_a_cluster_size_and_cuts_empty_ranks():
    assert bmv.slab_plan(33, 64, 4) == bmv.SlabPlan(32, 4, 8, 9, 2, 6_292)
    # 8 ranks of ceil(33/8) = 5 rows: the eighth would hold none
    assert bmv.slab_plan(33, 64, 8).cs == 7
    for cs in (0, 9):
        with pytest.raises(ValueError):
            bmv.slab_plan(33, 64, cs)


@pytest.mark.parametrize("W", [1025, 4096])
def test_slab_plan_refuses_a_window_no_cluster_holds(W):
    """The card's kernel takes W <= 1024; the plain version, which the
    wrapper runs on CPU tensors, any W."""
    with pytest.raises(ValueError, match="rows a warp"):
        bmv.slab_plan(W, 256)
    x, slab = (torch.from_numpy(a) for a in _inputs(256, W, 256))
    out = bmv.slab_band_matvec(x, slab, W, 256)
    assert torch.equal(out, bmv.slab_band_matvec_ref(x, slab, W, 256))


@pytest.mark.parametrize("W,cs,wb", [(65, 2, 33), (113, 3, 38)])
def test_wrapper_on_cpu_at_plans_of_several_ranks(W, cs, wb):
    """Windows that the plan splits over 2 and 3 blocks (the last rank's
    share short at W=113): the CPU wrapper is the plain version."""
    p = bmv.slab_plan(W, 64)
    assert (p.cs, p.wb) == (cs, wb) and p.cs * p.wb >= W
    x, slab = (torch.from_numpy(a) for a in _inputs(512, W, 64))
    out = bmv.slab_band_matvec(x, slab, W, 64)
    assert torch.equal(out, bmv.slab_band_matvec_ref(x, slab, W, 64))


def test_launch_needs_the_card():
    """The launch helper of the smoke's cluster sweep raises on CPU
    tensors instead of computing anything."""
    x, slab = (torch.from_numpy(a) for a in _inputs(512, 96, 64))
    with pytest.raises(ValueError, match="no kernel for cpu"):
        bmv._launch(x, slab, 96, 64, bmv.slab_plan(96, 64, 3))


def test_pass_timer_needs_the_card():
    x, slab = (torch.from_numpy(a) for a in _inputs(512, 96, 64))
    with pytest.raises(ValueError):
        bmv.pass_ms(x, slab, 96, 64)


def test_bound_is_the_slab_read_at_the_sweep_shapes():
    b = bmv.bound(10240, 576, 512)
    assert b["bound_by"] == "bytes"
    assert b["bytes"] == 4 * (6 * 10240 + 10240 * 576 * 6)
    assert b["bound_ms"] == pytest.approx(b["bytes"] / 3.35e12 * 1e3)
    assert bmv.bound(10240, 64, 256)["bound_ms"] == pytest.approx(
        4.77e-3, rel=1e-2)


def _python(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=240)


def test_entry_point_on_cpu_checks_and_skips_timing():
    proc = _python("-m", "toyslam_torch.scripts.exp_band_kernel",
                   "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0].startswith("correctness W=64 B=256: rel err ")
    assert float(lines[0].split()[5]) < REL
    assert lines[-1] == "CPU: skipping timing"


def test_entry_point_runs_on_the_card_by_default():
    """Without a GPU the default (``--device cuda``) exits 2: no CPU
    fallback."""
    code = ("import torch; torch.cuda.is_available = lambda: False; "
            "from toyslam_torch.scripts.exp_band_kernel import main; main([])")
    proc = _python("-c", code)
    assert proc.returncode == 2 and "no CUDA device" in proc.stderr
    assert proc.stdout == ""


def test_host_timer_needs_the_card():
    """``band_matvec_host`` times the wrapper on the card and exits 2
    without one."""
    code = ("import torch; torch.cuda.is_available = lambda: False; "
            "from toyslam_torch.scripts.band_matvec_host import main; "
            "main([])")
    proc = _python("-c", code)
    assert proc.returncode == 2 and "needs a CUDA device" in proc.stderr
    assert proc.stdout == ""
