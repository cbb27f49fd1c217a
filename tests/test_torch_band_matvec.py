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
