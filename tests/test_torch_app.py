"""The PyTorch port as a user starts it: ``python -m toyslam_torch run``
prints one metrics JSON line, and neither the package nor ``chip_smoke.py``
pulls in JAX or the JAX package (checked in fresh interpreters, since this
test process has JAX loaded already)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def _python(*args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_cli_run_prints_metrics_json():
    proc = _python("-m", "toyslam_torch", "run", "--steps", "40",
                   "--iterations", "3", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    m = json.loads(proc.stdout.strip().splitlines()[-1])
    for key in ("cmd", "backend", "poses", "landmarks", "ate_rmse",
                "ate_dead_reckoning", "sim_s", "build_s", "optimize_s",
                "iterations_run", "chi2_first", "chi2_final", "pcg_iters",
                "lambdas"):
        assert key in m, key
    assert m["cmd"] == "run" and m["poses"] == 40 and m["device"] == "cpu"
    assert m["iterations_run"] == 3 and len(m["pcg_iters"]) == 3
    assert m["chi2_final"] < m["chi2_first"]
    assert m["ate_rmse"] < m["ate_dead_reckoning"]
    assert m["kernel_launches"] == 0


@pytest.mark.parametrize("device_args", [["--device", "cuda"], []])
def test_cli_refuses_a_missing_gpu(device_args):
    """``--device cuda``, and the default, exit 2 without a GPU: no CPU
    fallback."""
    args = ["run", "--steps", "20", *device_args]
    code = ("import torch, sys; from toyslam_torch.app import main; "
            "torch.cuda.is_available = lambda: False; "
            f"sys.exit(main({args!r}))")
    proc = _python("-c", code)
    assert proc.returncode == 2 and "no CUDA device" in proc.stderr
    assert proc.stdout == ""


def test_cli_runs_on_the_card_by_default():
    from toyslam_torch.app import build_parser

    assert build_parser().parse_args(["run"]).device == "cuda"


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys, toyslam_torch\n"
        "for m in pkgutil.walk_packages(toyslam_torch.__path__, "
        "'toyslam_torch.'):\n"
        "    if m.name != 'toyslam_torch.__main__':\n"
        "        importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'toyslam_tpu')]\n"
        "ba = ['se3', 'residuals3d', 'edge_blocks3d', 'schur3d']\n"
        "assert all('toyslam_torch.ops.' + m in sys.modules for m in ba)\n"
        "assert 'toyslam_torch.models.graph3d' in sys.modules\n"
        "assert 'toyslam_torch.sim.synthetic3d' in sys.modules\n"
        "new = ['io.codec', 'io.snapshot', 'io.client', 'io.server', "
        "'io.native', 'optimizer.coarse_init', 'sim.live', 'view', "
        "'view.view2d']\n"
        "assert all('toyslam_torch.' + m in sys.modules for m in new)\n"
        "par = ['parallel', 'parallel.partition', 'parallel.launch', "
        "'parallel.mesh', 'parallel.distributed', 'ops.collective']\n"
        "assert all('toyslam_torch.' + m in sys.modules for m in par)\n"
        "b3 = ['ops.band_matvec', 'scripts', 'scripts.exp_band_kernel']\n"
        "assert all('toyslam_torch.' + m in sys.modules for m in b3)\n"
        "bench = ['bench', 'scripts.bench_suite']\n"
        "assert all('toyslam_torch.' + m in sys.modules for m in bench)\n"
        "scale = ['scripts.bench_plateau', 'scripts.exp_band100k', "
        "'scripts.bench_huge', 'scripts.bench_fused', 'scripts.exp_ba512', "
        "'scripts.measure_native_baseline']\n"
        "assert all('toyslam_torch.' + m in sys.modules for m in scale)\n"
        "print(len([k for k in sys.modules if k.startswith('toyslam_torch')]))\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = _python("-c", code)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[-1]) >= 40   # every module was imported


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    """Without a CUDA device, or away from a checkout, the smoke test exits
    non-zero and prints no result line."""
    proc = _python("chip_smoke.py")
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout


def test_cli_ba3d_runs_on_the_card_by_default_and_refuses_a_missing_gpu():
    from toyslam_torch.app import build_parser

    args = build_parser().parse_args(["ba3d"])
    assert args.device == "cuda"
    assert (args.poses, args.landmarks, args.obs, args.iterations,
            args.huber, args.seed) == (64, 256, 24, 25, 1e9, 0)
    code = ("import torch, sys; from toyslam_torch.app import main; "
            "torch.cuda.is_available = lambda: False; "
            "sys.exit(main(['ba3d', '--poses', '8']))")
    proc = _python("-c", code)
    assert proc.returncode == 2 and "no CUDA device" in proc.stderr
    assert proc.stdout == ""
