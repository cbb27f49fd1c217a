"""``python -m toyslam_torch.parallel.launch`` with 2 CPU ranks (gloo): the
counterpart of ``tests/test_multihost.py``, at a size that keeps it in
tier-1.  Each run exits 0, prints one JSON line whose ranks agree bit for
bit, and launches no kernel; ``--out`` writes the line with rank 0's
trajectory."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("solves", [["edge"], ["edge", "partition"]])
def test_two_rank_launch_agrees_bitwise(tmp_path, solves):
    out = tmp_path / "launch.json"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "toyslam_torch.parallel.launch",
         "--procs", "2", "--device", "cpu", "--steps", "60",
         "--iterations", "4", "--reps", "1", "--solve", *solves,
         "--out", str(out)],
        capture_output=True, text=True, timeout=600, cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["ok"] is True
    assert line["bitwise_agreement_across_processes"] is True
    assert (line["num_processes"], line["backend"]) == (2, "gloo")
    saved = json.loads(out.read_text())
    assert list(line["runs"]) == solves
    for solve, run in line["runs"].items():
        assert run["ok"] and run["bitwise_agreement_across_processes"]
        assert run["kernel_launches"] == [
            {"fused_pcg_chunk": 0, "band_fused_pcg_chunk": 0}] * 2
        r = run["result"]
        assert r["iterations_run"] == 4 and r["ate_rmse"] < 3.0
        assert r["gn_iters_per_s"] > 0 and r["collectives"] > 0
        assert len(saved["runs"][solve]["trajectory"]) == r["poses"] == 60
        assert "trajectory" not in run


def test_launch_without_a_card_fails(tmp_path):
    """The default device is the GPU: without one the launcher fails
    rather than run on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, "-m", "toyslam_torch.parallel.launch",
         "--procs", "1", "--steps", "20", "--iterations", "1", "--reps",
         "0"], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_skewed_ranks_leave_the_group_together():
    """One rank sleeps after its last all-reduce, before its result is
    saved, while the other goes on to tear the group down: ``run_ranks``
    returns both results, and no rank aborts ("terminate called")."""
    code = (
        "import sys; sys.path.insert(0, 'tests')\n"
        "import torch_parallel_ranks as ranks\n"
        "from toyslam_torch.parallel.launch import run_ranks\n"
        "print(run_ranks(ranks.skewed_finish, 2, 'cpu', (1, 2.0)))\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "terminate called" not in proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == str(
        [{"rank": r, "sum": [3.0] * 4} for r in range(2)])
