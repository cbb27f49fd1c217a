"""The port's benchmark entry points, ``python -m toyslam_torch.bench`` and
``python -m toyslam_torch.scripts.bench_suite``, on the CPU:

* ``multi-loop-1k`` at its full config, the port against the JAX package
  (per-iteration chi^2 at rtol 1e-4, poses and landmarks at atol 1e-3, PCG
  iterations within one chunk: ``test_torch_gauss_newton._compare``) and
  against the JAX suite's record (``BENCH_SUITE.json``);
* the headline on the CPU: one JSON line with ``bench.py``'s keys (less
  ``rtt_s``), the ATE within 2e-3 of 0.7552, no kernel launch;
* neither entry point falls back to the CPU without a GPU;
* the suite's rows are the JAX suite's, by name (its record) and by
  ``OptimizerConfig`` field (its source, read with ``ast``);
* ``reference-150`` passes its gate.
"""

import ast
import contextlib
import dataclasses
import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_gauss_newton import _compare

from toyslam_tpu.config import OptimizerConfig as JOpt
from toyslam_tpu.config import SimConfig as JSim, SlamConfig as JSlam
from toyslam_tpu.optimizer import GaussNewton as JGN
from toyslam_tpu.sim import frontend as jf
from toyslam_tpu.sim import synthetic as j_syn
from toyslam_torch.optimizer import GaussNewton as TGN
from toyslam_torch.scripts import bench_suite

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


def _python(*args, timeout=600):
    return subprocess.run([sys.executable, *args], cwd=ROOT, timeout=timeout,
                          capture_output=True, text=True)


def test_multi_loop_1k_matches_jax():
    name = "multi-loop-1k"
    sim = jf.simulate(JSim(robot_steps=1050, seed=0),
                      controls=j_syn.multi_loop_controls(1049, loop_steps=150))
    jg = jf.build_graph(sim, JSlam(sim=JSim(robot_steps=1050, seed=0)))[0]
    cfg = bench_suite.optimizer_config(name)
    jr = JGN(JOpt(**{f.name: getattr(cfg, f.name)
                     for f in dataclasses.fields(cfg)})).optimize(jg)
    tg, gt, n = bench_suite.row_graph(name)
    np.testing.assert_array_equal(gt, np.asarray(sim.poses_gt))
    tr = TGN(cfg).optimize(tg)
    _compare(jr, tr)
    ref = bench_suite.SIM_REF[name]
    assert abs(tr.errors[tr.iterations_run - 1].item() - ref["chi2"][1]) \
        <= 1e-3 * ref["chi2"][1]
    assert abs(jf.ate_rmse(tr.graph.poses[:n].numpy(), gt) - ref["ate"]) \
        <= 2e-3


def test_headline_on_the_cpu():
    proc = _python("-m", "toyslam_torch.bench", "--device", "cpu",
                   "--reps", "1", "--rounds", "1")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    keys = {"metric", "value", "unit", "headline_stat", "iters_per_s_best",
            "iters_per_s_iqr", "vs_baseline", "vs_native_cpu", "ate_rmse",
            "baseline_ate_rmse", "dead_reckoning_ate_rmse", "iterations",
            "wall_s_per_opt_best", "wall_s_per_opt_median",
            "wall_s_per_opt_rounds", "latency_s_single_call", "platform",
            "device", "kernel_launches", "card"}
    assert set(out) == keys
    assert "Pallas" not in out["metric"]
    assert abs(out["ate_rmse"] - 0.7552) <= 2e-3
    assert abs(out["dead_reckoning_ate_rmse"] - 6.5673) <= 1e-4
    assert out["kernel_launches"] == {"fused_pcg_chunk": 0,
                                      "band_fused_pcg_chunk": 0}
    assert (out["platform"], out["card"], out["iterations"]) == ("cpu", None,
                                                                 10)
    assert out["value"] > 0 and len(out["wall_s_per_opt_rounds"]) == 1
    assert out["vs_baseline"] == pytest.approx(
        out["value"] / 0.6885298886903722)


@pytest.mark.parametrize("module", ["toyslam_torch.bench",
                                    "toyslam_torch.scripts.bench_suite"])
def test_entry_point_without_a_card_fails(module):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _python("-m", module, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""


def _jax_suite_configs() -> dict:
    """The JAX suite's rows and their ``OptimizerConfig`` keywords, read
    from ``scripts/bench_suite.py``: ``main`` (the 2D rows) and
    ``bench_ba3d`` (the BA pair, each under "fused" and "xla")."""
    tree = ast.parse((ROOT / "scripts" / "bench_suite.py").read_text())
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}

    def calls(fn):
        found = [n for n in ast.walk(fns[fn]) if isinstance(n, ast.Call)
                 and getattr(n.func, "id", None) == "OptimizerConfig"]
        found.sort(key=lambda n: (n.lineno, n.col_offset))
        return [{k.arg: (k.value.id if isinstance(k.value, ast.Name)
                         else ast.literal_eval(k.value))
                 for k in n.keywords} for n in found]

    ref150, ml1k, grid = calls("main")
    revisit = [n for n in ast.walk(fns["main"]) if isinstance(n, ast.Call)
               and getattr(n.func, "attr", None) == "replace"]
    assert len(revisit) == 1
    revisit = dict(grid, **{k.arg: ast.literal_eval(k.value)
                            for k in revisit[0].keywords})
    matched, policy = calls("bench_ba3d")
    rows = {"reference-150": ref150, "multi-loop-1k": ml1k,
            "large-sparse-10k": grid, "large-sparse-10k-revisit": revisit}
    for backend in ("fused", "xla"):
        for suffix, kw in (("", policy), ("-matched64", matched)):
            assert kw["pcg_backend"] == "backend"
            rows[f"ba3d-128x512-{backend}{suffix}"] = dict(
                kw, pcg_backend=backend)
    return rows


def test_suite_rows_are_the_jax_suites():
    record = json.loads((ROOT / "BENCH_SUITE.json").read_text())
    assert bench_suite.ROWS == tuple(c["config"] for c in record["configs"])
    jax_rows = _jax_suite_configs()
    assert set(jax_rows) == set(bench_suite.ROWS)
    for name, kw in jax_rows.items():
        want = JOpt(**kw)
        got = bench_suite.optimizer_config(name)
        fields = [f.name for f in dataclasses.fields(got)]
        assert [f for f in fields if not hasattr(want, f)] == []
        assert {f: getattr(got, f) for f in fields} == {
            f: getattr(want, f) for f in fields}, name


def test_suite_gates_are_the_smokes():
    """The 10k and BA gates are the references chip_smoke.py holds those
    paths to (the same JAX runs)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    assert bench_suite.GRID_REF == chip_smoke.GRID_REF
    assert bench_suite.GRID_OPT == chip_smoke.GRID_BENCH
    ba = chip_smoke.BA_REF["ba128"]
    assert bench_suite.BA_REF["policy"]["chi2"] == ba["chi2"]
    assert bench_suite.BA_REF["policy"]["ate_initial"] == ba["ate_initial"]
    assert bench_suite.BA_OPT == chip_smoke._BA_BENCH
    assert bench_suite.SIM_REF["reference-150"]["chi2"] == (
        chip_smoke.CHI2_FIRST, chip_smoke.CHI2_FINAL)


def test_reference_150_passes_its_gate():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = bench_suite.main(["--rows", "reference-150", "--quick",
                                 "--device", "cpu"])
    assert code == 0
    (line,) = buf.getvalue().strip().splitlines()
    row = json.loads(line)
    assert row["config"] == "reference-150" and row["gate"]["ok"]
    assert row["kernel_launches"] == {"fused_pcg_chunk": 0,
                                      "band_fused_pcg_chunk": 0}
    assert row["pcg_iters"] == [35, 35, 34, 33, 33, 32, 32, 32, 31, 31]
    assert len(row["wall_s_rounds"]) == 1
