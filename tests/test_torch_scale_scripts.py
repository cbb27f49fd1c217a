"""The port's scale entry points (``toyslam_torch/scripts``: ``bench_plateau``,
``exp_band100k``, ``bench_huge``, ``bench_fused``, ``exp_ba512``,
``measure_native_baseline``) on the CPU:

* each one's configs equal its JAX twin's field for field:
  ``OptimizerConfig``, ``NoiseConfig`` and the ``make_large_problem`` /
  ``make_ba_problem`` arguments, read from ``scripts/*.py`` with ``ast``
  and evaluated with the JAX package's classes;
* the port's ``run_to_plateau`` against the JAX script's own (imported
  from ``scripts/``, ``chain=1``, its rounding switched off) on one small
  laps=2 graph through the plain grid loop: ``chi2_curve`` at rtol 1e-4,
  ``iters_to_plateau`` equal, ``chi2_at_ground_truth`` at rtol 1e-5, the
  ATE within 1e-3;
* each entry point with ``--device cpu`` at a small size, in process: exit
  0, the JSON keys of its JAX twin (from the JAX package's recorded
  output), no kernel launch;
* without a GPU each one refuses to run (exit 2, nothing printed);
* no run writes a root ``BENCH_*.json`` or ``BASELINE_MEASURED.json``
  (hashes before and after).
"""

import ast
import contextlib
import dataclasses
import hashlib
import io
import json
import math
import os
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from toyslam_tpu.config import NoiseConfig as JNoise
from toyslam_tpu.config import OptimizerConfig as JOpt
from toyslam_tpu.config import SimConfig as JSim
from toyslam_tpu.config import SlamConfig as JSlam
from toyslam_tpu.sim import synthetic as j_syn
from toyslam_torch.config import OptimizerConfig as TOpt
from toyslam_torch.scripts import (
    bench_fused,
    bench_huge,
    bench_plateau,
    exp_ba512,
    exp_band100k,
    measure_native_baseline,
)
from toyslam_torch.sim import synthetic as t_syn

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
SCRIPTS = ROOT / "scripts"
MODULES = {
    "bench_plateau": bench_plateau, "exp_band100k": exp_band100k,
    "bench_huge": bench_huge, "bench_fused": bench_fused,
    "exp_ba512": exp_ba512,
    "measure_native_baseline": measure_native_baseline,
}
# each entry point at a small size on the CPU (a few seconds each)
SMALL = {
    "bench_plateau": ["--scale", "0.01", "--iterations", "2"],
    "exp_band100k": ["--scale", "0.0205", "--iterations", "2", "--rounds", "1",
                     "--reps", "1"],
    "bench_huge": ["--rounds", "1"],
    "bench_fused": ["--workloads", "reference-150", "--reps", "1",
                    "--rounds", "1"],
    "exp_ba512": ["--scale", "0.125", "--iterations", "3", "--rounds", "1",
                  "--reps", "1"],
    "measure_native_baseline": ["--rounds", "1"],
}
HUGE_POSES = "1000"


# --- the JAX scripts' configs, read with ast -------------------------------

def _segment(src: str, node) -> str:
    return ast.get_source_segment(src, node)


def _script_calls(name: str, fn: str, env: dict | None = None):
    """The values of the ``OptimizerConfig``, ``NoiseConfig``,
    ``dataclasses.replace``, ``make_large_problem`` and ``make_ba_problem``
    calls in ``scripts/<name>.py``'s function ``fn`` (nested functions
    included), in source order, as ``(callee, value)``.  The function's
    simple assignments are evaluated first, in order, with the JAX
    package's config classes; the two graph builders return their keyword
    arguments."""
    src = (SCRIPTS / f"{name}.py").read_text()
    tree = ast.parse(src)
    (func,) = [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
               and n.name == fn]
    kwargs = lambda **kw: kw  # noqa: E731
    scope = {"OptimizerConfig": JOpt, "NoiseConfig": JNoise,
             "SimConfig": JSim, "SlamConfig": JSlam,
             "dataclasses": dataclasses, "math": math, "os": os,
             "synthetic": types.SimpleNamespace(make_large_problem=kwargs),
             "synthetic3d": types.SimpleNamespace(make_ba_problem=kwargs),
             **(env or {})}
    nodes = sorted(ast.walk(func), key=lambda n: (getattr(n, "lineno", 0),
                                                  getattr(n, "col_offset", 0)))
    for n in nodes:
        if (isinstance(n, ast.Assign) and len(n.targets) == 1
                and isinstance(n.targets[0], ast.Name)):
            try:
                scope[n.targets[0].id] = eval(_segment(src, n.value), scope)
            except (NameError, AttributeError, TypeError, ValueError,
                    KeyError, IndexError):
                pass        # a graph, a timer, a result: not a config
    wanted = ("OptimizerConfig", "NoiseConfig", "dataclasses.replace",
              "synthetic.make_large_problem", "synthetic3d.make_ba_problem",
              "SlamConfig")
    out = []
    for n in nodes:
        if isinstance(n, ast.Call) and _segment(src, n.func) in wanted:
            out.append((_segment(src, n.func),
                        eval(_segment(src, n), scope)))
    return out


def _same_config(port, jax_cfg, name=""):
    fields = [f.name for f in dataclasses.fields(port)]
    assert [f for f in fields if not hasattr(jax_cfg, f)] == []
    assert {f: getattr(port, f) for f in fields} == {
        f: getattr(jax_cfg, f) for f in fields}, name


def _same_graph_args(port: dict, jax_kw: dict, name=""):
    port, jax_kw = dict(port), dict(jax_kw)
    pn, jn = port.pop("noise", None), jax_kw.pop("noise", None)
    assert port == jax_kw, name
    assert (pn is None) == (jn is None), name
    if pn is not None:
        assert dataclasses.asdict(pn) == dataclasses.asdict(jn), name


def test_plateau_configs_are_the_jax_scripts():
    calls = _script_calls("bench_plateau", "run_10k")
    (_, base10), (_, g10), (_, g10r) = calls
    _same_config(bench_plateau.optimizer_config("plateau-10k"), base10)
    _same_config(bench_plateau.optimizer_config("plateau-10k-revisit"),
                 base10)
    _same_graph_args(bench_plateau.graph_args("plateau-10k"), g10)
    _same_graph_args(bench_plateau.graph_args("plateau-10k-revisit"), g10r)

    calls = dict(_script_calls("bench_plateau", "run_100k"))
    (base100,) = [v for k, v in _script_calls("bench_plateau", "run_100k")
                  if k == "OptimizerConfig"]
    graphs = [v for k, v in _script_calls("bench_plateau", "run_100k")
              if k == "synthetic.make_large_problem"]
    _same_config(bench_plateau.optimizer_config("plateau-100k-revisit"),
                 base100)
    _same_config(
        bench_plateau.optimizer_config("plateau-100k-revisit-lownoise"),
        base100)
    _same_graph_args(bench_plateau.graph_args("plateau-100k-revisit"),
                     graphs[0])
    _same_graph_args(
        bench_plateau.graph_args("plateau-100k-revisit-lownoise"), graphs[1])
    assert "NoiseConfig" in calls

    incr = _script_calls("bench_plateau", "run_100k_incr")
    (base_i,) = [v for k, v in incr if k == "OptimizerConfig"]
    (init_cfg,) = [v for k, v in incr if k == "dataclasses.replace"]
    (g_i,) = [v for k, v in incr if k == "synthetic.make_large_problem"]
    # one optimize of 80 iterations where the JAX script chains two of 40
    port = bench_plateau.optimizer_config("plateau-100k-revisit-incr-init")
    assert port.iterations == 2 * base_i.iterations
    _same_config(dataclasses.replace(port, iterations=base_i.iterations),
                 base_i)
    _same_config(TOpt(**dict(bench_plateau.OPT_100K,
                             **bench_plateau.INIT_OPT)), init_cfg)
    _same_graph_args(
        bench_plateau.graph_args("plateau-100k-revisit-incr-init"), g_i)
    assert bench_plateau.ROWS == (
        "plateau-10k", "plateau-10k-revisit", "plateau-100k-revisit",
        "plateau-100k-revisit-incr-init", "plateau-100k-revisit-lownoise")


def test_band100k_configs_are_the_jax_scripts():
    calls = _script_calls("exp_band100k", "main")
    graph = [v for k, v in calls if k == "synthetic.make_large_problem"]
    _same_graph_args(dict(exp_band100k.GRAPH, noise=JNoise(
        **exp_band100k.LOW_NOISE)), graph[0])
    cfgs = [v for k, v in calls if k in ("OptimizerConfig",
                                         "dataclasses.replace")]
    # grid, band, then the three replaced band rows and the tridiag grid row
    assert len(cfgs) == len(exp_band100k.ROWS)
    for name, want in zip(exp_band100k.ROWS, cfgs):
        _same_config(exp_band100k.optimizer_config(name), want, name)


def test_band100k_reads_band_chunk(monkeypatch):
    monkeypatch.setenv("BAND_CHUNK", "10")
    assert exp_band100k.optimizer_config(
        "band-100k-jacobi-cg128").pcg_fused_chunk == 10
    assert exp_band100k.optimizer_config(
        "band-100k-jacobi-cg128-cap40").pcg_fused_chunk == 20


@pytest.mark.parametrize("poses", [100_000, 1000])
def test_huge_configs_are_the_jax_scripts(poses, monkeypatch):
    monkeypatch.setenv("TOYSLAM_HUGE_POSES", str(poses))
    calls = _script_calls("bench_huge", "main")
    (graph,) = [v for k, v in calls if k == "synthetic.make_large_problem"]
    (cfg,) = [v for k, v in calls if k == "OptimizerConfig"]
    assert bench_huge.poses() == poses
    assert graph == dict(num_poses=poses, num_landmarks=poses,
                         obs_per_pose=6, seed=0)
    _same_config(bench_huge.optimizer_config(poses), cfg)


def test_fused_configs_are_the_jax_scripts():
    src = (SCRIPTS / "bench_fused.py").read_text()
    tree = ast.parse(src)
    (main,) = [n for n in tree.body if isinstance(n, ast.FunctionDef)
               and n.name == "main"]
    (assign,) = [n for n in ast.walk(main) if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", None) == "workloads"]
    workloads = {}
    for item in assign.value.elts:
        name = ast.literal_eval(item.elts[0])
        workloads[name] = eval(_segment(src, item.elts[3]))
    assert workloads == bench_fused.WORKLOADS
    (variants,) = [n for n in ast.walk(main) if isinstance(n, ast.FunctionDef)
                   and n.name == "variants"]
    (ret,) = [n for n in ast.walk(variants) if isinstance(n, ast.Return)]
    for name, kw in workloads.items():
        want = eval(_segment(src, ret.value),
                    {"OptimizerConfig": JOpt, "kw": kw})
        assert tuple(want) == bench_fused.VARIANTS
        for variant, cfg in want.items():
            _same_config(bench_fused.optimizer_config(name, variant), cfg,
                         f"{name}/{variant}")


def test_ba512_configs_are_the_jax_scripts():
    calls = _script_calls("exp_ba512", "main", {"backend": "xla"})
    (graph,) = [v for k, v in calls if k == "synthetic3d.make_ba_problem"]
    assert graph == exp_ba512.GRAPH
    probe, policy, matched = [v for k, v in calls if k == "OptimizerConfig"]
    _same_config(TOpt(**exp_ba512.PROBE), probe)
    for name in exp_ba512.ROWS:
        backend = "fused" if "-fused" in name else "xla"
        want = matched if name.endswith("-matched64") else policy
        _same_config(exp_ba512.optimizer_config(name),
                     dataclasses.replace(want, pcg_backend=backend), name)


def test_native_baseline_config_is_the_jax_scripts():
    (want,) = [v for k, v in _script_calls("measure_native_baseline", "main")
               if k == "SlamConfig"]
    got = measure_native_baseline.slam_config()
    _same_config(got.optimizer, want.optimizer)
    assert dataclasses.asdict(got.sim) == dataclasses.asdict(want.sim)


def test_gates_are_the_smokes():
    """The references these entry points hold are the ones chip_smoke.py
    holds the same paths to."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    assert exp_band100k.GRAPH == chip_smoke.BAND100K_GRAPH
    assert exp_band100k.LOW_NOISE == chip_smoke.BAND100K_NOISE
    ref = chip_smoke.BAND100K_REF
    assert (exp_band100k.REF["chi2_first"], exp_band100k.REF["chi2_final"],
            exp_band100k.REF["final_rtol"]) == (
        ref["chi2_first"], ref["chi2_final"], ref["final_rtol"])
    band = dict(chip_smoke.BAND100K_CFG)
    assert exp_band100k.optimizer_config(
        "band-100k-jacobi-cg128") == TOpt(**band)
    for case, key in (("ba512_policy", "policy"),
                      ("ba512_matched", "matched64")):
        assert exp_ba512.REF[key] == chip_smoke.BA_REF[case]["chi2"]
        assert exp_ba512.FINAL_RTOL == chip_smoke.BA_REF[case]["final_rtol"]
        assert exp_ba512.ATE_INITIAL == chip_smoke.BA_REF[case]["ate_initial"]
    assert chip_smoke.INCR100K_JAX["chi2_final"] == bench_plateau.REF[
        "plateau-100k-revisit-incr-init"]["chi2_final_jax"]


# --- run_to_plateau against the JAX script's own ----------------------------

def _jax_script(name):
    """``scripts/<name>.py`` as a module (it imports ``_bootstrap`` from its
    own directory)."""
    import importlib

    sys.path.insert(0, str(SCRIPTS))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(str(SCRIPTS))


def test_run_to_plateau_matches_the_jax_scripts(monkeypatch):
    jbp = _jax_script("bench_plateau")
    # the JAX script rounds its outputs; compare the values it rounds
    monkeypatch.setattr(jbp, "round", lambda v, n=None: v, raising=False)
    graph = dict(num_poses=200, num_landmarks=100, obs_per_pose=6, seed=0,
                 laps=2)
    opt = dict(bench_plateau.OPT_10K, iterations=4, pcg_backend="xla")
    with contextlib.redirect_stdout(io.StringIO()):
        want = jbp.run_to_plateau(
            "small", lambda: j_syn.make_large_problem(**graph), JOpt(**opt),
            200, chain=1)
    got = bench_plateau.run_to_plateau(
        "small", lambda: t_syn.make_large_problem(**graph), TOpt(**opt),
        200, torch.device("cpu"))
    assert got["iterations_run"] == want["iterations_run"] == 4
    np.testing.assert_allclose(got["chi2_curve"], want["chi2_curve"],
                               rtol=1e-4)
    assert got["iters_to_plateau"] == want["iters_to_plateau"]
    np.testing.assert_allclose(got["chi2_at_ground_truth"],
                               want["chi2_at_ground_truth"], rtol=1e-5)
    assert abs(got["ate_rmse"] - want["ate_rmse"]) <= 1e-3
    assert abs(got["ate_dead_reckoning"] - want["ate_dead_reckoning"]) <= 1e-4
    assert got["pcg_iters"] == list(want["pcg_iters"])
    assert got["solver_mode"] is None
    assert set(want) - {"platform"} <= set(got)


# --- each entry point on the CPU --------------------------------------------

def _record_hashes() -> dict:
    paths = sorted(ROOT.glob("BENCH_*.json")) + [
        ROOT / "BASELINE_MEASURED.json"]
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in paths}


@pytest.fixture(scope="module")
def cpu_runs():
    """Every entry point once at its small size: ``{name: (exit code, the
    JSON objects it printed)}``, with the records' hashes before and
    after."""
    before = _record_hashes()
    old = os.environ.get("TOYSLAM_HUGE_POSES")
    os.environ["TOYSLAM_HUGE_POSES"] = HUGE_POSES
    runs = {}
    try:
        for name, module in MODULES.items():
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                code = module.main([*SMALL[name], "--device", "cpu"])
            runs[name] = (code, [json.loads(line) for line in
                                 buf.getvalue().splitlines()
                                 if line.startswith("{")])
    finally:
        if old is None:
            os.environ.pop("TOYSLAM_HUGE_POSES")
        else:
            os.environ["TOYSLAM_HUGE_POSES"] = old
    return runs, before, _record_hashes()


def _jax_keys(name: str) -> list[tuple[str, set, str]]:
    """The keys of the JAX twin's output, from the JAX package's recorded
    run (rows the script writes; ``edge_backend`` and the TPU's
    ``vpu_peak_fraction`` are not ported): ``(what, keys, row kind)``."""
    rec = json.loads((ROOT / {
        "bench_plateau": "BENCH_PLATEAU.json",
        "exp_band100k": "BENCH_BAND100K.json",
        "bench_huge": "BENCH_HUGE.json",
        "bench_fused": "BENCH_FUSED.json",
        "exp_ba512": "BENCH_BA512.json",
        "measure_native_baseline": "BASELINE_MEASURED.json",
    }[name]).read_text())
    if name == "bench_plateau":
        return [("row", set(c), c["config"]) for c in rec["configs"]]
    if name == "exp_band100k":
        rows = [c for c in rec["configs"] if c["config"] in (
            "grid-100k-jacobi-cg128", "band-100k-jacobi-cg128",
            "band-100k-jacobi-cg128-cap30", "grid-100k-tridiag-cg128")]
        summary = set(rec) - {"measured_at", "device", "note", "configs",
                              "speedup_vs_round4_baseline_gn_rate",
                              "wall_to_plateau_band_vs_grid"}
        return [("row", set(c), c["config"]) for c in rows] + [
            ("summary", summary, ""),
            ("band_layout", set(rec["band_layout"]), "")]
    if name == "bench_huge":
        return [("row", set(rec["config"]) - {"edge_backend",
                                              "vpu_peak_fraction"}, "")]
    if name == "bench_fused":
        return [("row", set(c), c["solver"]) for c in rec["results"]
                if c["config"] == "reference-150"]
    if name == "exp_ba512":
        return [("row", set(c), c["config"]) for c in rec["configs"]] + [
            ("summary", set(rec) - {"measured_at", "device", "note",
                                    "configs"}, "")]
    nc = rec["native_cpu"]
    return [("native_cpu", set(nc), ""),
            ("threads", set(nc["1_thread"]), "")]


def _objects(name, printed):
    """The printed objects by what they are."""
    if name == "measure_native_baseline":
        (nc,) = [o["native_cpu"] for o in printed if "native_cpu" in o]
        return {"native_cpu": [nc], "threads": [nc["1_thread"],
                                                nc["all_threads"]]}
    rows = [o for o in printed if "config" in o]
    summary = [o for o in printed if "speedup_policy" in o
               or "chi2_match_rel" in o]
    return {"row": rows, "summary": summary,
            "band_layout": [s["band_layout"] for s in summary]}


@pytest.mark.parametrize("name", list(MODULES))
def test_entry_point_on_the_cpu(name, cpu_runs):
    runs, _, _ = cpu_runs
    code, printed = runs[name]
    assert code == 0, printed
    objs = _objects(name, printed)
    for what, keys, kind in _jax_keys(name):
        assert objs[what], (what, kind)
        for obj in objs[what]:
            if what == "row" and name == "bench_plateau":
                if kind != obj["config"]:
                    continue
            assert keys <= set(obj), (what, kind, sorted(keys - set(obj)))
    for row in objs.get("row", []):
        assert row["kernel_launches"] == {"fused_pcg_chunk": 0,
                                          "band_fused_pcg_chunk": 0}
        assert row["gate"]["ok"], row["gate"]
        assert (row["platform"], row["card"]) == ("cpu", None)


def test_entry_points_print_every_row(cpu_runs):
    runs, _, _ = cpu_runs
    names = {n: [o.get("config") for o in printed if "config" in o]
             for n, (_, printed) in runs.items()}
    assert names["bench_plateau"] == list(bench_plateau.ROWS)
    assert names["exp_band100k"] == list(exp_band100k.ROWS)
    assert names["bench_huge"] == [f"huge-{int(HUGE_POSES) // 1000}k"]
    assert names["bench_fused"] == ["reference-150"] * len(
        bench_fused.VARIANTS)
    assert names["exp_ba512"] == list(exp_ba512.ROWS)
    (layout,) = [o for o in runs["exp_band100k"][1] if "host_grid_plan_s"
                 in o]
    lay = layout["band_layout"]
    assert lay["port_stack_bytes"] > 0 and lay["band_device_bytes"] > \
        lay["port_stack_bytes"]


def test_no_run_writes_a_record(cpu_runs):
    _, before, after = cpu_runs
    assert before == after


@pytest.mark.parametrize("name", list(MODULES))
def test_entry_point_without_a_card_refuses(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    buf = io.StringIO()
    err = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        code = MODULES[name].main([])
    assert code == 2 and buf.getvalue() == ""
    assert "no CUDA device" in err.getvalue()


def test_bench_fused_exits_non_zero_when_a_variant_raises(monkeypatch):
    """The JAX script keeps its sweep alive past a failing variant; the
    port's run ends non-zero."""
    def boom(*args, **kw):
        raise RuntimeError("variant failed")

    monkeypatch.setattr(bench_fused, "bench_variant", boom)
    with pytest.raises(RuntimeError, match="variant failed"):
        bench_fused.main(["--device", "cpu", "--workloads", "reference-150"])
