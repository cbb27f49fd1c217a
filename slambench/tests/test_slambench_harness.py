"""The harness on the CPU: each cell's set-up and a short window through
the kernels' plain versions, the result line's keys, a cell (with its
configuration, graph kind, driver and metrics) added as files alone, and
the comparison failing when the timed path is broken.

These tests skip the harness's look for a chip (``run.run`` with a CPU
device); the 10k configuration runs on a 2,100-pose serpentine graph, the
150-pose one on a pool of two graphs.
"""

import dataclasses
import io
import json
import re
import shutil
from pathlib import Path

import pytest
import torch

from slambench import calibrate, cells, run

ROOT = Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]
SMALL = {"sparse-10k": {"num_poses": 2100, "num_landmarks": 2100},
         "toyslam-150": {"pool": 2}}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _cell(name: str, root: Path = ROOT):
    c = cells.cell(name, root)
    small = SMALL.get(c.config["name"])
    return c._replace(graph={**c.graph, **small}) if small else c


def _run(c, seed=None, traced=False, fault="none"):
    out = io.StringIO()
    seed = 11 if seed is None else seed
    rc = run.run(c, seed, 0.05, traced, torch.device("cpu"), fault=fault,
                 out=out)
    assert rc == 0
    lines = out.getvalue().strip().splitlines()
    return json.loads(lines[-2]), json.loads(lines[-1])


@pytest.mark.parametrize("name", ["toyslam-150.batch", "sparse-10k.batch",
                                  "toyslam-150.remote"])
def test_a_run_prints_the_contracts_result(name):
    c = _cell(name)
    counts, result = _run(c)
    assert list(result) == KEYS + ["host", "compared"]
    assert result["correct"] is True
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {m["name"] for m in c.end_to_end}
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert set(result["compared"]) == set(c.config["correct"])
    assert result["device"]["count"] == 1
    assert set(counts) == {"calls", "launches_per_call"}
    assert cells.forbidden_modules() == []
    host = result["host"]
    assert host["loop_before_s"] > 0 and host["loop_after_s"] > 0
    assert host["window_cpu_s"] >= 0


def test_a_traced_run_reads_the_per_layer_metrics():
    c = _cell("toyslam-150.batch")
    _, result = _run(c, traced=True)
    assert list(result) == KEYS + ["breakdown", "host", "compared"]
    assert result["metrics"]["pcg_iters_per_gn.solve"]["value"] > 0
    dev = result["device"]
    assert dev["window_s"] > 0 and "busy_s" in dev
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_traced_remote_run_reads_the_servers_timings():
    _, result = _run(_cell("toyslam-150.remote"), traced=True)
    m = result["metrics"]
    assert m["wire_ms.request"]["value"] > 0
    assert m["server_layout_ms.request"]["value"] > 0


def test_a_cell_added_as_files_alone_is_found_by_name(tmp_path):
    """A configuration, a graph kind, a traffic mix with a driver of its
    own, an end-to-end metric and a per-layer metric added as new files
    and ``BENCHMARK.json`` entries run without an edit to any file."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "slambench", tmp_path / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    base = json.loads((ROOT / "slambench/configs/toyslam-150.json")
                      .read_text())
    config = {**base, "name": "toyslam-40",
              "graph": {**base["graph"], "kind": "short_robot",
                        "robot_steps": 40}}
    (tmp_path / "slambench/configs/toyslam-40.json").write_text(
        json.dumps(config))
    (tmp_path / "slambench/graphs/short_robot.py").write_text(
        "from slambench.generators import robot\n"
        "def generate(seed, **params):\n"
        "    return robot(seed, **params)\n")
    (tmp_path / "slambench/drivers/per_second.py").write_text(
        "from pathlib import Path\n"
        "from slambench import cells\n"
        "ROOT = Path(__file__).resolve().parents[2]\n"
        "class Driver(cells.load('drivers', 'batch', ROOT).Driver):\n"
        "    def end_to_end(self, times, window_s):\n"
        "        return {'solves_per_s': len(times) / window_s}\n")
    (tmp_path / "slambench/traffic/twice.json").write_text(json.dumps(
        {"driver": "per_second", "warmup_calls": 1, "trace_seconds": 0.05}))
    (tmp_path / "slambench/metrics/iterations_run.solve.py").write_text(
        "def read(readings):\n"
        "    return float(sum(i for _, i in readings.counters))\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "toyslam-40", "source": base["source"],
        "file": "slambench/configs/toyslam-40.json",
        "reduced": ["robot_steps"], "why": "a test"})
    bench["workloads"].append({
        "name": "toyslam-40.twice", "config": "toyslam-40",
        "traffic": "twice", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({
        "name": "solves_per_s", "unit": "1/s", "better": "higher",
        "bound": 0.05, "source": "host_clock",
        "workloads": ["toyslam-40.twice"]})
    bench["per_layer"].append({
        "name": "iterations_run.solve", "unit": "iters", "better": "lower",
        "source": "program_counter", "layer": "optimizer.gauss_newton",
        "moves": "solves_per_s", "workloads": ["toyslam-40.twice"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    c = cells.cell("toyslam-40.twice", tmp_path)
    assert c.graph["robot_steps"] == 40 and c.traffic["warmup_calls"] == 1
    _, result = _run(c)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"solves_per_s", "setup_s"}
    _, result = _run(c, traced=True)
    assert result["correct"] is True
    assert result["metrics"]["iterations_run.solve"]["value"] > 0
    assert "b1_roofline" not in result["metrics"]


def test_a_launch_the_trace_cannot_see_fails_the_traced_run(monkeypatch):
    """A kernel launch that the program counts but that does not pass the
    wrapped chunk loop (a loop renamed or fused away) stops the run rather
    than leave the rooflines silent."""
    from toyslam_torch.ops import fused_pcg as fp
    from toyslam_torch.optimizer.gauss_newton import GaussNewton

    monkeypatch.setattr(fp.fused_pcg_chunk, "launches",
                        fp.fused_pcg_chunk.launches)
    optimize = GaussNewton.optimize

    def counted(self, graph):
        fp.fused_pcg_chunk.launches += 1
        return optimize(self, graph)

    monkeypatch.setattr(GaussNewton, "optimize", counted)
    with pytest.raises(RuntimeError, match="0 recorded"):
        _run(_cell("toyslam-150.batch"), traced=True)


def _half_the_observations(graph):
    """The graph with every observation of the odd landmarks left out, in
    the edge list and in the grid solver's copies of it."""
    from toyslam_torch.ops.grid_schur import GridPlan

    def keep(mask, lm):
        return mask * (lm % 2 == 0).to(mask.dtype)

    edges = graph.lm_edges
    graph = dataclasses.replace(graph, lm_edges=dataclasses.replace(
        edges, mask=keep(edges.mask, edges.lm)))
    if isinstance(graph.plan, GridPlan):
        gp = graph.plan
        graph = dataclasses.replace(graph, plan=dataclasses.replace(
            gp, L_mask=keep(gp.L_mask, gp.L_lm),
            P_mask=keep(gp.P_mask, gp.P_lm)))
    return graph


def _broken(monkeypatch, how):
    from toyslam_torch import config
    from toyslam_torch.ops import se2
    from toyslam_torch.optimizer.gauss_newton import GaussNewton

    if how in calibrate.FAULTS:
        # the program's own options changed under it: its GN loop stopped
        # early, or its preconditioner never refreshed
        options = config.OptimizerConfig
        monkeypatch.setattr(config, "OptimizerConfig", lambda **kw: options(
            **{**kw, **calibrate.FAULTS[how]}))
        return
    if how == "unchanged":
        # each GN step returns its state unchanged
        monkeypatch.setattr(se2, "retract", lambda pose, delta: pose)
        return
    optimize = GaussNewton.optimize

    def broken(self, graph):
        if how == "half":
            return optimize(self, _half_the_observations(graph))
        res = optimize(self, graph)
        poses = res.graph.poses.clone()
        poses[poses.shape[0] // 4, 1] += 0.5
        return res._replace(graph=res.graph.with_state(
            poses, res.graph.landmarks))

    monkeypatch.setattr(GaussNewton, "optimize", broken)


# A step that returns its state unchanged, half of the observations left
# out, and an answer altered where it is produced (one pose of the result
# moved); for the 10k configuration also a GN loop stopped early and a
# preconditioner never refreshed.  The 10k configuration's final state
# swings with rounding where 15 steps do not converge, so its limits there
# are loose and one moved pose stays inside them (PERF.md).  At this
# test's 2,100 poses a preconditioner from the start stays closer to the
# later steps' than at 10k: it reads above the limit on seeds 1, 4 and 7
# of nine tried here, and on every seed at the cell's size (PERF.md).
@pytest.mark.parametrize("name,how,seed", [
    ("toyslam-150.batch", "unchanged", 11), ("toyslam-150.batch", "half", 11),
    ("toyslam-150.batch", "alter", 11), ("sparse-10k.batch", "unchanged", 11),
    ("sparse-10k.batch", "half", 11), ("sparse-10k.batch", "stop_after_2", 11),
    ("sparse-10k.batch", "stop_after_10", 11),
    ("sparse-10k.batch", "no_refresh", 1)])
def test_a_broken_solve_is_not_correct(monkeypatch, name, how, seed):
    _broken(monkeypatch, how)
    _, result = _run(_cell(name), seed)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"]
               for c in result["compared"].values())


@pytest.mark.parametrize("fault", ["unchanged", "alter"])
def test_a_broken_server_is_not_correct(fault):
    _, result = _run(_cell("toyslam-150.remote"), fault=fault)
    assert result["correct"] is False


def test_the_benchmark_file_keeps_the_contract():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    assert 1 <= bench["run_seconds"] <= 51
    configs = {c["name"]: c for c in bench["configs"]}
    work = {w["name"]: w for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert len(configs) == len(bench["configs"])
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert name.match(c["name"]) and 1 <= len(c["source"]) <= 200
        assert c["file"].startswith("slambench/")
        assert len(c["reduced"]) <= 16
        assert all(name.match(k) for k in c["reduced"])
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
        assert any(w["config"] == c["name"] for w in work.values())
    four = sum(w["chips"] == 4 for w in work.values())
    assert four <= max(1, len(work) // 4)
    pairs = {(w["config"], w["traffic"]) for w in work.values()}
    assert len(pairs) == len(work)
    for w in work.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert name.match(w["name"]) and w["chips"] in (1, 4)
        assert w["config"] in configs and len(w["why"]) <= 200
        assert (ROOT / "slambench/traffic" / f"{w['traffic']}.json").exists()
        reported = [m for m in e2e.values()
                    if w["name"] in m.get("workloads", work)]
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2
        assert any(w["name"] in m["workloads"] for m in bench["per_layer"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert unit.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert name.match(m["name"]) and unit.match(m["unit"])
        assert m["moves"] in e2e
        assert all(w in e2e[m["moves"]].get("workloads", work)
                   for w in m["workloads"])
        assert (ROOT / "slambench/metrics" / f"{m['name']}.py").exists()
