"""The harness on the CPU: each cell's set-up and a short window through
the kernels' plain versions, the result line's keys, a cell (with its
configuration, graph kind, driver and metrics) and a family added as files
alone, the SE(2) family judging as the reference and ``check.gaps`` do
directly, and the comparison failing when the timed path is broken.

These tests skip the harness's look for a chip (``run.run`` with a CPU
device); the 10k configuration runs on a 2,100-pose serpentine graph, the
150-pose one on a pool of two graphs.
"""

import dataclasses
import io
import json
import math
import re
import shutil
from pathlib import Path

import pytest
import torch

from slambench import calibrate, cells, check, reference, run

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
    # a CPU run has no device, so a metric of the device's trace reads 0
    for m in c.end_to_end:
        value = result["metrics"][m["name"]]["value"]
        assert value > 0 if m["source"] == "host_clock" else value == 0
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
    assert m["request_ms.wall"]["value"] > 0
    assert m["request_ms_p90.wall"]["value"] > 0


def test_an_untraced_remote_run_profiles_each_graph_once_after_it(
        monkeypatch):
    """The server profiles one request of each graph of the pool once the
    window has closed; the window's server timings leave them out."""
    c = _cell("toyslam-150.remote")
    seen = {}

    class Driver(cells.driver(c)):
        def close(self, readings):
            record = super().close(readings)
            seen.update(profiled=len(self.work_s),
                        window=len(readings.server_window),
                        calls=len(self.answers) - self.n_warm)
            return record

    monkeypatch.setattr(cells, "driver", lambda cell: Driver)
    _, result = _run(c)
    assert seen["profiled"] == c.graph["pool"] == 2
    assert seen["calls"] == seen["window"] + 2 == result["attempted"] + 2
    assert result["metrics"]["device_ms.request"]["value"] == 0


def _copy_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "slambench", tmp_path / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return json.loads((ROOT / "slambench/configs/toyslam-150.json")
                      .read_text())


def test_a_cell_added_as_files_alone_is_found_by_name(tmp_path):
    """A configuration, a graph kind, a traffic mix with a driver of its
    own, an end-to-end metric and a per-layer metric added as new files
    and ``BENCHMARK.json`` entries run without an edit to any file."""
    base = _copy_benchmark(tmp_path)
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


# a family added as a file: the SE(2) family's parts, each call logged
# beside the file, and its own number ``twin_gap`` (PLANT) among those
# compared
TWIN = """
from pathlib import Path
from slambench import cells

se2 = cells.load("families", "se2", Path(__file__).resolve().parents[2])
REFERENCE, CONTROL, FLOAT32 = se2.REFERENCE, se2.CONTROL, se2.FLOAT32
PLANT = {plant}


def _log(what):
    with open(Path(__file__).with_suffix(".log"), "a") as f:
        f.write(what + "\\n")


def program_graph(arrays):
    _log("program_graph")
    return se2.program_graph(arrays)


def optimize(arrays, opt, device, precision):
    _log("optimize " + str(precision.dtype))
    return se2.optimize(arrays, opt, device, precision)


def gaps(*args):
    _log("gaps")
    return {{**se2.gaps(*args), "twin_gap": PLANT}}
"""


def _twin_cell(tmp_path, plant=0.0):
    """``toyslam-40.batch``, a 40-step robot judged by ``se2_twin``, a
    family added as a file, with ``plant`` as its own number."""
    families = tmp_path / "slambench/families"
    if not (tmp_path / "BENCHMARK.json").exists():
        base = _copy_benchmark(tmp_path)
        config = {**base, "name": "toyslam-40", "family": "se2_twin",
                  "graph": {**base["graph"], "robot_steps": 40, "pool": 2},
                  "correct": {**base["correct"], "twin_gap": 0.5}}
        (tmp_path / "slambench/configs/toyslam-40.json").write_text(
            json.dumps(config))
        bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
        bench["configs"].append({
            "name": "toyslam-40", "source": base["source"],
            "file": "slambench/configs/toyslam-40.json",
            "reduced": ["robot_steps"], "why": "a test"})
        bench["workloads"].append({
            "name": "toyslam-40.batch", "config": "toyslam-40",
            "traffic": "batch", "chips": 1, "why": "a test"})
        (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (families / "se2_twin.py").write_text(TWIN.format(plant=plant))
    (families / "se2_twin.log").write_text("")
    return cells.cell("toyslam-40.batch", tmp_path)


def _twin_log(tmp_path):
    return (tmp_path / "slambench/families/se2_twin.log").read_text().split(
        "\n")[:-1]


def test_a_family_added_as_a_file_alone_judges_its_cell(tmp_path):
    """A configuration naming a family that is a new file runs through the
    batch driver and ``run.run`` as they are: the family builds the
    program's graphs and solves the reference, and its own numbers decide
    ``correct``; a fault planted in them reads not correct."""
    c = _twin_cell(tmp_path)
    assert c.family == "se2_twin"
    _, result = _run(c)
    assert result["correct"] is True
    assert result["compared"]["twin_gap"] == {"value": 0.0, "limit": 0.5}
    log = _twin_log(tmp_path)
    assert log.count("program_graph") == 2          # the pool's two graphs
    assert log.count("optimize torch.float64") == 2
    assert log.count("gaps") == 2

    _, result = _run(_twin_cell(tmp_path, plant=1.0))
    assert result["correct"] is False
    assert result["compared"]["twin_gap"] == {"value": 1.0, "limit": 0.5}
    assert result["compared"]["state_gap"]["value"] <= 5e-4


def test_calibration_reads_through_the_configurations_family(tmp_path):
    c = _twin_cell(tmp_path)
    rows = calibrate.readings(c, [5], torch.device("cpu"), control=True,
                              f32=True, out=io.StringIO())
    row = rows[0]
    assert {"program", "control", "float32"} <= set(row)
    assert all(row[k]["twin_gap"] == 0.0
               for k in ("program", "control", "float32"))
    log = _twin_log(tmp_path)
    # the driver's pool (two graphs) and the seed's graph
    assert log.count("program_graph") == 3
    assert log.count("optimize torch.float64") == 1     # the reference
    assert log.count("optimize torch.float32") == 2     # control, float32
    assert log.count("gaps") == 3
    # the control fails the configuration's limits, the program does not
    assert check.judge(row["program"], c.config["correct"])[0]
    assert not check.judge(row["control"], c.config["correct"])[0]


def _direct_worst_over_pool(problems, opt, answers, device):
    """The comparison as it was made before families: the SE(2) reference
    and ``check.gaps`` called directly."""
    worst: dict = {}
    for i, problem in enumerate(problems):
        mine = [a[1:] for a in answers if a[0] == i]
        if not mine:
            continue
        g = problem["graph"]
        ref = reference.optimize(g, opt, device)
        got = check.gaps(g, problem["n_poses"], problem["n_landmarks"], opt,
                         ref, mine, device)
        got.pop("steps", None)
        worst = {k: max(worst.get(k, -math.inf), v) for k, v in got.items()}
    return worst


@pytest.mark.parametrize("name", ["toyslam-150.batch", "sparse-10k.batch"])
def test_the_se2_family_compares_as_the_direct_path(name):
    """On the same answers of the program (``schur`` at 150 poses, a pool of
    two; ``schur_grid`` at 2,100 poses), ``families/se2`` gives the same
    numbers, value for value, as the reference and ``check.gaps`` called
    directly."""
    c = _cell(name)
    assert c.family == "se2"
    cpu = torch.device("cpu")
    driver = cells.driver(c)(c, 11, cpu)
    for _ in driver.graphs:
        driver.call()
    driver.close(run.Readings())
    opt = c.config["optimizer"]
    got = check.worst_over_pool(cells.family(c), driver.problems, opt,
                                driver.answers, cpu)
    want = _direct_worst_over_pool(driver.problems, opt, driver.answers, cpu)
    assert got == want
    assert set(c.config["correct"]) <= set(got)


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
