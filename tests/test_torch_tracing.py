"""The port's spans (``toyslam_torch/tracing.py``) and the benchmark's
readers of them, on the CPU:

* with no profiler running a whole optimize constructs no
  ``record_function``;
* under ``slambench.trace.profiled`` one optimize gives one
  ``toyslam.gn.optimize`` span, one ``toyslam.gn.iteration`` span per GN
  iteration, and each iteration's phase spans inside it in order (the
  refresh's assembly inside its ``ops.precond``);
* the PCG chunk loop (``fused_pcg._chunked_pcg``), rebound as the traced
  benchmark rebinds it, is called once per ``ops.pcg`` span and as often
  with the profiler on as off, in the resident mode and in the band mode
  of ``schur_grid``;
* the five span readers of ``slambench/metrics/`` on a hand-built trace
  with known answers, and None where a trace has no program spans;
* a traced run of each batch cell at the harness tests' small sizes
  reports the three host-time readers and omits the two that need a
  device.
"""

import functools
import io
import json

import pytest
import torch

from slambench import cells, run, spans, trace
from toyslam_torch import tracing
from toyslam_torch.config import OptimizerConfig, SimConfig, SlamConfig
from toyslam_torch.ops import fused_pcg as fp
from toyslam_torch.optimizer import GaussNewton
from toyslam_torch.sim import frontend, synthetic, synthetic3d

CPU = torch.device("cpu")
ROBOT = dict(iterations=4, lr=0.2, solver="schur", pcg_precond="tridiag",
             pcg_fused_chunk=16)
# the 10k configuration's solver (slambench/configs/sparse-10k.json)
GRID = dict(iterations=4, lr=1.0, solver="schur_grid",
            exact_odom_jacobians=True, pcg_tol=1e-2, pcg_max_iters=15,
            pcg_restart_every=15, pcg_precond="tridiag+coarse",
            pcg_coarse_group=32, pcg_precond_refresh=2, pcg_fused_chunk=15)
# the SE(3) configuration's solver (slambench/configs/ba3d-512x4096.json)
BA = dict(iterations=4, lr=1.0, solver="schur3d", exact_odom_jacobians=True,
          huber_delta=4.0, pcg_tol=1e-6, pcg_max_iters=200,
          convergence_eps=1e-8, reject_worse_steps=True,
          pcg_precond="tridiag", pcg_fused_chunk=16)
CASES = {
    "schur": (ROBOT, "robot"),
    "schur-refresh": ({**ROBOT, "pcg_precond_refresh": 2}, "robot"),
    "schur-plain": ({**ROBOT, "pcg_backend": "xla"}, "robot"),
    "schur_grid": (GRID, "grid"),
    "schur3d": (BA, "ba"),
}
# the harness tests' small sizes (slambench/tests/test_slambench_harness.py),
# the SE(3) one at 16 cameras x 64 points
SMALL = {"sparse-10k": {"num_poses": 2100, "num_landmarks": 2100},
         "toyslam-150": {"pool": 2},
         "ba3d-512x4096": {"num_poses": 16, "num_landmarks": 64, "pool": 2}}
BATCH = ["toyslam-150.batch", "sparse-10k.batch", "sparse-10k.revisit",
         "ba3d-512x4096.batch"]
# what a cell reads besides the three phases
OWN = {"ba3d-512x4096.batch": "edges3d_ms.solve"}
PHASES = ["ops.assemble", "ops.eliminate", "ops.pcg", "ops.backsub",
          "gn.update"]


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


@functools.cache
def _graph(kind):
    if kind == "robot":
        sim = frontend.simulate(SimConfig(robot_steps=40))
        return frontend.build_graph(sim, SlamConfig())[0]
    if kind == "ba":
        return synthetic3d.make_ba_problem(16, 64, 24, seed=0)[0]
    if kind == "grid":
        return synthetic.make_large_problem(
            num_poses=300, num_landmarks=300, obs_per_pose=5, seed=2,
            pose_bucket=64, landmark_bucket=64, edge_bucket=256)[0]
    # a layout on which the grid solver takes B2
    return synthetic.make_large_problem(
        num_poses=2100, num_landmarks=2100, obs_per_pose=6, seed=0)[0]


def _solver(case):
    opt, kind = CASES[case]
    gn = GaussNewton(OptimizerConfig(**opt))
    return gn, gn._prepare(_graph(kind))


def _short(name):
    return name[len(spans.PREFIX):]


def _children(parent, all_spans):
    """The spans directly inside ``parent``, in order."""
    inner = [x for x in all_spans if x is not parent
             and parent[1] <= x[1] and x[2] <= parent[2]]
    return [x for x in inner
            if not any(o is not x and o[1] <= x[1] and x[2] <= o[2]
                       for o in inner)]


@pytest.mark.parametrize("case", list(CASES))
def test_no_profiler_constructs_no_record_function(monkeypatch, case):
    def refuse(*args, **kw):
        raise AssertionError("record_function with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    gn, g = _solver(case)
    res = gn.optimize(g)
    assert res.iterations_run > 0
    assert torch.isfinite(res.graph.poses).all()


@pytest.mark.parametrize("case", list(CASES))
def test_spans_nest_by_phase(case):
    gn, g = _solver(case)
    with trace.profiled(CPU) as held:
        res = gn.optimize(g)
    tr = held.trace
    all_spans = spans.program_spans(tr)
    optimize = [x for x in all_spans if x[0] == spans.OPTIMIZE]
    assert len(optimize) == 1
    top = _children(optimize[0], all_spans)
    iterations = [x for x in top if x[0] == spans.ITERATION]
    assert len(iterations) == res.iterations_run
    refresh = gn.config.pcg_precond_refresh
    stateful = refresh != 1
    # a stateful solve builds its first preconditioner before the loop
    assert [_short(x[0]) for x in top] == (
        ["ops.precond"] * stateful + ["gn.iteration"] * res.iterations_run)
    for i, it in enumerate(iterations):
        got = [_short(x[0]) for x in _children(it, all_spans)]
        if not stateful:
            want = PHASES[:2] + ["ops.precond"] + PHASES[2:]
        elif refresh > 1 and i % refresh == 0 and i > 0:
            want = ["ops.precond"] + PHASES
        else:
            want = PHASES
        assert got == want, (i, got)
    for pre in (x for x in all_spans if x[0] == "toyslam.ops.precond"):
        inner = [_short(x[0]) for x in _children(pre, all_spans)]
        # the refresh assembles again; a fresh solve's build does not
        assert inner in ([], ["ops.assemble"])
    assert sum(x[0] == "toyslam.ops.assemble" for x in all_spans) == (
        res.iterations_run + stateful
        + (res.iterations_run - 1) // refresh * (refresh > 1))


@pytest.mark.parametrize("case,kind,chunk", [
    ("schur", "robot", "fused_pcg_chunk"),
    ("schur_grid", "band", "band_fused_pcg_chunk"),
])
def test_the_chunk_loop_is_called_once_per_pcg_span(monkeypatch, case,
                                                    kind, chunk):
    """The traced benchmark rebinds ``fused_pcg._chunked_pcg`` to record
    every launch; a span that hid the loop from the rebinding, or called
    it twice, would break that count on the card."""
    opt = {**CASES[case][0], "iterations": 2, "pcg_backend": "fused"}
    gn = GaussNewton(OptimizerConfig(**opt))
    g = gn._prepare(_graph(kind))
    calls = []
    saved = fp._chunked_pcg

    def counting(chunk_fn, *args, **kw):
        calls.append(chunk_fn)
        return saved(chunk_fn, *args, **kw)

    monkeypatch.setattr(fp, "_chunked_pcg", counting)
    off = gn.optimize(g)
    n_off = len(calls)
    with trace.profiled(CPU) as held:
        on = gn.optimize(g)
    n_on = len(calls) - n_off
    assert n_off == off.iterations_run == on.iterations_run == n_on
    assert spans.count(held.trace, "toyslam.ops.pcg") == n_on
    assert all(c is getattr(fp, chunk) for c in calls)


# a hand-built traced window of two solves of one GN iteration each, 1 s
# apart; in each (seconds from the solve's start):
#   gn.optimize [0.1, 0.9] > gn.iteration [0.15, 0.85] >
#     ops.precond [0.2, 0.4] > ops.assemble [0.25, 0.3]
#     ops.assemble [0.4, 0.5], ops.pcg [0.5, 0.7], gn.update [0.7, 0.8]
#   cudaStreamSynchronize at 0.6 and 0.75 (in the solve), 0.95 (after it)
#   idle gaps (start, length): (0.1, 0.05) in the solve's set-up,
#   (0.26, 0.02) in the refresh's assembly, (0.55, 0.1) in the PCG,
#   (0.8, 0.05) in the iteration after its update, (0.9, 0.1) between
#   solves: 0.32 s idle, 0.2 s of it outside the phase spans
_SOLVE = [("toyslam.gn.optimize", 0.1, 0.8),
          ("toyslam.gn.iteration", 0.15, 0.7),
          ("toyslam.ops.precond", 0.2, 0.2),
          ("toyslam.ops.assemble", 0.25, 0.05),
          ("toyslam.ops.assemble", 0.4, 0.1),
          ("toyslam.ops.pcg", 0.5, 0.2),
          ("aten::mul", 0.52, 0.01),
          ("cudaStreamSynchronize", 0.6, 0.01),
          ("toyslam.gn.update", 0.7, 0.1),
          ("cudaStreamSynchronize", 0.75, 0.01),
          ("cudaStreamSynchronize", 0.95, 0.01)]
_GAPS = [(0.1, 0.05), (0.26, 0.02), (0.55, 0.1), (0.8, 0.05), (0.9, 0.1)]
WANT = {"assemble_ms.solve": 150.0, "precond_ms.solve": 150.0,
        "pcg_ms.solve": 200.0, "host_syncs_per_gn.solve": 2.0,
        "idle_unattributed_pct.solve": 62.5}


def _trace(device=True, program=True):
    hosts = [(n, s + k, d) for k in (0.0, 1.0) for n, s, d in _SOLVE
             if program or not n.startswith(spans.PREFIX)]
    gaps = [(s + k, d) for k in (0.0, 1.0) for s, d in _GAPS]
    busy = 2.0 - sum(d for _, d in gaps)
    dev = [("kernel", 0.0, 0.1), ("kernel", 1.0, 0.1)] if device else []
    return trace.Trace(window_s=2.0, busy_s=busy if device else 0.0,
                       device=dev, host=hosts,
                       gaps=gaps if device else [])


def _read(metric, tr):
    readings = run.Readings()
    readings.trace = tr
    return cells.reader(metric)(readings)


@pytest.mark.parametrize("metric", list(WANT))
def test_a_span_reader_on_a_hand_built_trace(metric):
    assert _read(metric, _trace()) == pytest.approx(WANT[metric], rel=1e-9)
    assert _read(metric, _trace(program=False)) is None
    assert _read(metric, None) is None
    no_device = _read(metric, _trace(device=False))
    if metric in ("host_syncs_per_gn.solve", "idle_unattributed_pct.solve"):
        assert no_device is None
    else:
        assert no_device == pytest.approx(WANT[metric], rel=1e-9)


def test_self_time_takes_the_union_of_nested_spans():
    tr = _trace()
    got = spans.self_seconds(tr)
    want = {"toyslam.gn.optimize": 0.1, "toyslam.gn.iteration": 0.1,
            "toyslam.ops.precond": 0.15, "toyslam.ops.assemble": 0.15,
            "toyslam.ops.pcg": 0.2, "toyslam.gn.update": 0.1}
    assert set(got) == set(want)
    for name, seconds in want.items():
        assert got[name] == pytest.approx(2 * seconds, abs=1e-9)
    # spans over one another's ends (another thread) count their overlap once
    over = trace.Trace(1.0, 0.0, [], [("toyslam.a", 0.0, 0.5),
                                      ("toyslam.b", 0.1, 0.2),
                                      ("toyslam.c", 0.2, 0.2)], [])
    assert spans.self_seconds(over)["toyslam.a"] == pytest.approx(0.2)


@pytest.mark.parametrize("name", BATCH)
def test_a_traced_batch_run_reports_the_host_phases(monkeypatch, name):
    # this test process holds JAX for the other tests' references; the
    # check that a run loads none is slambench's own test
    monkeypatch.setattr(cells, "forbidden_modules", lambda: [])
    c = cells.cell(name)
    c = c._replace(graph={**c.graph, **SMALL[c.config["name"]]},
                   traffic={**c.traffic, "trace_seconds": 0.05})
    out = io.StringIO()
    assert run.run(c, 11, 0.05, True, CPU, out=out) == 0
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert result["correct"] is True
    metrics = result["metrics"]
    for metric in ("assemble_ms.solve", "precond_ms.solve", "pcg_ms.solve",
                   *OWN.get(name, "").split()):
        assert metrics[metric]["value"] > 0
        assert metrics[metric]["unit"] == "ms"
    assert set(OWN.values()) & set(metrics) == set(OWN.get(name, "").split())
    assert "host_syncs_per_gn.solve" not in metrics
    assert "idle_unattributed_pct.solve" not in metrics


def test_se3_spans():
    """An SE(3) solve records its assembly as ``ops.assemble``, and the
    edges inside it and inside each step rejection's chi^2 as
    ``ops.edges3d``; with no profiler the span is the shared null
    context."""
    assert tracing.span("toyslam.ops.edges3d") is tracing._NULL
    gn = GaussNewton(OptimizerConfig(**BA))
    laid = gn._prepare(_graph("ba"))
    with trace.profiled(CPU) as held:
        res = gn.optimize(laid)
    all_spans = spans.program_spans(held.trace)
    n = res.iterations_run
    for parent in ("toyslam.ops.assemble", "toyslam.gn.update"):
        outer = [x for x in all_spans if x[0] == parent]
        assert len(outer) == n
        for x in outer:
            assert [_short(c[0]) for c in _children(x, all_spans)] == [
                "ops.edges3d"]
    assert sum(x[0] == "toyslam.ops.edges3d" for x in all_spans) == 2 * n
