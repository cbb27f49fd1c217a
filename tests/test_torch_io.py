"""The IO layer of the PyTorch port against the JAX package's: the wire
codec, the native bridge, snapshots, both servers and the remote fallback,
on the seeded 40-pose simulation (CPU tensors, ``device="cpu"``).

Tolerances: codec bytes and decoded arrays are identical (no tolerance);
native-vs-Python bytes differ only by f32 trig noise (rtol 1e-6, atol 1e-7,
the JAX package's own bound); a remote answer equals a local optimize of
the decoded graph at 1e-5 (the JAX package's bound for remote vs local)."""

import asyncio
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from toyslam_tpu.config import SimConfig as JSim, SlamConfig as JSlam
from toyslam_tpu.io import codec as j_codec
from toyslam_tpu.io import snapshot as j_snapshot
from toyslam_tpu.sim import frontend as jf
from toyslam_torch.config import OptimizerConfig, SimConfig, SlamConfig
from toyslam_torch.io import codec, native
from toyslam_torch.io.client import GraphClient, optimize_with_fallback
from toyslam_torch.io.server import (
    PyGraphServer,
    native_server,
    torch_optimize_fn,
)
from toyslam_torch.io.snapshot import load_snapshot, save_snapshot
from toyslam_torch.models.graph import GraphBuilder2D
from toyslam_torch.optimizer import GaussNewton
from toyslam_torch.sim import frontend

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
needs_native = pytest.mark.usefixtures("native_lib")


@pytest.fixture(scope="module")
def native_lib():
    """Skips where the native library is missing and cannot be built
    (decided when a test runs, not when the module is imported)."""
    if not native.available():
        pytest.skip("native toolchain unavailable")


STATE = ("poses", "landmarks", "pose_mask", "lm_mask", "pose_fixed",
         "lm_fixed")
ODOM = ("i", "j", "meas", "info", "mask")
LM = ("pose", "lm", "meas", "info", "mask")


def _arrays(g):
    """Every array of a graph of either package, by name."""
    out = {f: np.asarray(getattr(g, f)) for f in STATE}
    out.update({"odom." + f: np.asarray(getattr(g.odom, f)) for f in ODOM})
    out.update({"lm." + f: np.asarray(getattr(g.lm_edges, f)) for f in LM})
    return out


def _assert_same_graph(a, b):
    aa, bb = _arrays(a), _arrays(b)
    for name in aa:
        np.testing.assert_array_equal(aa[name], bb[name], err_msg=name)


@pytest.fixture(scope="module")
def problem():
    sim = frontend.simulate(SimConfig(robot_steps=40, seed=0))
    graph, _ = frontend.build_graph(sim, SlamConfig())
    jgraph, _ = jf.build_graph(jf.simulate(JSim(robot_steps=40, seed=0)),
                               JSlam())
    return sim, graph, jgraph


def _float_tolerant_bytes_equal(a: bytes, b: bytes):
    """Equal up to f32 ulp noise in trig-derived payload floats."""
    assert len(a) == len(b)
    au = np.frombuffer(a, np.uint32)
    bu = np.frombuffer(b, np.uint32)
    mism = au != bu
    if mism.any():
        af = np.frombuffer(a, np.float32)[mism]
        bf = np.frombuffer(b, np.float32)[mism]
        np.testing.assert_allclose(af, bf, rtol=1e-6, atol=1e-7)


# ---- codec -----------------------------------------------------------------


@pytest.mark.parametrize("frame", [True, False], ids=["framed", "body"])
def test_codec_bytes_identical_to_jax(problem, frame):
    _, graph, jgraph = problem
    assert (codec.graph_to_bytes(graph, frame=frame)
            == j_codec.graph_to_bytes(jgraph, frame=frame))


def test_codec_decoders_agree_array_for_array(problem):
    _, graph, jgraph = problem
    data = j_codec.graph_to_bytes(jgraph)
    decoded = codec.bytes_to_graph(data)
    assert decoded.device.type == "cpu" and decoded.plan is None
    _assert_same_graph(decoded, j_codec.bytes_to_graph(data))
    # a second trip through the wire is a fixed point of the bytes
    assert codec.graph_to_bytes(decoded) == j_codec.graph_to_bytes(
        j_codec.bytes_to_graph(data))


def test_codec_round_trip_keeps_the_problem(problem):
    """Decoded == sent up to f32 trig noise in ``odom.meas`` (odometry
    travels as a 3x3 transform); everything else is exact."""
    _, graph, _ = problem
    sent, got = _arrays(graph), _arrays(codec.bytes_to_graph(
        codec.graph_to_bytes(graph)))
    for name in sent:
        if name == "odom.meas":
            np.testing.assert_allclose(got[name], sent[name], rtol=1e-6,
                                       atol=1e-6)
        else:
            np.testing.assert_array_equal(got[name], sent[name], name)


def test_codec_rejects_non_diagonal_info_and_bad_frames():
    b = GraphBuilder2D(pose_bucket=4, landmark_bucket=4, edge_bucket=4)
    b.add_pose([0.0, 0.0, 0.0], fixed=True)
    b.add_pose([1.0, 0.0, 0.0])
    info = np.eye(3, dtype=np.float32)
    info[0, 1] = 0.5
    b.add_odom_edge(0, 1, [1.0, 0.0, 0.0], info)
    g = b.build()
    with pytest.raises(ValueError, match="off-diagonal"):
        codec.graph_to_bytes(g)
    g2 = codec.bytes_to_graph(codec.graph_to_bytes(g, allow_lossy_info=True))
    np.testing.assert_array_equal(g2.odom.info[0].numpy(),
                                  np.diag(np.diag(info)))
    data = codec.graph_to_bytes(g, allow_lossy_info=True)
    with pytest.raises(ValueError, match="frame header"):
        codec.bytes_to_graph(data + b"\0\0\0\0")


# ---- snapshot --------------------------------------------------------------


def test_snapshot_round_trip_bit_exact(tmp_path, problem):
    _, graph, _ = problem
    meta = {"iteration": 7, "chi2": 123.5, "note": "mid-run"}
    path = str(tmp_path / "ckpt.npz")
    save_snapshot(path, graph, meta)
    g2, meta2 = load_snapshot(path)
    assert meta2 == meta
    _assert_same_graph(graph, g2)
    assert g2.odom.i.dtype == torch.int64 and g2.poses.dtype == torch.float32


def test_snapshot_reads_the_jax_package_file(tmp_path, problem):
    """One file format for both packages: a snapshot the JAX package wrote
    loads here as the same graph (indices widen to int64), and back."""
    _, graph, jgraph = problem
    path = str(tmp_path / "jax.npz")
    j_snapshot.save_snapshot(path, jgraph, {"from": "jax"})
    g2, meta = load_snapshot(path)
    assert meta == {"from": "jax"}
    _assert_same_graph(graph, g2)
    path2 = str(tmp_path / "torch.npz")
    save_snapshot(path2, graph)
    jg2, _ = j_snapshot.load_snapshot(path2)
    _assert_same_graph(jgraph, jg2)


def test_resume_from_snapshot_continues_optimization(tmp_path, problem):
    """Optimize 3 iterations, checkpoint, resume 3 more: the same state as
    a straight 3 + 3 without the file (bit for bit: same arithmetic)."""
    _, graph, _ = problem
    gn3 = GaussNewton(OptimizerConfig(iterations=3, solver="dense"))
    mid = gn3.optimize(graph).graph
    path = str(tmp_path / "resume.npz")
    save_snapshot(path, mid, {"done": 3})
    loaded, meta = load_snapshot(path)
    assert meta == {"done": 3} and loaded.plan is None
    a = gn3.optimize(loaded).graph
    b = gn3.optimize(mid).graph
    assert torch.equal(a.poses, b.poses)
    assert torch.equal(a.landmarks, b.landmarks)


# ---- native bridge ---------------------------------------------------------


@needs_native
def test_native_codec_matches_python_codec(problem):
    _, graph, _ = problem
    py_bytes = codec.graph_to_bytes(graph)
    _float_tolerant_bytes_equal(py_bytes, native.native_encode(graph))
    g_native = native.native_decode(py_bytes)
    g_py = codec.bytes_to_graph(py_bytes)
    a, b = _arrays(g_native), _arrays(g_py)
    for name in a:
        if name == "odom.meas":
            np.testing.assert_allclose(a[name], b[name], rtol=1e-6,
                                       atol=1e-7)
        else:
            np.testing.assert_array_equal(a[name], b[name], name)


@needs_native
def test_native_optimizer_agrees_with_the_port(problem):
    """The native CPU Gauss-Newton and the port's dense solve reach the
    same trajectory (atol 2e-2, ATE within 5 %: the JAX package's bounds
    for the same cross-check)."""
    sim, graph, _ = problem
    n = sim.poses_gt.shape[0]
    res = GaussNewton(OptimizerConfig(solver="dense")).optimize(graph)
    g_native, stats = native.native_optimize(graph)
    assert isinstance(g_native.poses, torch.Tensor)
    ate_t = frontend.ate_rmse(res.graph.poses[:n].numpy(), sim.poses_gt)
    ate_n = frontend.ate_rmse(g_native.poses[:n].numpy(), sim.poses_gt)
    ate_dr = frontend.ate_rmse(sim.poses_dr, sim.poses_gt)
    assert stats.iterations_run >= 1 and stats.final_chi2 > 0
    assert ate_n < 0.9 * ate_dr
    assert abs(ate_n - ate_t) < 0.05 * max(ate_t, 1e-3)
    np.testing.assert_allclose(g_native.poses[:n].numpy(),
                               res.graph.poses[:n].numpy(), atol=2e-2)


@needs_native
def test_native_timing_report(problem):
    _, graph, _ = problem
    native.timing_report(clear=True)
    native.native_optimize(graph)
    report = native.timing_report()
    assert "Optimize" in report
    assert "CalculateHb" in report and "Solve" in report
    count, total_ms = report["Optimize"]
    assert count >= 1 and total_ms > 0


# ---- servers ---------------------------------------------------------------

CFG = OptimizerConfig(solver="schur", iterations=6)


def _sequential(port: int, graph):
    async def go():
        client = GraphClient("127.0.0.1", port)
        await client.connect()
        try:
            out1 = await client.optimize(graph)
            out2 = await client.optimize(graph)  # the connection stays open
        finally:
            await client.close()
        return out1, out2

    return asyncio.run(go())


def _concurrent(port: int, graphs):
    async def one(graph):
        client = GraphClient("127.0.0.1", port)
        await client.connect()
        try:
            return await client.optimize(graph)
        finally:
            await client.close()

    async def go():
        return await asyncio.gather(*(one(g) for g in graphs))

    return asyncio.run(go())


def _local_answer(graph):
    """What a server must answer: a local optimize of the decoded graph."""
    decoded = codec.bytes_to_graph(codec.graph_to_bytes(graph))
    return GaussNewton(CFG).optimize(decoded).graph


def _check_answers(problem, make_server):
    sim, graph, _ = problem
    n = sim.poses_gt.shape[0]
    sim2 = frontend.simulate(SimConfig(robot_steps=60, seed=1))
    graph2, _ = frontend.build_graph(sim2, SlamConfig())
    want, want2 = _local_answer(graph), _local_answer(graph2)
    real = graph.pose_mask.numpy() > 0.5
    with make_server() as server:
        out1, out2 = _sequential(server.port, graph)
        assert server.error is None
        both = _concurrent(server.port, [graph, graph2])
        assert server.error is None
    # two sequential requests on one connection: the same bits, and the local
    # result at 1e-5
    assert torch.equal(out1.poses, out2.poses)
    assert torch.equal(out1.landmarks, out2.landmarks)
    np.testing.assert_allclose(out1.poses.numpy()[real],
                               want.poses.numpy()[real], rtol=1e-5, atol=1e-5)
    ate = frontend.ate_rmse(out1.poses[:n].numpy(), sim.poses_gt)
    assert ate < 0.9 * frontend.ate_rmse(sim.poses_dr, sim.poses_gt)
    # two clients at once, with different graphs: each gets its own answer
    assert torch.equal(both[0].poses, out1.poses)
    real2 = graph2.pose_mask.numpy() > 0.5
    np.testing.assert_allclose(both[1].poses.numpy()[real2],
                               want2.poses.numpy()[real2], rtol=1e-5,
                               atol=1e-5)
    # the answer keeps the request's structure
    assert int(out1.pose_mask.sum()) == int(graph.pose_mask.sum())
    assert int(out1.lm_edges.mask.sum()) == int(graph.lm_edges.mask.sum())


def test_python_server_sequential_and_concurrent_clients(problem):
    fn = torch_optimize_fn(CFG, device="cpu")
    _check_answers(problem, lambda: PyGraphServer(fn, port=0))
    assert len(fn.timings) == 4
    assert all(t["solve_ms"] > 0 and t["layout_ms"] > 0 for t in fn.timings)


@needs_native
def test_native_server_torch_backend_sequential_and_concurrent(problem):
    _check_answers(problem, lambda: native_server(
        backend="torch", cfg=CFG, port=0, device="cpu"))


@needs_native
def test_native_server_native_backend(problem):
    sim, graph, _ = problem
    n = sim.poses_gt.shape[0]
    with native_server(backend="native", port=0) as server:
        out1, out2 = _sequential(server.port, graph)
    ate = frontend.ate_rmse(out1.poses[:n].numpy(), sim.poses_gt)
    assert ate < 0.9 * frontend.ate_rmse(sim.poses_dr, sim.poses_gt)
    assert torch.equal(out1.poses, out2.poses)
    g_local, _ = native.native_optimize(graph)
    real = graph.pose_mask.numpy() > 0.5
    np.testing.assert_allclose(out1.poses.numpy()[real],
                               g_local.poses.numpy()[real], rtol=1e-5,
                               atol=1e-5)


def test_solves_are_serialised_under_many_clients(problem, monkeypatch):
    """Eight clients at once against four executor threads: the callback's
    lock lets one solve run at a time (a second one inside the solver would
    trip the counter), and every client gets the sequential answer."""
    import sys
    import threading
    import time

    from toyslam_torch.optimizer import gauss_newton

    _, graph, _ = problem
    cfg = OptimizerConfig(solver="schur", iterations=2)
    fn = torch_optimize_fn(cfg, device="cpu")
    want = fn(codec.bytes_to_graph(codec.graph_to_bytes(graph)))
    fn.timings.clear()
    run, guard, active, overlaps = gauss_newton._run, threading.Lock(), [], []

    def watched(*args, **kw):
        with guard:
            active.append(1)
            overlaps.append(len(active))
        time.sleep(0.01)              # give another thread the chance
        try:
            return run(*args, **kw)
        finally:
            with guard:
                active.pop()

    monkeypatch.setattr(gauss_newton, "_run", watched)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with PyGraphServer(fn, port=0) as server:
            answers = _concurrent(server.port, [graph] * 8)
            assert server.error is None
    finally:
        sys.setswitchinterval(interval)
    assert len(answers) == 8 and len(fn.timings) == 8
    assert max(overlaps) == 1, overlaps
    for a in answers:
        assert torch.equal(a.poses, want.poses)
        assert torch.equal(a.landmarks, want.landmarks)


def _failing(graph):
    raise RuntimeError("solver exploded")


@pytest.mark.parametrize("kind", ["python", "native"])
def test_callback_exception_surfaces_as_server_error(problem, kind, request):
    """A failing callback is not swallowed: it lands in ``server.error``
    and the client gets no answer."""
    from toyslam_torch.io.native import NativeServer

    if kind == "native":
        request.getfixturevalue("native_lib")
    _, graph, _ = problem
    server = (PyGraphServer(_failing, port=0) if kind == "python"
              else NativeServer(_failing, port=0))
    with server:
        with pytest.raises((asyncio.IncompleteReadError, ConnectionError)):
            _sequential(server.port, graph)
    assert isinstance(server.error, RuntimeError)
    assert "exploded" in str(server.error)


def test_torch_optimize_fn_refuses_a_missing_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_optimize_fn(CFG)            # the default device is the card
    with pytest.raises(ValueError, match="backend"):
        native_server(backend="jax")


def test_fallback_to_local_on_a_closed_port(problem):
    sim, graph, _ = problem
    n = sim.poses_gt.shape[0]
    fn = torch_optimize_fn(CFG, device="cpu")
    with PyGraphServer(fn, port=0) as server:
        async def go():
            client = GraphClient("127.0.0.1", server.port)
            try:
                return await optimize_with_fallback(graph, client, fn)
            finally:
                await client.close()

        out, backend = asyncio.run(go())
    assert backend == "remote"

    async def go_fallback():
        client = GraphClient("127.0.0.1", 1)  # nothing listens on port 1
        return await optimize_with_fallback(graph, client, fn)

    out2, backend2 = asyncio.run(go_fallback())
    assert backend2 == "local"
    ate_dr = frontend.ate_rmse(sim.poses_dr, sim.poses_gt)
    for g in (out, out2):
        assert frontend.ate_rmse(g.poses[:n].numpy(), sim.poses_gt) < (
            0.9 * ate_dr)


# ---- CLI -------------------------------------------------------------------


def _cli(*args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "toyslam_torch", *args], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=timeout)
    return proc


def test_cli_run_remote_and_fallback(problem):
    fn = torch_optimize_fn(OptimizerConfig(solver="schur", iterations=3),
                           device="cpu")
    with PyGraphServer(fn, port=0) as server:
        proc = _cli("run", "--steps", "40", "--device", "cpu", "--remote",
                    f"127.0.0.1:{server.port}")
        assert server.error is None
    assert proc.returncode == 0, proc.stderr
    m = json.loads(proc.stdout.strip().splitlines()[-1])
    assert m["backend"] == "remote" and m["kernel_launches"] == 0
    assert m["ate_rmse"] < m["ate_dead_reckoning"]
    assert "iterations_run" not in m       # the solver's telemetry is remote

    proc = _cli("run", "--steps", "40", "--iterations", "3", "--device",
                "cpu", "--remote", "127.0.0.1:1")
    assert proc.returncode == 0, proc.stderr
    assert "using local optimizer" in proc.stderr
    m2 = json.loads(proc.stdout.strip().splitlines()[-1])
    assert m2["backend"] == "local"
    # the same 3 iterations either way, up to the wire's f32 trig noise
    assert abs(m2["ate_rmse"] - m["ate_rmse"]) <= 1e-3


def test_cli_run_snapshot_resumes(tmp_path):
    path = str(tmp_path / "run.npz")
    proc = _cli("run", "--steps", "40", "--iterations", "3", "--device",
                "cpu", "--snapshot", path)
    assert proc.returncode == 0, proc.stderr
    m = json.loads(proc.stdout.strip().splitlines()[-1])
    assert m["snapshot"] == path
    g, meta = load_snapshot(path)
    assert meta["metrics"]["chi2_final"] == m["chi2_final"]
    assert int(g.pose_mask.sum()) == 40
    res = GaussNewton(OptimizerConfig(iterations=3)).optimize(g)
    errs = res.errors.numpy()
    assert errs[0] < m["chi2_first"] and errs[-1] < errs[0]


@pytest.mark.parametrize("argv", [
    ["serve"], ["serve", "--device", "cuda"],
    ["run", "--remote", "127.0.0.1:1"], ["run", "--live"],
    ["run", "--snapshot", "x.npz"], ["run", "--save-plot", "x.png"],
    ["run", "--profile", "x"],
], ids=lambda a: "_".join(a).replace("--", ""))
def test_cli_entry_points_refuse_a_missing_gpu(argv):
    """Every new entry point defaults to the card and exits 2 without one:
    no CPU fallback."""
    code = ("import torch, sys; from toyslam_torch.app import main; "
            "torch.cuda.is_available = lambda: False; "
            f"sys.exit(main({argv!r}))")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and "no CUDA device" in proc.stderr
    assert proc.stdout == ""


def test_cli_serve_answers_a_client():
    """``python -m toyslam_torch serve --device cpu`` listens and answers."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "toyslam_torch", "serve", "--port", str(port),
         "--iterations", "3", "--device", "cpu"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = ""
        while "listening" not in line:
            line = proc.stderr.readline()
            assert line, "server exited: " + proc.stderr.read()
        sim = frontend.simulate(SimConfig(robot_steps=40, seed=0))
        graph, _ = frontend.build_graph(sim, SlamConfig())
        out, _ = _sequential(port, graph)
        ate = frontend.ate_rmse(out.poses[:40].numpy(), sim.poses_gt)
        assert ate < frontend.ate_rmse(sim.poses_dr, sim.poses_gt)
    finally:
        proc.terminate()
        proc.wait(timeout=20)
