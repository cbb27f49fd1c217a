"""The live loop, the views and the remaining ``run`` flags of the PyTorch
port against the JAX package's.

``LiveSlam`` is host numpy with one noise stream on both sides: after N
frames for one seed the built graph is identical (no tolerance), also after
a write-back of an optimized state.  The views are held to what they draw
(artist data, a non-empty PNG under Agg)."""

import json
import os

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from toyslam_tpu.config import SimConfig as JSim, SlamConfig as JSlam  # noqa: E402
from toyslam_tpu.models.graph import GraphBuilder2D as JBuilder  # noqa: E402
from toyslam_tpu.sim.live import LiveSlam as JLive  # noqa: E402
from toyslam_torch.app import main as app_main  # noqa: E402
from toyslam_torch.config import (  # noqa: E402
    OptimizerConfig,
    SimConfig,
    SlamConfig,
)
from toyslam_torch.io.snapshot import load_snapshot  # noqa: E402
from toyslam_torch.models.graph import GraphBuilder2D  # noqa: E402
from toyslam_torch.optimizer import GaussNewton  # noqa: E402
from toyslam_torch.sim import frontend  # noqa: E402
from toyslam_torch.sim.live import LiveSlam, attach_views  # noqa: E402
from toyslam_torch.view import (  # noqa: E402
    FootprintView2d,
    GraphView2d,
    RobotStateView,
    View,
    render_result,
)

torch.set_num_threads(1)

STATE = ("poses", "landmarks", "pose_mask", "lm_mask", "pose_fixed",
         "lm_fixed")


def _same_graph(jg, tg):
    for f in STATE:
        np.testing.assert_array_equal(np.asarray(getattr(jg, f)),
                                      getattr(tg, f).numpy(), err_msg=f)
    for je, te, names in (
            (jg.odom, tg.odom, ("i", "j", "meas", "info", "mask")),
            (jg.lm_edges, tg.lm_edges,
             ("pose", "lm", "meas", "info", "mask"))):
        for f in names:
            np.testing.assert_array_equal(np.asarray(getattr(je, f)),
                                          getattr(te, f).numpy(), err_msg=f)


# ---- builder ---------------------------------------------------------------


def _fill(b):
    b.add_pose([0.0, 0.0, 0.0], fixed=True)
    b.add_pose([1.0, 0.0, 0.1])
    b.add_landmark(17, [2.0, 1.0])
    b.add_landmark(5, [0.5, -1.0])
    b.add_odom_edge(0, 1, [1.0, 0.0, 0.1], np.eye(3))
    b.add_landmark_edge(1, 5, [1.2, 0.3], np.eye(2))
    return b


def test_builder_set_state_and_landmark_index_match_jax():
    kw = dict(pose_bucket=4, landmark_bucket=4, edge_bucket=4)
    jb, tb = _fill(JBuilder(**kw)), _fill(GraphBuilder2D(**kw))
    assert tb.landmark_index(17) == jb.landmark_index(17) == 0
    assert tb.landmark_index(5) == jb.landmark_index(5) == 1
    with pytest.raises(KeyError):
        tb.landmark_index(99)
    poses = np.array([[0.1, 0.2, 0.3], [1.1, 0.1, 0.2]])
    lms = np.array([[2.5, 1.5], [0.25, -0.75]])
    jb.set_state(poses, lms)
    tb.set_state(torch.from_numpy(poses), lms)       # tensors or arrays
    _same_graph(jb.build(), tb.build())
    with pytest.raises(ValueError, match="poses"):
        tb.set_state(poses[:1], lms)
    with pytest.raises(ValueError, match="landmarks"):
        tb.set_state(poses, lms[:1])


# ---- LiveSlam --------------------------------------------------------------


@pytest.mark.parametrize("seed,frames", [(0, 39), (3, 25)])
def test_live_graph_bit_identical_to_jax(seed, frames):
    jl = JLive(JSlam(sim=JSim(robot_steps=40, seed=seed)))
    tl = LiveSlam(SlamConfig(sim=SimConfig(robot_steps=40, seed=seed)))
    for _ in range(frames):
        assert jl.step() and tl.step()
    assert tl.frame == jl.frame == frames and tl.done == jl.done
    _same_graph(jl.graph(), tl.graph())
    np.testing.assert_array_equal(np.asarray(jl.traj_gt),
                                  np.asarray(tl.traj_gt))
    np.testing.assert_array_equal(np.asarray(jl.traj_dr),
                                  np.asarray(tl.traj_dr))
    np.testing.assert_array_equal(jl.last_scan_local, tl.last_scan_local)


def test_live_write_back_then_more_frames_bit_identical():
    """The same optimized state written back on both sides (a perturbation
    standing in for an optimizer), then more frames: still the same graph,
    so later frames extend the written state the same way."""
    jl = JLive(JSlam(sim=JSim(robot_steps=40, seed=0)))
    tl = LiveSlam(SlamConfig(sim=SimConfig(robot_steps=40, seed=0)))
    for _ in range(20):
        jl.step(), tl.step()

    def nudge(g):
        poses = np.asarray(g.poses) + np.float32(0.01)
        lms = np.asarray(g.landmarks) - np.float32(0.02)
        if isinstance(g.poses, torch.Tensor):
            poses, lms = torch.from_numpy(poses), torch.from_numpy(lms)
        return g.with_state(poses, lms)

    jl.optimize(nudge), tl.optimize(nudge)
    np.testing.assert_array_equal(jl.pose_dr, tl.pose_dr)
    while jl.step():
        assert tl.step()
    assert not tl.step()
    _same_graph(jl.graph(), tl.graph())


def test_live_accumulates_frames_and_optimizes():
    cfg = SlamConfig(
        sim=SimConfig(robot_steps=40, seed=0),
        optimizer=OptimizerConfig(iterations=8, solver="schur"),
    )
    live = LiveSlam(cfg)
    frames = 0
    while live.step():
        frames += 1
    assert frames == 39
    assert live.builder.num_poses == 40 and live.builder.num_landmarks > 0

    gn = GaussNewton(cfg.optimizer)
    out = live.optimize(lambda g: gn.optimize(g).graph)
    gt = np.asarray(live.traj_gt, np.float32)
    dr = np.asarray(live.traj_dr, np.float32)
    est = out.poses.numpy()[: gt.shape[0]]
    assert frontend.ate_rmse(est, gt) < frontend.ate_rmse(dr, gt)
    # write-back: the builder now holds the optimized trajectory
    np.testing.assert_allclose(np.stack(live.builder._poses), est, atol=1e-6)
    np.testing.assert_array_equal(live.pose_dr, est[-1].astype(np.float64))


# ---- views -----------------------------------------------------------------


def test_attach_views_writes_a_png(tmp_path):
    cfg = SlamConfig(sim=SimConfig(robot_steps=12, seed=0),
                     optimizer=OptimizerConfig(iterations=2))
    live = LiveSlam(cfg)
    view = View(title="live test")
    update = attach_views(live, view)
    gn = GaussNewton(cfg.optimizer)
    out = None
    while live.step():
        if live.frame == 6:
            out = live.optimize(lambda g: gn.optimize(g).graph)
        update(out)                      # tensors go straight to the views
    n_lines = len(view.ax.lines)
    assert n_lines >= 6                  # 2 robots x 4 lines, trail, graph
    trail = [l for l in view.ax.lines if l.get_label() == "ground truth"][0]
    assert len(trail.get_xdata()) == len(live.traj_gt)
    path = tmp_path / "live.png"
    view.save(str(path))
    assert path.stat().st_size > 5000
    assert view.open
    view.close()
    assert not view.open


def test_individual_views_take_arrays_and_tensors():
    view = View(env=np.array([[0.0, 0.0], [4.0, 4.0]]), radius=0.25)
    robot = RobotStateView(view, fov=1.0)
    robot.update(torch.tensor([1.0, 2.0, 0.5]),
                 scan_xy=np.array([[1.0, 0.0], [2.0, 0.5]]))
    assert list(robot._dot.get_xdata()) == [1.0]
    assert robot._scan.get_offsets().shape == (2, 2)
    trail = FootprintView2d(view)
    trail.update(torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 0.0]]))
    assert list(trail._line.get_ydata()) == [0.0, 1.0]
    gv = GraphView2d(view)
    poses = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.1], [9.0, 9.0, 0.0]])
    lms = torch.tensor([[2.0, 2.0], [7.0, 7.0]])
    gv.update(poses, lms, pose_mask=torch.tensor([1.0, 1.0, 0.0]),
              lm_mask=torch.tensor([1.0, 0.0]))
    assert len(gv._poses.get_xdata()) == 2        # the padded pose is cut
    assert gv._lms.get_offsets().shape == (1, 2)
    first = gv._ticks
    gv.update(poses.numpy(), lms.numpy())
    assert gv._ticks is not first                 # ticks rebuilt per update
    view.close()


def test_render_result_writes_a_png(tmp_path):
    sim = frontend.simulate(SimConfig(robot_steps=30, seed=0))
    graph, _ = frontend.build_graph(sim, SlamConfig())
    path = tmp_path / "result.png"
    view = render_result(
        sim.env, sim.radius, sim.poses_gt, sim.poses_dr, graph.poses[:30],
        graph.landmarks[graph.lm_mask > 0], save_path=str(path))
    assert path.stat().st_size > 5000
    labels = {l.get_label() for l in view.ax.lines}
    assert {"ground truth", "dead reckoning", "optimized poses"} <= labels
    view.close()


# ---- CLI -------------------------------------------------------------------


def _metrics(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_run_live_headless(tmp_path, capsys):
    plot = str(tmp_path / "live.png")
    rc = app_main([
        "run", "--live", "--steps", "30", "--iterations", "5",
        "--optimize-every", "10", "--save-plot", plot, "--device", "cpu",
    ])
    assert rc == 0
    m = _metrics(capsys)
    assert m["cmd"] == "run --live" and m["device"] == "cpu"
    assert m["frames"] == 29 and m["optimizations"] == 3
    assert m["poses"] == 30 and m["landmarks"] > 0
    assert m["ate_rmse"] < m["ate_dead_reckoning"]
    assert m["frames_per_s"] > 0 and m["kernel_launches"] == 0
    assert m["plot"] == plot and os.path.getsize(plot) > 5000


def test_cli_run_live_optimizes_once_without_optimize_every(capsys):
    rc = app_main(["run", "--live", "--steps", "20", "--iterations", "3",
                   "--device", "cpu"])
    assert rc == 0
    m = _metrics(capsys)
    assert m["optimizations"] == 1 and "plot" not in m


def test_cli_run_artifacts(tmp_path, capsys):
    """``--save-plot``, ``--snapshot`` and ``--profile`` in one run."""
    plot, snap = str(tmp_path / "run.png"), str(tmp_path / "run.npz")
    trace = str(tmp_path / "trace")
    rc = app_main([
        "run", "--steps", "30", "--iterations", "2", "--device", "cpu",
        "--save-plot", plot, "--snapshot", snap, "--profile", trace,
    ])
    assert rc == 0
    m = _metrics(capsys)
    assert m["plot"] == plot and os.path.getsize(plot) > 5000
    assert m["snapshot"] == snap and m["profile_trace"] == trace
    assert m["iterations_run"] == 2 and m["backend"] == "local"
    g, meta = load_snapshot(snap)
    assert int(g.pose_mask.sum()) == 30
    assert meta["metrics"]["ate_rmse"] == m["ate_rmse"]
    traces = os.listdir(trace)
    assert traces and os.path.getsize(os.path.join(trace, traces[0])) > 1000


@pytest.mark.parametrize("flags", [["--save-plot", "x.png"],
                                   ["--live", "--save-plot", "x.png"],
                                   ["--view"]])
def test_cli_plot_flags_need_matplotlib(monkeypatch, capsys, flags):
    """matplotlib is optional: without it the plot flags exit 2 with a
    message before anything runs."""
    import importlib.util

    real = importlib.util.find_spec
    monkeypatch.setattr(
        importlib.util, "find_spec",
        lambda name, *a, **k: None if name == "matplotlib" else real(
            name, *a, **k))
    rc = app_main(["run", "--steps", "20", "--device", "cpu", *flags])
    captured = capsys.readouterr()
    assert rc == 2 and "matplotlib" in captured.err and captured.out == ""
