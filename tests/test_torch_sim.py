"""Simulation and graph build of the PyTorch port against the JAX package:
bit-identical arrays from the same seed, the same ATE, and the bridge that
carries a JAX graph (with its gather plan) into the port."""

import dataclasses

import numpy as np
import pytest
import torch

from toyslam_tpu.config import SimConfig as JSim, SlamConfig as JSlam
from toyslam_tpu.ops.gather_plan import attach_plan as j_attach_plan
from toyslam_tpu.sim import environment as j_env
from toyslam_tpu.sim import frontend as jf
from toyslam_tpu.sim import trajectory as j_traj
from toyslam_torch.bridge import graph_from_arrays
from toyslam_torch.config import SimConfig as TSim, SlamConfig as TSlam
from toyslam_torch.models.graph import GraphBuilder2D
from toyslam_torch.ops.gather_plan import attach_plan
from toyslam_torch.sim import environment as t_env
from toyslam_torch.sim import frontend as tf
from toyslam_torch.sim import trajectory as t_traj

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=[(150, 0), (60, 3)],
                ids=["150_seed0", "60_seed3"])
def sims(request):
    steps, seed = request.param
    js = jf.simulate(JSim(robot_steps=steps, seed=seed))
    ts = tf.simulate(TSim(robot_steps=steps, seed=seed))
    return js, ts


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.array_equal(a, b)


def test_environment_and_controls_identical():
    (jp, jr), (tp, tr) = j_env.load_environment(), t_env.load_environment()
    _same(tp, jp)
    assert tp.dtype == jp.dtype and tr == jr
    _same(t_traj.scripted_controls(149), j_traj.scripted_controls(149))


def test_simulate_bit_identical(sims):
    js, ts = sims
    assert js._fields == ts._fields
    for name in js._fields:
        a, b = getattr(js, name), getattr(ts, name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, name
            _same(b, a)
        else:
            assert a == b, name


def test_build_graph_bit_identical(sims):
    js, ts = sims
    jg, jmap = jf.build_graph(js, JSlam())
    tg, tmap = tf.build_graph(ts, TSlam())
    assert tmap == jmap
    for name in ("poses", "landmarks", "pose_mask", "lm_mask", "pose_fixed",
                 "lm_fixed"):
        assert getattr(tg, name).dtype == torch.float32
        _same(getattr(tg, name), getattr(jg, name))
    for edges in ("odom", "lm_edges"):
        je, te = getattr(jg, edges), getattr(tg, edges)
        for f in dataclasses.fields(te):
            t = getattr(te, f.name)
            if t.dtype == torch.int64:
                _same(t, np.asarray(getattr(je, f.name)).astype(np.int64))
            else:
                assert t.dtype == torch.float32
                _same(t, getattr(je, f.name))


def test_main_path_graph_sizes():
    """The 150-pose graph the main path optimizes: 192 padded poses, 384
    padded landmarks, 2304 landmark-edge and 256 odometry slots."""
    g, _ = tf.build_graph(tf.simulate(TSim()), TSlam())
    assert (g.num_poses, g.num_landmarks) == (192, 384)
    assert (g.lm_edges.count, g.odom.count) == (2304, 256)
    assert int(g.lm_mask.sum()) == 354 and int(g.lm_edges.mask.sum()) == 2226


def test_ate_rmse_matches(sims):
    js, ts = sims
    est = ts.poses_dr + np.float32(0.01)
    want = jf.ate_rmse(est, js.poses_gt)
    assert tf.ate_rmse(est, ts.poses_gt) == want
    assert tf.ate_rmse(torch.as_tensor(est), ts.poses_gt) == want


def test_bridge_carries_jax_graph_and_plan():
    js = jf.simulate(JSim(robot_steps=60, seed=1))
    jg = j_attach_plan(jf.build_graph(js, JSlam())[0])
    g = graph_from_arrays(jg)
    own = attach_plan(tf.build_graph(tf.simulate(TSim(robot_steps=60,
                                                      seed=1)), TSlam())[0])
    _same(g.poses, jg.poses)
    _same(g.lm_edges.lm, np.asarray(jg.lm_edges.lm))
    assert g.odom.i.dtype == torch.int64
    for name in ("lm_by_pose", "lm_by_lm", "odom_by_i", "odom_by_j"):
        a, b = getattr(g.plan, name), getattr(own.plan, name)
        _same(a.idx, b.idx)
        _same(a.mask, b.mask)
    _same(g.plan.fused.closure_e, own.plan.fused.closure_e)


def test_graph_to_moves_every_tensor():
    g = attach_plan(tf.build_graph(tf.simulate(TSim(robot_steps=20)),
                                   TSlam())[0])
    m = g.to("meta")
    assert m.device.type == "meta"
    assert m.odom.info.device.type == "meta"
    assert m.plan.lm_by_pose.idx.device.type == "meta"
    assert m.plan.fused.closure_i.device.type == "meta"


def test_builder_pads_to_buckets():
    b = GraphBuilder2D(pose_bucket=4, landmark_bucket=4, edge_bucket=8)
    for t in range(5):
        b.add_pose([t, 0.0, 0.0], fixed=t == 0)
    b.add_landmark(7, [1.0, 2.0])
    assert b.add_landmark(7, [9.0, 9.0]) == 0          # first seen wins
    b.add_odom_edge(0, 1, [1.0, 0.0, 0.0], np.eye(3))
    b.add_landmark_edge(2, 7, [1.0, 0.5], np.eye(2))
    g = b.build()
    assert (g.num_poses, g.num_landmarks) == (8, 4)
    assert (g.odom.count, g.lm_edges.count) == (8, 8)
    assert g.pose_mask.tolist() == [1.0] * 5 + [0.0] * 3
    assert g.pose_fixed.tolist()[:2] == [1.0, 0.0]
    assert g.landmarks[0].tolist() == [1.0, 2.0]
    assert g.lm_edges.pose.dtype == torch.int64
    assert g.lm_edges.mask.tolist() == [1.0] + [0.0] * 7


@pytest.mark.parametrize("shape", [(21, 21), (8, 13)])
def test_environment_grid_and_points(shape):
    (tg, ts), (jg, js) = (t_env.load_environment_grid(shape),
                          j_env.load_environment_grid(shape))
    assert ts == js and tg.dtype == jg.dtype
    np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-6)
    for cell, radius in ((1.0, 0.25), (0.5, 0.1)):
        (tp, tr), (jp, jr) = (t_env.grid_to_points(tg, cell, radius),
                              j_env.grid_to_points(jg, cell, radius))
        assert tr == jr and tp.dtype == jp.dtype
        np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_integrate_matches_jax(seed):
    import jax.numpy as jnp

    # a short tape of small steps keeps |x| below 4, where float32 spacing
    # is below the 1e-6 tolerance
    rng = np.random.default_rng(seed)
    start = np.array([rng.uniform(-1, 1), rng.uniform(-1, 1),
                      rng.uniform(-3, 3)], np.float32)
    controls = rng.normal(scale=0.15, size=(16, 3)).astype(np.float32)
    got = t_traj.integrate(torch.from_numpy(start), torch.from_numpy(controls))
    want = np.asarray(j_traj.integrate(jnp.asarray(start),
                                       jnp.asarray(controls)))
    assert tuple(got.shape) == want.shape == (17, 3)
    assert np.abs(want[:, :2]).max() < 4
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
