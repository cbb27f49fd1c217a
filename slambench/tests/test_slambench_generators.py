"""The frozen generators give the port's own graphs, array for array."""

import numpy as np
import pytest

from slambench import generators

from toyslam_torch.config import SimConfig, SlamConfig
from toyslam_torch.models.graph import graph_from_numpy
from toyslam_torch.sim import frontend, synthetic


def _arrays(g):
    return [t.numpy() for t in (
        g.poses, g.landmarks, g.pose_mask, g.lm_mask, g.pose_fixed,
        g.lm_fixed, *g.odom.__dict__.values(), *g.lm_edges.__dict__.values())]


def _assert_same(mine: dict, theirs):
    got = graph_from_numpy(**mine)
    for a, b in zip(_arrays(got), _arrays(theirs), strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1])
def test_robot_is_the_ports_simulation(seed):
    r = generators.robot(seed, robot_steps=150, fov_deg=120.0,
                         ray_step_deg=6.0)
    cfg = SlamConfig(sim=SimConfig(robot_steps=150, seed=seed))
    sim = frontend.simulate(cfg.sim)
    graph, id_map = frontend.build_graph(sim, cfg)
    _assert_same(r["graph"], graph)
    assert r["n_poses"] == 150 and r["n_landmarks"] == len(id_map)
    assert np.array_equal(r["poses_gt"], sim.poses_gt)


@pytest.mark.parametrize("seed,laps,landmarks", [
    (0, 1, 10_000), (1, 1, 10_000), (0, 2, 5_000)])
def test_serpentine_is_the_ports_large_problem(seed, laps, landmarks):
    r = generators.serpentine(seed, num_poses=10_000,
                              num_landmarks=landmarks, obs_per_pose=6,
                              laps=laps)
    graph, gt, lm_gt = synthetic.make_large_problem(
        10_000, landmarks, 6, seed=seed, laps=laps)
    _assert_same(r["graph"], graph)
    assert r["n_landmarks"] == lm_gt.shape[0]
    assert np.array_equal(r["poses_gt"], gt)


def test_generate_merges_a_mix_over_a_configuration():
    spec = {"kind": "robot", "robot_steps": 30, "fov_deg": 120.0,
            "ray_step_deg": 6.0}
    a = generators.generate(spec, 5)
    b = generators.robot(5, 30, 120.0, 6.0)
    assert np.array_equal(a["graph"]["poses"], b["graph"]["poses"])
    assert a["n_poses"] == 30



def _pool_poses(spec, seed):
    return [p["graph"]["poses"].tobytes()
            for p in generators.pool(spec, seed)]


def test_a_pool_seed_gives_every_seed_the_same_graphs_in_its_own_order():
    spec = {"kind": "robot", "robot_steps": 30, "fov_deg": 120.0,
            "ray_step_deg": 6.0, "pool": 4}
    fixed = {**spec, "pool_seed": 3}
    a = _pool_poses(fixed, 2200000101)
    b = _pool_poses(fixed, 2200000102)
    # seed 3's four graphs for every run, each in an order its seed draws
    assert sorted(a) == sorted(b) == sorted(_pool_poses(spec, 3))
    assert a != b
    assert not set(_pool_poses(spec, 2200000101)) & set(a)
