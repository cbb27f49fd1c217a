"""Host-side tables of the port's sharded solves against the JAX package's,
with no process started: ``build_partition`` at D = 2, 4 and 8 (every plan
table, the permutations, the partitioned graph's arrays and every
``PartitionMeta`` field equal), ``build_sharded_plan`` (equal tables),
``pad_edges_for_mesh`` (inert), the per-rank bytes of the partition and
the landmark permutation round trip (``tests/test_partition.py:147-192``).
The JAX side is carried across through ``bridge.partition_from_arrays``,
which is checked on the way."""

import dataclasses

import numpy as np
import pytest
import torch

import oracle
from toyslam_tpu.ops.gather_plan import build_sharded_plan as j_sharded_plan
from toyslam_tpu.parallel import build_partition as j_build_partition
from toyslam_tpu.parallel import pad_edges_for_mesh as j_pad
from toyslam_tpu.sim import synthetic as j_synth
from toyslam_torch.bridge import graph_from_arrays, partition_from_arrays
from toyslam_torch.config import OptimizerConfig
from toyslam_torch.ops import schur as t_schur
from toyslam_torch.ops.gather_plan import attach_plan, build_sharded_plan
from toyslam_torch.parallel import build_partition, pad_edges_for_mesh
from toyslam_torch.parallel.partition import partition_shard
from toyslam_torch.sim import synthetic as t_synth

torch.set_num_threads(1)

GRAPHS = {
    "random25": None,
    "large600": dict(num_poses=600, num_landmarks=400, obs_per_pose=5,
                     seed=2),
    "large200": dict(num_poses=200, num_landmarks=150, obs_per_pose=4,
                     seed=3),
}
BUCKETS = dict(pose_bucket=64, landmark_bucket=64, edge_bucket=256)


@pytest.fixture(scope="module")
def jax_graphs():
    out = {}
    for name, kw in GRAPHS.items():
        if kw is None:
            prob = oracle.make_random_problem(np.random.default_rng(9), 25,
                                              14, 120)
            out[name] = oracle.problem_to_builder(prob).build()
        else:
            out[name] = j_synth.make_large_problem(**kw, **BUCKETS)[0]
    return out


def _arrays(graph):
    """Every array of a partitioned graph by name, as numpy."""
    out = {f: np.asarray(getattr(graph, f)) for f in (
        "poses", "landmarks", "pose_mask", "lm_mask", "pose_fixed",
        "lm_fixed")}
    for edges in ("odom", "lm_edges"):
        e = getattr(graph, edges)
        for f in ("meas", "info", "mask") + (
                ("i", "j") if edges == "odom" else ("pose", "lm")):
            out[f"{edges}.{f}"] = np.asarray(getattr(e, f))
    for f in dataclasses.fields(graph.plan):
        out[f"plan.{f.name}"] = np.asarray(getattr(graph.plan, f.name))
    return out


@pytest.mark.parametrize("n_dev", [2, 4, 8])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_build_partition_equals_jax(jax_graphs, name, n_dev):
    jg = jax_graphs[name]
    kw = dict(align=8, coarse_group=8)
    jpg, jmeta = j_build_partition(jg, n_dev, **kw)
    pg, meta = build_partition(graph_from_arrays(jg), n_dev, **kw)
    bpg, bmeta = partition_from_arrays(jpg, jmeta)
    ref, got, bridged = _arrays(jpg), _arrays(pg), _arrays(bpg)
    assert set(ref) == set(got)
    for k, a in ref.items():
        np.testing.assert_array_equal(got[k], a, err_msg=k)
        np.testing.assert_array_equal(bridged[k], got[k], err_msg=k)
        if np.issubdtype(a.dtype, np.integer):
            assert got[k].dtype == np.int64, k
    for k, v in jmeta._asdict().items():
        np.testing.assert_array_equal(getattr(meta, k), v, err_msg=k)
        np.testing.assert_array_equal(getattr(bmeta, k), v, err_msg=k)


def test_partition_shard_is_the_rank_block(jax_graphs):
    pg, meta = build_partition(graph_from_arrays(jax_graphs["large200"]), 4,
                               align=8, coarse_group=8)
    for rank in range(4):
        s = partition_shard(pg, meta, rank)
        np.testing.assert_array_equal(
            s.poses, pg.poses[rank * meta.nb:(rank + 1) * meta.nb])
        np.testing.assert_array_equal(
            s.landmarks, pg.landmarks[rank * meta.mb:(rank + 1) * meta.mb])
        np.testing.assert_array_equal(s.plan.lm_ext, pg.plan.lm_ext[rank])
        assert (s.plan.n_bp, s.plan.n_bl) == (meta.n_bp, meta.n_bl)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_build_sharded_plan_equals_jax(jax_graphs, n_dev):
    jg = j_pad(jax_graphs["random25"], n_dev)
    ref = j_sharded_plan(jg, n_dev)
    got = build_sharded_plan(graph_from_arrays(jg), n_dev)
    for f in ("lm_by_pose", "lm_by_lm", "odom_by_i", "odom_by_j"):
        for k in ("idx", "mask"):
            np.testing.assert_array_equal(
                getattr(getattr(got, f), k).numpy(),
                np.asarray(getattr(getattr(ref, f), k)), err_msg=f"{f}.{k}")
    assert got.fused is None and got.band is None


def test_pad_edges_for_mesh_is_inert(jax_graphs):
    tg = graph_from_arrays(jax_graphs["random25"])
    padded = pad_edges_for_mesh(tg, 7)   # deliberately not a power of two
    assert padded.odom.count % 7 == 0 and padded.lm_edges.count % 7 == 0
    ref = j_pad(jax_graphs["random25"], 7)
    np.testing.assert_array_equal(padded.odom.i.numpy(), np.asarray(ref.odom.i))
    cfg = OptimizerConfig(solver="schur", pcg_tol=1e-8, pcg_max_iters=500,
                          pcg_backend="xla")
    solve = t_schur.schur_linearize_solve(cfg)
    a = solve(attach_plan(tg), torch.tensor(1e-3))
    b = solve(attach_plan(padded), torch.tensor(1e-3))
    np.testing.assert_allclose(b[0].numpy(), a[0].numpy(), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(float(b[2]), float(a[2]), rtol=1e-6)


def test_per_rank_memory_scales_down():
    """Per-rank bytes fall by at least 4x from D=1 to D=8 (every array of
    the partitioned graph is cut along its leading axis), and on the
    serpentine sweep a minority of landmarks is seen from more than one
    keyframe block."""
    graph, _, _ = t_synth.make_large_problem(**GRAPHS["large600"], **BUCKETS)

    def per_rank_bytes(n_dev):
        pg, meta = build_partition(graph, n_dev, align=8, coarse_group=8)
        total = sum(a.nbytes for a in _arrays(pg).values())
        return total / n_dev, meta

    b1, _ = per_rank_bytes(1)
    _, meta4 = per_rank_bytes(4)
    b8, _ = per_rank_bytes(8)
    assert b8 < b1 / 4.0, (b1, b8)
    assert meta4.boundary_lm_frac < 0.5, meta4.boundary_lm_frac


def test_landmark_permutation_roundtrip():
    graph, _, _ = t_synth.make_large_problem(**GRAPHS["large200"], **BUCKETS)
    m = graph.num_landmarks
    pg, meta = build_partition(graph, 4, align=8, coarse_group=8)
    back = meta.unpermute_landmarks(pg.landmarks.numpy(), m)
    mask = graph.lm_mask.numpy() > 0
    np.testing.assert_array_equal(back[mask], graph.landmarks.numpy()[mask])
    real_new = meta.new_of_old_lm[mask]
    assert (real_new >= 0).all()
    assert len(np.unique(real_new)) == mask.sum()
