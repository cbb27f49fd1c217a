"""The port's state-partitioned solve (``toyslam_torch.parallel.partition``)
on 4 gloo ranks on the CPU against the JAX package's on a 4-device mesh of
the fake CPU devices (``make_mesh(4, axis="dev")``), on the inputs and at
the tolerances of ``tests/test_partition.py``: the five preconditioners
(err rtol 1e-5; dx rtol 2e-3, atol 1e-5), exact odometry Jacobians, GN end
to end through ``gather_result`` (poses atol 5e-3), three all-reduces per
matvec, the solve on tables the JAX package built (through the bridge),
bitwise agreement across the ranks and no kernel launch.

``JAX_PLATFORMS=cpu python tests/test_torch_partition.py`` prints
``PART_REF``: the JAX package's partitioned run of the smoke's
``dist_scale`` phase on 4 fake CPU devices (chip_smoke.py holds the port to
it on the card)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import oracle
import torch_parallel_ranks as ranks
from toyslam_tpu.config import OptimizerConfig as JOpt
from toyslam_tpu.ops import schur as j_schur
from toyslam_tpu.optimizer import GaussNewton as JGaussNewton
from toyslam_tpu.parallel import build_partition as j_build_partition
from toyslam_tpu.parallel import make_mesh as j_make_mesh
from toyslam_tpu.parallel import partitioned_linearize_solve as j_part
from toyslam_torch.bridge import graph_from_arrays, partition_from_arrays
from toyslam_torch.parallel.launch import run_ranks

D = 4
CFG = dict(solver="schur", pcg_tol=1e-9, pcg_max_iters=800,
           pcg_precond="jacobi", pcg_chunk=8, pcg_coarse_group=8)


@pytest.fixture(scope="module")
def graphs():
    prob = oracle.make_random_problem(np.random.default_rng(9), n_poses=25,
                                      n_lms=14, n_lm_edges=120)
    jg = oracle.problem_to_builder(prob).build()
    return jg, graph_from_arrays(jg)


@pytest.fixture(scope="module")
def jax_tables(graphs):
    """The JAX package's partition of the graph, carried across."""
    pg, meta = j_build_partition(graphs[0], D, align=8, coarse_group=8)
    return partition_from_arrays(pg, meta)


@pytest.fixture(scope="module")
def port(graphs, jax_tables):
    return run_ranks(ranks.partition_cases, D, "cpu",
                     (graphs[1], CFG) + jax_tables)


@pytest.fixture(scope="module")
def mesh():
    return j_make_mesh(D, axis="dev")


def _blocks(port, case, key):
    return np.concatenate([r[case][key] for r in port])


def _close(port, ref, rtol=2e-3, atol=1e-5):
    np.testing.assert_allclose(np.asarray(port, np.float64),
                               np.asarray(ref, np.float64),
                               rtol=rtol, atol=atol)


def _jax_solve(jg, mesh, **change):
    cfg = JOpt(**dict(CFG, **change))
    solve = j_part(cfg, mesh)
    out = jax.jit(solve)(solve.prepare(jg), jnp.asarray(1e-3))
    return out, solve.meta


@pytest.mark.parametrize("precond", ranks.PRECONDS)
def test_partitioned_solve_matches_jax(graphs, port, mesh, precond):
    jg = graphs[0]
    n, m = jg.num_poses, jg.num_landmarks
    (dxp, dxl, err, _), meta = _jax_solve(jg, mesh, pcg_precond=precond)
    _close(port[0][precond]["err"], float(err), rtol=1e-5, atol=0.0)
    _close(_blocks(port, precond, "dxp")[:n], np.asarray(dxp)[:n])
    un = port[0]["meta"].unpermute_landmarks(_blocks(port, precond, "dxl"), m)
    _close(un, meta.unpermute_landmarks(np.asarray(dxl), m))


def test_partitioned_solve_matches_single_device(graphs, port):
    """The chunk+coarse partitioned solve against the JAX package's
    single-device Schur solve, as tests/test_partition.py holds it."""
    jg = graphs[0]
    n, m = jg.num_poses, jg.num_landmarks
    cfg = JOpt(**dict(CFG, pcg_precond="chunk+coarse"))
    dxp, dxl, err, _ = jax.jit(j_schur.schur_linearize_solve(cfg))(
        jg, jnp.asarray(1e-3))
    got = port[0]["chunk+coarse"]
    _close(got["err"], float(err), rtol=1e-5, atol=0.0)
    _close(_blocks(port, "chunk+coarse", "dxp")[:n], np.asarray(dxp)[:n])
    un = port[0]["meta"].unpermute_landmarks(
        _blocks(port, "chunk+coarse", "dxl"), m)
    _close(un, np.asarray(dxl)[:m])


def test_partitioned_exact_odom_jacobians(graphs, port, mesh):
    jg = graphs[0]
    n = jg.num_poses
    (dxp, _, err, _), _ = _jax_solve(jg, mesh, exact_odom_jacobians=True)
    _close(port[0]["exact"]["err"], float(err), rtol=1e-5, atol=0.0)
    _close(_blocks(port, "exact", "dxp")[:n], np.asarray(dxp)[:n])


def test_partitioned_gauss_newton_end_to_end(graphs, port, mesh):
    """GN through the partitioned solve, the whole trajectory gathered on
    every rank, against the JAX package's partitioned and single-device
    runs."""
    jg = graphs[0]
    n, m = jg.num_poses, jg.num_landmarks
    cfg = JOpt(**dict(CFG, iterations=8, pcg_precond="chunk+coarse"))
    ref = JGaussNewton(cfg, solve=j_part(cfg, mesh)).optimize(jg)
    single = JGaussNewton(cfg).optimize(jg)
    for r in port:
        _close(r["gn"]["poses"][:n], np.asarray(ref.graph.poses)[:n],
               rtol=0.0, atol=5e-3)
        _close(r["gn"]["poses"][:n], np.asarray(single.graph.poses)[:n],
               rtol=0.0, atol=5e-3)
        _close(r["gn"]["landmarks"][:m],
               np.asarray(single.graph.landmarks)[:m], rtol=0.0, atol=5e-3)


def test_three_collectives_per_matvec(port):
    """x publication, the u and odometry row-j tails together, and v
    publication: the JAX package's count."""
    assert [r["matvec_collectives"] for r in port] == [3] * D


def test_solve_on_jax_tables_matches_own_tables(port):
    """The port's solve on tables the JAX package built gives the bits of
    its solve on its own tables (the tables are equal,
    tests/test_torch_parallel_plan.py)."""
    for r in port:
        for k in ("dxp", "dxl", "err"):
            np.testing.assert_array_equal(r["jax_tables"][k], r["jacobi"][k])


def test_replicated_outputs_agree_bitwise_across_ranks(port):
    """chi^2, PCG iteration counts, the GN trajectory (gathered), its chi^2
    and lambdas: the same bits on every rank."""
    for r in port[1:]:
        for case in ranks.PRECONDS + ("exact",):
            np.testing.assert_array_equal(r[case]["err"], port[0][case]["err"])
            assert r[case]["pcg_iters"] == port[0][case]["pcg_iters"]
        assert r["gn"]["digest"] == port[0]["gn"]["digest"]


def test_no_kernel_launch_under_a_group(port):
    assert [r["launches"] for r in port] == [0] * D


if __name__ == "__main__":
    # PART_REF for chip_smoke.py: the JAX package's partitioned GN on the
    # smoke's dist_scale graph and config, 4 fake CPU devices (run with
    # JAX_PLATFORMS=cpu; conftest.py is not loaded here)
    import os
    import sys

    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import chip_smoke
    from toyslam_tpu.sim import synthetic

    jg, _, _ = synthetic.make_large_problem(**chip_smoke.DIST_SCALE_GRAPH)
    cfg = JOpt(**chip_smoke.DIST_SCALE_CFG)
    solve = j_part(cfg, j_make_mesh(D, axis="dev"))
    res = JGaussNewton(cfg, solve=solve).optimize(jg)
    it = int(res.iterations_run)
    errors = np.asarray(res.errors)[:it]
    print("PART_REF = " + repr(dict(
        chi2=(float(errors[0]), float(errors[-1])),
        pcg_iters=np.asarray(res.pcg_iters)[:it].tolist(),
        boundary_pose_frac=solve.meta.boundary_pose_frac,
        boundary_lm_frac=solve.meta.boundary_lm_frac)))
