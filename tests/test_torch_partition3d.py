"""The port's partitioned SE(3)/BA solve on 4 gloo ranks on the CPU, on the
input and at the tolerances of ``tests/test_partition3d.py``
(``make_ba_problem(48, 160, 16, seed=1)``):

* ``jacobi`` and ``chunk+coarse`` in float32: chi^2 against the JAX
  package's (rtol 1e-5) and dx_p against the port's single-device solve
  (atol 5e-3 of max|dx|, rtol 2e-2), as the JAX test holds its partitioned
  solve to its single-device one.  The f32 dx_l and the f32 dx across the
  packages sit at the f32 floor of this cond ~3e6 system, beyond that
  tolerance: the JAX package's own partitioned solve on 4 devices misses
  it against its single-device plain loop on dx_l by 1.1x (chunk+coarse),
  and the two packages' single-device solves differ by 0.9-1.0x of it.  So
  dx_l, and the packages against each other, are held in float64;
* the float64 pin: partitioned against single-device (relative deviation
  below 1e-9) and against the JAX package's float64 partitioned solve
  (below 1e-8);
* GN end to end in float64 through ``gather_result``, with full steps
  (lr 1.0): the trajectory and every chi^2 against the port's
  single-device float64 run, and the ATE below 0.3 of the initial one.
  The JAX test's lr 0.2 over 12 iterations leaves the state in a flat
  valley where the ATE is not a property of the algorithm: there the
  exact (float64) run ends at 0.33 of the initial ATE, the JAX package's
  single-device run at 0.52 and its partitioned one at 0.24; the float64
  optimum that full steps reach (5 iterations) sits at 0.27.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from toyslam_tpu.config import OptimizerConfig as JOpt
from toyslam_tpu.ops import schur3d as j_schur3d
from toyslam_tpu.ops import schur3d as j_schur3d
from toyslam_tpu.parallel import make_mesh as j_make_mesh
from toyslam_tpu.parallel import partitioned_linearize_solve as j_part
from toyslam_tpu.sim import synthetic3d as j_synth3d
from toyslam_torch.bridge import graph3d_from_arrays
from toyslam_torch.config import OptimizerConfig
from toyslam_torch.optimizer import GaussNewton
from toyslam_torch.ops import schur3d as t_schur3d
from toyslam_torch.parallel.launch import run_ranks
from toyslam_torch.sim import synthetic3d as t_synth3d

torch.set_num_threads(1)
D = 4
CFG = dict(solver="schur3d", pcg_tol=1e-10, pcg_max_iters=800,
           pcg_precond="jacobi", pcg_chunk=8, pcg_coarse_group=8,
           exact_odom_jacobians=True)
CFG64 = dict(CFG, pcg_precond="chunk+coarse", pcg_tol=1e-14,
             pcg_max_iters=2000, pcg_backend="xla")
GN = dict(CFG, iterations=6, lr=1.0, pcg_precond="chunk+coarse",
          pcg_tol=1e-8, reject_worse_steps=True, huber_delta=4.0,
          pcg_backend="xla")


@pytest.fixture(scope="module")
def problem():
    jg, poses_gt, _ = j_synth3d.make_ba_problem(
        num_poses=48, num_landmarks=160, obs_per_pose=16, seed=1)
    return jg, graph3d_from_arrays(jg), poses_gt


@pytest.fixture(scope="module")
def port(problem):
    return run_ranks(ranks.partition3d_cases, D, "cpu",
                     (problem[1], CFG, CFG64, GN))


@pytest.fixture(scope="module")
def mesh():
    return j_make_mesh(D, axis="dev")


def _blocks(port, case, key):
    return np.concatenate([r[case][key] for r in port])


def _to_f64(tree):
    return jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float64)
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating)
        else x, tree)


def _single(tg, cfg_kw, dtype=torch.float32):
    """The port's single-device solve (dx_p, dx_l, err) at lambda 1e-3."""
    cfg = OptimizerConfig(**cfg_kw)
    g = GaussNewton(cfg)._prepare(tg).astype(dtype)
    return t_schur3d.schur3d_linearize_solve(cfg)(
        g, torch.tensor(1e-3, dtype=dtype))[:3]


@pytest.mark.parametrize("precond", ["jacobi", "chunk+coarse"])
def test_partitioned3d_solve_matches_single_device(problem, port, precond):
    jg, tg, _ = problem
    n = tg.num_poses
    cfg = JOpt(**dict(CFG, pcg_precond=precond))
    jerr = jax.jit(lambda g: j_schur3d.assemble_blocks_3d(
        g, cfg.huber_delta, fixed_prior=cfg.fixed_prior,
        exact_odom_jacobians=cfg.exact_odom_jacobians).err)(jg)
    got = port[0][precond]
    np.testing.assert_allclose(float(got["err"]), float(jerr), rtol=1e-5)
    dxp, _, err = _single(tg, dict(CFG, pcg_precond=precond))
    np.testing.assert_allclose(float(got["err"]), float(err), rtol=1e-5)
    ref = dxp.numpy()[:n]
    np.testing.assert_allclose(_blocks(port, precond, "dxp")[:n], ref,
                               atol=5e-3 * max(np.abs(ref).max(), 1e-9),
                               rtol=2e-2)
    assert np.isfinite(_blocks(port, precond, "dxl")).all()


def test_partitioned3d_f64_matches_single_device(problem, port):
    """The f64 pin: in float64 the partitioned and the single-device solve
    agree to ~1e-9, so any structural error (a wrong boundary column, a
    missing observation, a bad collective) would show at O(1)."""
    tg = problem[1]
    n, m = tg.num_poses, tg.num_landmarks
    dxp, dxl, err = _single(tg, CFG64, torch.float64)
    got = port[0]["f64"]
    assert got["dxp"].dtype == np.float64
    np.testing.assert_allclose(float(got["err"]), float(err), rtol=1e-12)
    ref = dxp.numpy()[:n]
    dev = np.abs(_blocks(port, "f64", "dxp")[:n] - ref).max()
    assert dev <= 1e-9 * np.abs(ref).max(), (dev, np.abs(ref).max())
    refl = dxl.numpy()[:m]
    got_l = port[0]["meta"].unpermute_landmarks(_blocks(port, "f64", "dxl"),
                                                m)
    assert np.abs(got_l - refl).max() <= 1e-9 * np.abs(refl).max()


def test_partitioned3d_f64_matches_jax(problem, port, mesh):
    """The same float64 solve against the JAX package's partitioned one
    under ``jax.enable_x64`` (relative deviation below 1e-8)."""
    jg = problem[0]
    n = jg.num_poses
    with jax.enable_x64(True):
        solve = j_part(JOpt(**CFG64), mesh)
        pg = _to_f64(solve.prepare(_to_f64(jg)))
        dxp, _, err, _ = jax.jit(solve)(pg, jnp.asarray(1e-3, jnp.float64))
        ref = np.asarray(dxp)[:n]
        err = float(err)
    np.testing.assert_allclose(float(port[0]["f64"]["err"]), err,
                               rtol=1e-12)
    dev = np.abs(_blocks(port, "f64", "dxp")[:n] - ref).max()
    assert dev <= 1e-8 * np.abs(ref).max(), (dev, np.abs(ref).max())


def test_partitioned3d_gauss_newton_matches_single_device(problem, port):
    """GN in float64: the partitioned run's trajectory and chi^2 are the
    single-device run's, and the ATE falls below 0.3 of the initial one.
    The two runs' preconditioners differ (the partitioned one drops the
    chain coupling across ranks and has the three-level coarse level), so
    each PCG solve (tol 1e-8) stops at another point within its tolerance:
    chi^2 is held at rtol 1e-6 and the poses at atol 1e-5, a hundred times
    that."""
    jg, tg, poses_gt = problem
    n = poses_gt.shape[0]
    ref = GaussNewton(OptimizerConfig(**GN)).optimize(tg.astype(torch.float64))
    it = ref.iterations_run
    ate0 = t_synth3d.pose_ate_rmse(np.asarray(jg.poses)[:n], poses_gt)
    for r in port:
        assert r["gn"]["iterations_run"] == it
        np.testing.assert_allclose(r["gn"]["errors"][:it],
                                   ref.errors.numpy()[:it], rtol=1e-6)
        np.testing.assert_allclose(r["gn"]["poses"][:n],
                                   ref.graph.poses.numpy()[:n], atol=1e-5)
        ate = t_synth3d.pose_ate_rmse(r["gn"]["poses"][:n], poses_gt)
        assert ate < 0.3 * ate0, (ate, ate0)
    assert len({r["gn"]["digest"] for r in port}) == 1


def test_no_kernel_launch_under_a_group(port):
    assert [r["launches"] for r in port] == [0] * D

