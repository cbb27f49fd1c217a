"""The dense solver of the PyTorch port (``ops/assemble.py``,
``optimizer/gauss_newton.py::dense_linearize_solve``) against the JAX
package:

* ``assemble_dense`` on the 150-pose graph at tests/test_assemble.py's
  tolerances (b at rtol 2e-3 / atol 2e-3, H at rtol 2e-3 / atol 2e-2, the
  error at rtol 1e-4), ``state_masks`` exactly, ``total_error`` at 1e-5;
* the dense GN (cholesky and lu) on the 150-pose graph: chi^2 per
  iteration at rtol 1e-4 and poses at atol 1e-3 against the JAX package,
  ATE 0.7552 within 2e-3, chi^2 228733.53 -> 27524.9;
* ``python -m toyslam_torch run --solver dense --device cpu``.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_app import _python
from toyslam_tpu.config import OptimizerConfig as JOpt
from toyslam_tpu.config import SimConfig as JSim, SlamConfig as JSlam
from toyslam_tpu.ops import assemble as j_asm
from toyslam_tpu.optimizer.gauss_newton import GaussNewton as JGN
from toyslam_tpu.sim import frontend as jf
from toyslam_torch.bridge import graph_from_arrays
from toyslam_torch.config import OptimizerConfig as TOpt
from toyslam_torch.config import SimConfig as TSim, SlamConfig as TSlam
from toyslam_torch.ops import assemble as t_asm
from toyslam_torch.ops import fused_pcg
from toyslam_torch.optimizer import GaussNewton as TGN
from toyslam_torch.sim import frontend as tf

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def graphs():
    jg = jf.build_graph(jf.simulate(JSim()), JSlam())[0]
    rng = np.random.default_rng(5)
    # a moved state: at the dead-reckoned start the odometry residuals are
    # f32 rounding noise
    poses = np.asarray(jg.poses) + rng.normal(
        0.0, [0.2, 0.2, 0.03], jg.poses.shape).astype(np.float32)
    jg = jg.with_state(jnp.asarray(poses), jg.landmarks)
    return jg, graph_from_arrays(jg)


@pytest.mark.parametrize("exact", [False, True], ids=["identity", "exact"])
def test_assemble_dense_matches_jax(graphs, exact):
    jg, tg = graphs
    js = j_asm.assemble_dense(jg, 1.5, exact_odom_jacobians=exact)
    ts = t_asm.assemble_dense(tg, 1.5, exact_odom_jacobians=exact)
    np.testing.assert_allclose(float(ts.err), float(js.err), rtol=1e-4)
    np.testing.assert_allclose(ts.b.numpy(), np.asarray(js.b), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(ts.H.numpy(), np.asarray(js.H), rtol=2e-3,
                               atol=2e-2)
    for name in ("fixed", "padded"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)))
    fixed, padded = t_asm.state_masks(tg)
    assert torch.equal(fixed, ts.fixed) and torch.equal(padded, ts.padded)
    np.testing.assert_allclose(
        float(t_asm.total_error(tg, 1.5, exact)),
        float(j_asm.total_error(jg, 1.5, exact)), rtol=1e-5)


@pytest.mark.parametrize("factorization", ["cholesky", "lu"])
def test_dense_gn_matches_jax(factorization):
    cfg = dict(iterations=10, lr=0.2, solver="dense",
               dense_factorization=factorization)
    jr = JGN(JOpt(**cfg)).optimize(
        jf.build_graph(jf.simulate(JSim()), JSlam())[0])
    sim = tf.simulate(TSim())
    tg = tf.build_graph(sim, TSlam())[0]
    before = fused_pcg.fused_pcg_chunk.launches
    gn = TGN(TOpt(**cfg))
    assert gn.config.solver == TOpt().solver == "dense"   # the default
    tr = gn.optimize(tg)
    assert fused_pcg.fused_pcg_chunk.launches == before
    assert tr.graph.plan is None             # no gather plan for dense
    np.testing.assert_allclose(tr.errors.numpy(), np.asarray(jr.errors),
                               rtol=1e-4)
    np.testing.assert_allclose(tr.graph.poses.numpy(),
                               np.asarray(jr.graph.poses), atol=1e-3)
    assert tr.pcg_iters.tolist() == [0] * 10
    assert tr.pcg_residuals.tolist() == [0.0] * 10
    np.testing.assert_allclose(tr.errors[0].item(), 228733.53, rtol=1e-4)
    np.testing.assert_allclose(tr.errors[-1].item(), 27524.9, rtol=1e-3)
    n = sim.poses_gt.shape[0]
    assert abs(tf.ate_rmse(tr.graph.poses[:n], sim.poses_gt) - 0.7552) <= 2e-3


def test_dense_reject_worse_steps_matches_jax():
    """LM step rejection with the dense solve: its error function is
    ``assemble.total_error``."""
    cfg = dict(iterations=4, lr=1.0, solver="dense", reject_worse_steps=True)
    jg = jf.build_graph(jf.simulate(JSim(robot_steps=40)), JSlam())[0]
    tg = tf.build_graph(tf.simulate(TSim(robot_steps=40)), TSlam())[0]
    gn = TGN(TOpt(**cfg))
    assert gn.error_fn.func is t_asm.total_error
    tr = gn.optimize(tg)
    jr = JGN(JOpt(**cfg)).optimize(jg)
    np.testing.assert_allclose(tr.errors.numpy(), np.asarray(jr.errors),
                               rtol=1e-4)
    np.testing.assert_allclose(tr.lambdas.numpy(), np.asarray(jr.lambdas),
                               rtol=1e-6)


def test_cli_run_dense():
    proc = _python("-m", "toyslam_torch", "run", "--solver", "dense",
                   "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    m = json.loads(proc.stdout.strip().splitlines()[-1])
    assert m["cmd"] == "run" and m["poses"] == 150
    assert abs(m["ate_rmse"] - 0.7552) <= 2e-3
    np.testing.assert_allclose(m["chi2_first"], 228733.53, rtol=1e-4)
    np.testing.assert_allclose(m["chi2_final"], 27524.9, rtol=1e-3)
    assert m["pcg_iters"] == [0] * 10 and m["kernel_launches"] == 0
