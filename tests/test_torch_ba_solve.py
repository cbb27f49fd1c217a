"""The SE(3) bundle-adjustment solve of the PyTorch port (the kernels'
plain versions, as on the CPU) against the JAX package's, on the 96-pose,
300-point graph of tests/test_fused_pcg.py:

* a resident dp=6 solve against the JAX package's plain PCG solve at 1e-3
  of max|dx| (tests/test_fused_pcg.py's bar);
* six Gauss-Newton iterations against the JAX package's plain PCG loop at
  rtol 1e-4 on chi^2 and atol 1e-3 on poses (the bar of the JAX package's
  own fused-vs-plain parity test on this graph);

The ``ba3d`` subcommand against the JAX app's is in test_torch_ba_cli.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toyslam_tpu.config import OptimizerConfig as JOpt
from toyslam_tpu.ops import schur as j_schur
from toyslam_tpu.ops import schur3d as j_schur3d
from toyslam_tpu.ops.gather_plan import attach_plan as j_attach_plan
from toyslam_tpu.optimizer import GaussNewton as JGN
from toyslam_tpu.sim import synthetic3d as j_syn3
from toyslam_torch.config import OptimizerConfig
from toyslam_torch.ops import fused_pcg as fp
from toyslam_torch.ops import schur3d
from toyslam_torch.ops.gather_plan import attach_plan
from toyslam_torch.optimizer import GaussNewton
from toyslam_torch.sim import synthetic3d

torch.set_num_threads(1)
LAM = 1e-3


def _rel(port, ref):
    port = port.detach().double().numpy()
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    return float(np.abs(port - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def small():
    jg = j_attach_plan(j_syn3.make_ba_problem(96, 300, seed=0)[0])
    tg = attach_plan(synthetic3d.make_ba_problem(96, 300, seed=0)[0])
    return jg, tg


def test_resident_dp6_solve_matches_jax_plain_solve(small):
    jg, tg = small
    js = j_schur3d.assemble_blocks_3d(jg, 1.5)
    ts = schur3d.assemble_blocks_3d(tg, 1.5)
    dxp0, _, _ = j_schur.schur_solve(js, jg, jnp.float32(LAM), 1e-6, 300,
                                     None, 64, "tridiag", 64)
    dxp1, dxl1, st1 = fp.fused_schur_solve(
        ts, tg, torch.tensor(LAM), 1e-6, 300, "tridiag", 64, 16, 64,
        mode="resident")
    assert tuple(dxp1.shape) == (128, 6) and tuple(dxl1.shape[1:]) == (3,)
    assert _rel(dxp1, dxp0) < 1e-3
    assert int(st1.pcg_iters) < 300




GN = dict(solver="schur3d", pcg_precond="tridiag", iterations=6,
          reject_worse_steps=True)


def test_gauss_newton_matches_jax(small):
    """The JAX package's own fused-vs-plain parity config
    (tests/test_fused_pcg.py::test_gauss_newton_se3_parity): the port's
    plain versions against its plain PCG loop."""
    jg, tg = small
    rj = JGN(JOpt(**GN, pcg_backend="xla")).optimize(jg)
    rt = GaussNewton(OptimizerConfig(**GN)).optimize(tg)
    ej, et = np.asarray(rj.errors), rt.errors.numpy()
    valid = ~np.isnan(ej)
    assert rt.iterations_run == int(rj.iterations_run)
    np.testing.assert_allclose(et[valid], ej[valid], rtol=1e-4)
    np.testing.assert_allclose(rt.graph.poses.numpy(),
                               np.asarray(rj.graph.poses), atol=1e-3)


def test_gauss_newton_schur3d_pieces():
    from toyslam_torch.ops import se3

    gn = GaussNewton(OptimizerConfig(**GN))
    assert gn.retract is se3.retract
    assert gn.error_fn.func is schur3d.total_error_3d
