"""The SE(3) operations and edge linearization of the PyTorch port against
the JAX package, on seeded random batches handed to both as numpy.

* every ``ops/se3.py`` function, including both branches of ``log_so3``
  (series near the identity, arccos elsewhere, the clip near pi), at the
  tolerances of tests/test_se3.py (1e-5; 1e-4 for the near-pi angle);
* odometry and reprojection residuals, Huber weights and per-edge
  Jacobians at 1e-5, the exact odometry Jacobians (``torch.func.jacfwd``)
  against ``jax.jacfwd``, finite at an identity residual;
* the reprojection edge blocks at 1e-5 of each block's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toyslam_tpu.ops import edge_blocks3d as j_eb3
from toyslam_tpu.ops import residuals3d as j_res3
from toyslam_tpu.ops import se3 as j_se3
from toyslam_torch.ops import edge_blocks3d as t_eb3
from toyslam_torch.ops import residuals3d as t_res3
from toyslam_torch.ops import se3 as t_se3

torch.set_num_threads(1)
TOL = 1e-5


def _poses(rng, n, angle=0.5):
    """Random flat SE(3) poses: rotations exp(w) with |w| up to ``angle``."""
    w = rng.normal(size=(n, 3))
    w *= (angle * rng.uniform(size=(n, 1))) / np.linalg.norm(w, axis=1,
                                                              keepdims=True)
    R = np.asarray(j_se3.exp_so3(jnp.asarray(w, jnp.float32)))
    t = rng.normal(scale=3.0, size=(n, 3))
    return np.concatenate([R.reshape(n, 9), t], axis=1).astype(np.float32)


def _both(fn_name, *args):
    """(port, reference) of one se3 function on the same numpy inputs."""
    ref = getattr(j_se3, fn_name)(*(jnp.asarray(a) for a in args))
    port = getattr(t_se3, fn_name)(*(torch.tensor(a) for a in args))
    return port.numpy(), np.asarray(ref)


@pytest.mark.parametrize("fn_name,arity", [
    ("rot", 1), ("trans", 1), ("compose", 2), ("inverse", 1),
    ("relative", 2), ("retract", -1), ("log", 1), ("orthonormalize", 1),
])
def test_pose_functions_match_jax(fn_name, arity):
    rng = np.random.default_rng(0)
    a, b = _poses(rng, 64), _poses(rng, 64)
    if arity == -1:   # retract takes a tangent step
        args = (a, rng.normal(scale=0.3, size=(64, 6)).astype(np.float32))
    else:
        args = (a, b)[:arity]
    port, ref = _both(fn_name, *args)
    np.testing.assert_allclose(port, ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("fn_name", ["transform_point", "inv_transform_point"])
def test_point_functions_match_jax(fn_name):
    rng = np.random.default_rng(1)
    pts = rng.uniform(-3.0, 3.0, size=(64, 3)).astype(np.float32)
    port, ref = _both(fn_name, _poses(rng, 64), pts)
    np.testing.assert_allclose(port, ref, atol=1e-4, rtol=TOL)


def test_make_identity_hat_match_jax():
    rng = np.random.default_rng(2)
    w = rng.normal(size=(16, 3)).astype(np.float32)
    np.testing.assert_array_equal(*_both("hat", w))
    R = rng.normal(size=(16, 3, 3)).astype(np.float32)
    t = rng.normal(size=(16, 3)).astype(np.float32)
    np.testing.assert_array_equal(*_both("make", R, t))
    np.testing.assert_array_equal(t_se3.identity((5,)).numpy(),
                                  np.asarray(j_se3.identity((5,))))


@pytest.mark.parametrize("scale", [0.0, 1e-5, 1e-2, 1.0, 3.0])
def test_exp_and_log_so3_match_jax_on_each_branch(scale):
    """exp at zero, in its series and past it; log in its series (scale up
    to 1e-2: cos > 1 - 1e-6 holds below ~1.4e-3), in the arccos branch and
    near pi, where the angle is clipped."""
    rng = np.random.default_rng(3)
    w = rng.normal(size=(32, 3))
    w = (scale * w / np.linalg.norm(w, axis=1, keepdims=True))
    w = w.astype(np.float32)
    R_port, R_ref = _both("exp_so3", w)
    np.testing.assert_allclose(R_port, R_ref, atol=TOL)
    l_port, l_ref = _both("log_so3", np.array(R_ref))
    np.testing.assert_allclose(l_port, l_ref, atol=1e-4 if scale > 2 else TOL)
    assert np.isfinite(l_port).all()


def _odom_edges(rng, e):
    a, b = _poses(rng, e), _poses(rng, e)
    # measurements near the true relative motion: small residuals
    rel = np.asarray(j_se3.relative(jnp.asarray(a), jnp.asarray(b)))
    meas = np.array(j_se3.retract(
        jnp.asarray(rel),
        jnp.asarray(rng.normal(scale=0.05, size=(e, 6)), jnp.float32)))
    meas[0] = rel[0]     # an identity residual: the series branch of log
    info = np.diag([400.0] * 3 + [1e4] * 3).astype(np.float32)
    info = np.broadcast_to(info, (e, 6, 6)).copy()
    mask = np.ones(e, np.float32)
    mask[-3:] = 0.0
    poses = np.concatenate([a, b])
    i, j = np.arange(e), e + np.arange(e)
    return poses, i, j, meas.astype(np.float32), info, mask


@pytest.mark.parametrize("exact", [False, True])
def test_odom3d_edges_match_jax(exact):
    rng = np.random.default_rng(4)
    poses, i, j, meas, info, mask = _odom_edges(rng, 48)
    ref = j_res3.eval_odom3d_edges(
        jnp.asarray(poses), jnp.asarray(i), jnp.asarray(j),
        jnp.asarray(meas), jnp.asarray(info), jnp.asarray(mask),
        huber_delta=6.0, exact=exact)
    port = t_res3.eval_odom3d_edges(
        torch.as_tensor(poses), torch.as_tensor(i), torch.as_tensor(j),
        torch.as_tensor(meas), torch.as_tensor(info), torch.as_tensor(mask),
        huber_delta=6.0, exact=exact)
    for name in ref._fields:
        p, r = getattr(port, name).numpy(), np.asarray(getattr(ref, name))
        assert p.dtype == np.float32, name
        assert np.isfinite(p).all(), name
        scale = max(float(np.abs(r).max()), 1.0)
        np.testing.assert_allclose(p, r, atol=TOL * scale, err_msg=name)
    # some edges are robustified, some are not
    w = port.w.numpy()[:-3]
    assert (w < 1.0).any() and (w == 1.0).any()


def test_exact_odom_jacobians_match_jax_jacfwd_directly():
    """The port's torch.func Jacobians against jax.jacfwd of the same
    residual, per edge, at 1e-5: at an identity residual too."""
    rng = np.random.default_rng(5)
    poses, i, j, meas, _, _ = _odom_edges(rng, 16)
    pi, pj = poses[i], poses[j]

    def res(eps_a, eps_b, a, b, m):
        return j_se3.log(j_se3.compose(
            j_se3.inverse(m), j_se3.relative(j_se3.retract(a, eps_a),
                                             j_se3.retract(b, eps_b))))

    z = jnp.zeros((16, 6), jnp.float32)
    ja = jax.vmap(jax.jacfwd(res, argnums=0))(z, z, pi, pj, meas)
    jb = jax.vmap(jax.jacfwd(res, argnums=1))(z, z, pi, pj, meas)
    zt = torch.zeros(16, 6)
    ta, tb = torch.func.vmap(torch.func.jacfwd(
        t_res3._odom3d_tangent_residual, argnums=(0, 1)))(
            zt, zt, torch.as_tensor(pi), torch.as_tensor(pj),
            torch.as_tensor(meas))
    np.testing.assert_allclose(ta.float().numpy(), np.asarray(ja), atol=TOL)
    np.testing.assert_allclose(tb.float().numpy(), np.asarray(jb), atol=TOL)


def test_reprojection_edges_and_blocks_match_jax():
    rng = np.random.default_rng(6)
    e = 64
    poses = _poses(rng, e)
    # landmarks in front of each camera, pixels near their projections
    x_c = np.stack([rng.uniform(-2, 2, e), rng.uniform(-2, 2, e),
                    rng.uniform(3, 9, e)], axis=1)
    R = poses[:, :9].reshape(e, 3, 3)
    lms = (np.einsum("eij,ej->ei", R, x_c) + poses[:, 9:]).astype(np.float32)
    K = np.asarray([500.0, 500.0, 320.0, 240.0], np.float32)
    uv = np.stack([500 * x_c[:, 0] / x_c[:, 2] + 320,
                   500 * x_c[:, 1] / x_c[:, 2] + 240], axis=1)
    meas = (uv + rng.normal(scale=3.0, size=uv.shape)).astype(np.float32)
    info = np.broadcast_to(np.eye(2, dtype=np.float32), (e, 2, 2)).copy()
    mask = np.ones(e, np.float32)
    mask[:2] = 0.0
    idx = np.arange(e)
    args = (poses, lms, K, idx, idx, meas, info, mask)
    for j_fn, t_fn in ((j_res3.eval_reproj_edges, t_res3.eval_reproj_edges),
                       (j_eb3.reproj_edge_blocks, t_eb3.reproj_edge_blocks)):
        ref = j_fn(*(jnp.asarray(a) for a in args), huber_delta=4.0)
        port = t_fn(*(torch.as_tensor(a) for a in args), huber_delta=4.0)
        for name in ref._fields:
            p, r = getattr(port, name).numpy(), np.asarray(getattr(ref, name))
            scale = max(float(np.abs(r).max()), 1.0)
            np.testing.assert_allclose(p, r, atol=TOL * scale, err_msg=name)
    w = t_res3.eval_reproj_edges(*(torch.as_tensor(a) for a in args),
                                 huber_delta=4.0).w.numpy()[2:]
    assert (w < 1.0).any() and (w == 1.0).any()
