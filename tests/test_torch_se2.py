"""The port's SE(2) helpers against the JAX package's on the same seeded
inputs (atol 1e-6): ``rotation``, ``identity``, ``transform_point``,
``to_matrix``, ``from_matrix`` and ``euclidean_to_radial``, with the
round trips they promise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toyslam_tpu.ops import se2 as j_se2
from toyslam_torch.ops import se2 as t_se2

ATOL = 1e-6


def _poses(seed, shape=(4, 5)):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=shape + (3,)).astype(np.float32) * 5.0
    p[..., 2] = rng.uniform(-np.pi, np.pi, size=shape).astype(np.float32)
    return p


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_rotation(seed):
    th = _poses(seed)[..., 2]
    _close(t_se2.rotation(torch.from_numpy(th)), j_se2.rotation(jnp.asarray(th)))


@pytest.mark.parametrize("batch", [(), (7,), (2, 3)])
def test_identity(batch):
    t, j = t_se2.identity(batch), j_se2.identity(batch)
    assert tuple(t.shape) == j.shape and t.dtype == torch.float32
    _close(t, j)
    p = torch.from_numpy(_poses(2, batch))
    torch.testing.assert_close(t_se2.compose(p, t), p, rtol=0, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_transform_point(seed):
    p = _poses(seed)
    pt = np.random.default_rng(seed + 10).normal(size=(4, 5, 2)).astype(
        np.float32) * 3.0
    got = t_se2.transform_point(torch.from_numpy(p), torch.from_numpy(pt))
    _close(got, j_se2.transform_point(jnp.asarray(p), jnp.asarray(pt)))
    back = t_se2.inv_transform_point(torch.from_numpy(p), got)
    np.testing.assert_allclose(back.numpy(), pt, rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_to_and_from_matrix(seed):
    p = _poses(seed)
    m = t_se2.to_matrix(torch.from_numpy(p))
    _close(m, j_se2.to_matrix(jnp.asarray(p)))
    mats = np.asarray(j_se2.to_matrix(jnp.asarray(p)))
    _close(t_se2.from_matrix(torch.from_numpy(mats)),
           j_se2.from_matrix(jnp.asarray(mats)))
    np.testing.assert_allclose(t_se2.from_matrix(m).numpy(), p, rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_euclidean_to_radial(seed):
    pt = np.random.default_rng(seed).normal(size=(6, 2)).astype(np.float32)
    got = t_se2.euclidean_to_radial(torch.from_numpy(pt))
    _close(got, j_se2.euclidean_to_radial(jnp.asarray(pt)))
    np.testing.assert_allclose(t_se2.radial_to_euclidean(got).numpy(), pt,
                               rtol=0, atol=ATOL)
