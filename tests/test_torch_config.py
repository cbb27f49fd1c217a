"""Config parity: the PyTorch port's dataclasses against the JAX package's
(same fields, same defaults, same derived values, same __post_init__
errors)."""

import dataclasses

import pytest

from toyslam_tpu import config as jcfg
from toyslam_torch import config as tcfg

CLASSES = ["LidarConfig", "NoiseConfig", "SimConfig", "OptimizerConfig",
           "SlamConfig"]


@pytest.mark.parametrize("name", CLASSES)
def test_fields_and_defaults_match(name):
    jc, tc = getattr(jcfg, name), getattr(tcfg, name)
    assert [f.name for f in dataclasses.fields(tc)] == [
        f.name for f in dataclasses.fields(jc)
    ]
    assert dataclasses.asdict(tc()) == dataclasses.asdict(jc())
    assert tc.__dataclass_params__.frozen


@pytest.mark.parametrize("variance_as_std", [True, False])
def test_derived_values_match(variance_as_std):
    jn = jcfg.NoiseConfig(variance_as_std=variance_as_std, lidar_std=0.2)
    tn = tcfg.NoiseConfig(variance_as_std=variance_as_std, lidar_std=0.2)
    assert tn.sample_scales() == jn.sample_scales()
    assert tn.lidar_information_diag() == jn.lidar_information_diag()
    assert tn.odom_information_diag() == jn.odom_information_diag()
    assert tcfg.LidarConfig().ray_count == jcfg.LidarConfig().ray_count


@pytest.mark.parametrize("bad", [
    {"pcg_precond": "ilu"},
    {"pcg_precond": "tridiag+fine"},
    {"solver": "cholmod"},
    {"edge_backend": "pallas"},
    {"pcg_backend": "triton"},
    {"pcg_coarse_group2": 0},
    {"pcg_fused_chunk": 0},
])
def test_post_init_rejects_what_the_reference_rejects(bad):
    key = next(iter(bad))
    with pytest.raises(ValueError, match=key):
        jcfg.OptimizerConfig(**bad)
    with pytest.raises(ValueError, match=key):
        tcfg.OptimizerConfig(**bad)


@pytest.mark.parametrize("ok", [
    {"pcg_precond": "chunk+coarse"},
    {"solver": "schur3d"},
    {"pcg_backend": "xla"},
])
def test_post_init_accepts_what_the_reference_accepts(ok):
    assert dataclasses.asdict(tcfg.OptimizerConfig(**ok)) == \
        dataclasses.asdict(jcfg.OptimizerConfig(**ok))
