"""The PCR factorization kernel (csrc/pcr_factor.cu, ops/pcr.py) and the
dispatch of ``schur.build_tridiag_planes`` to it.

This file imports neither JAX nor the JAX package, so the GPU tests run on
a machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_pcr_factor.py

On the CPU ``build_tridiag_planes`` runs the plain version
``build_tridiag_planes_ref`` (held against the JAX package by
tests/test_torch_schur.py) and counts no launch; the wrapper's checks run
without a card.  Tests marked ``cuda`` hold the kernel's float32 factors
against the plain version in float64 on the card (max |kernel - plain|
within 1e-5 of max |plain|, for the alphas, the gammas and binv each) and
run the benchmark's paths through it; they skip without a GPU.
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from toyslam_torch.config import OptimizerConfig
from toyslam_torch.ops import fused_pcg as fp
from toyslam_torch.ops import pcr
from toyslam_torch.ops import schur

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
REL_TOL = 1e-5
# the kernel names the benchmark's b1_roofline and b2_roofline readers match
ROOFLINE_NAMES = ("fused_pcg_chunk_kernel", "fused_pcg_split_kernel",
                  "band_fused_pcg_chunk_kernel")


def _chain(n, dp, seed=0, dtype=torch.float32, device="cpu", sigma=None):
    """A random chain with SPD diagonal blocks that dominate their
    couplings, block layout ``[n, dp, dp]`` (the last upper block zero);
    ``sigma`` sets the couplings' spread instead."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, dp, dp))
    diag = a @ a.transpose(0, 2, 1) / dp + 2.0 * np.eye(dp)
    # couplings of norm ~1 at either dp (sigma 0.3 at dp=3), against a
    # diagonal whose eigenvalues are at least 2
    if sigma is None:
        sigma = 0.3 * (3 / dp) ** 0.5
    upper = rng.normal(0.0, sigma, size=(n, dp, dp))
    upper[-1] = 0.0
    return (torch.tensor(diag, dtype=dtype, device=device),
            torch.tensor(upper, dtype=dtype, device=device))


def _planes(t):
    return t.permute(1, 2, 0)


def _config(name):
    spec = json.loads((ROOT / "slambench" / "configs" / f"{name}.json")
                      .read_text())
    return spec, OptimizerConfig(**spec["optimizer"])


# --- without a card ----------------------------------------------------------


@pytest.mark.parametrize("n", [1, 7, 150])
@pytest.mark.parametrize("dp", [3, 6])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_and_float64_take_the_plain_version(dtype, dp, n):
    """A CPU input, float32 or float64, returns the plain version's factors
    bit for bit and launches nothing."""
    diag, upper = _chain(n, dp, seed=n, dtype=dtype)
    before = pcr.pcr_factor.launches
    got = schur.build_tridiag_planes(_planes(diag), _planes(upper))
    want = schur.build_tridiag_planes_ref(_planes(diag), _planes(upper))
    assert pcr.pcr_factor.launches == before
    assert got[0].shape == (pcr.pcr_levels(n), dp, dp, n)
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, w)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 192, 1025, 10_000])
def test_levels_from_poses_as_the_plain_version(n):
    """The levels the host gives the kernel from N are those the plain
    version builds."""
    diag, upper = _chain(n, 3, seed=n)
    al, ga, _ = schur.build_tridiag_planes_ref(_planes(diag), _planes(upper))
    assert al.shape[0] == ga.shape[0] == pcr.pcr_levels(n)


def test_kernel_is_built_for_the_fused_kernels_dps():
    assert pcr.DPS == fp.KERNEL_DPS
    with pytest.raises(ValueError, match="dp=4"):
        pcr._check(*_chain(12, 4))


def _bad_operands(case):
    diag, upper = _chain(12, 3)
    if case == "diag_shape":
        return diag[:, :, :2], upper
    if case == "upper_shape":
        return diag, upper[:-1]
    if case == "not_contiguous":
        return diag.transpose(1, 2), upper
    if case == "dp4":
        d4, u4 = _chain(12, 4)
        return d4, u4
    if case == "float64":
        return diag.double(), upper.double()
    return diag, upper                     # "cpu": valid, but no card


@pytest.mark.parametrize("case,err", [
    ("diag_shape", ValueError), ("upper_shape", ValueError),
    ("not_contiguous", ValueError), ("dp4", ValueError),
    ("float64", TypeError), ("cpu", ValueError),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(case, err):
    diag, upper = _bad_operands(case)
    before = pcr.pcr_factor.launches
    with pytest.raises(err):
        pcr.pcr_factor(diag, upper)
    assert pcr.pcr_factor.launches == before


def test_kernel_names_miss_the_roofline_readers():
    """The kernel's name contains none of the names the benchmark's
    b1_roofline and b2_roofline readers match (one more match would make
    their counts differ from the launches recorded)."""
    src = (ROOT / "toyslam_torch" / "csrc" / "pcr_factor.cu").read_text()
    names = set(re.findall(r"\b(\w+_kernel)\s*[(<]", src))
    assert names == {"pcr_factor_kernel"}
    assert not any(r in n for n in names for r in ROOFLINE_NAMES)


# --- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _assert_close(got, want):
    """Each factor within REL_TOL of the plain version's largest entry."""
    for name, g, w in zip(("alphas", "gammas", "binv"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        scale = float(w.abs().max())
        err = float((g.double() - w).abs().max())
        assert err <= REL_TOL * max(scale, 1e-30), (name, err, scale)


def _kernel_and_plain(diag, upper):
    """The kernel's factors through the dispatch (one counted launch) and
    the plain version's in float64 from the same float32 blocks."""
    before = pcr.pcr_factor.launches
    got = schur.build_tridiag_planes(_planes(diag), _planes(upper))
    assert pcr.pcr_factor.launches == before + 1
    want = schur.build_tridiag_planes_ref(_planes(diag.double()),
                                          _planes(upper.double()))
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3, 150, 192, 256, 257, 1024, 1025, 1088,
                               10_000])
@pytest.mark.parametrize("dp", [3, 6])
def test_kernel_matches_plain_version(cuda, dp, n):
    """Random SPD-dominant chains on one block and on several (a block
    holds 256 poses at dp=3, 128 at dp=6), one launch a build, and the same
    bits on a rerun."""
    diag, upper = _chain(n, dp, seed=n + dp, device=cuda)
    threads, _ = pcr.layout(dp)
    assert threads == {3: 256, 6: 128}[dp]
    got, want = _kernel_and_plain(diag, upper)
    again = schur.build_tridiag_planes(_planes(diag), _planes(upper))
    torch.cuda.synchronize()
    _assert_close(got, want)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [150, 1088, 10_000])
def test_kernel_within_float32s_error_on_loose_dp6_chains(cuda, n):
    """dp=6 couplings at sigma 0.3 (norm ~1.5 against diagonal eigenvalues
    of at least 2: not dominated), where float32 alone loses more than 1e-5
    at 10k poses: each factor's error within twice the larger of the plain
    version's own float32 errors, on the CPU and on the card."""
    diag, upper = _chain(n, 6, seed=n + 6, device=cuda, sigma=0.3)
    got, want = _kernel_and_plain(diag, upper)
    card = schur.build_tridiag_planes_ref(_planes(diag), _planes(upper))
    cpu = schur.build_tridiag_planes_ref(_planes(diag.cpu()),
                                         _planes(upper.cpu()))

    def err(g, w):
        return float((g.double().to(w.device) - w).abs().max())

    for name, g, w, pg, pc in zip(("alphas", "gammas", "binv"), got, want,
                                  card, cpu):
        f32 = max(err(pg, w), err(pc, w))
        assert err(g, w) <= 2 * f32, (name, err(g, w), f32,
                                      float(w.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dp", [3, 6])
def test_grid_stride_over_a_small_grid(cuda, dp):
    """The grid forced onto 2 blocks: every thread takes several poses."""
    diag, upper = _chain(1500, dp, seed=7, device=cuda)
    got = pcr.pcr_factor(diag, upper, blocks=2)
    want = schur.build_tridiag_planes_ref(_planes(diag.double()),
                                          _planes(upper.double()))
    _assert_close(got, want)


def _robot_system(device):
    """The toyslam-150 cell's first graph (seed 0) at its damped first
    linearization: the Schur system, its S diagonal and chain
    superdiagonal."""
    from slambench import generators
    from toyslam_torch.models.graph import graph_from_numpy
    from toyslam_torch.optimizer import GaussNewton

    spec, cfg = _config("toyslam-150")
    problem = generators.pool(spec["graph"], 0)[0]
    graph = GaussNewton(cfg)._prepare(
        graph_from_numpy(**problem["graph"])).to(device)
    sys = schur.assemble_blocks(graph, huber_delta=cfg.huber_delta,
                                fixed_prior=cfg.fixed_prior)
    lam = torch.tensor(cfg.lambda_init, device=device)
    d = schur.damp(sys, lam)
    hll_inv = schur.inv_blocks(d.hll)
    s_diag = schur.schur_s_diag(d, hll_inv, graph)
    upper = schur.chain_upper(d, graph.odom.i, graph.odom.j, graph.num_poses)
    return cfg, graph, sys, lam, s_diag, upper


@pytest.mark.cuda
def test_kernel_on_the_benchmark_graphs_s_diagonal(cuda):
    """The 150-pose benchmark graph's own S diagonal and chain coupling
    (pose 0 under the 1e6 gauge prior)."""
    _, graph, _, _, s_diag, upper = _robot_system(cuda)
    assert graph.num_poses == 192
    got, want = _kernel_and_plain(s_diag.contiguous(), upper.contiguous())
    _assert_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("plain_dtype", [torch.float32, torch.float64])
def test_b1_takes_as_many_iterations_with_the_kernels_factors(cuda,
                                                              plain_dtype):
    """One B1 solve of the benchmark graph's system with the kernel-built
    preconditioner and with the plain version's (built in float32, as
    before the kernel, or in float64): the same PCG iterations."""
    cfg, graph, sys, lam, s_diag, upper = _robot_system(cuda)
    d = schur.damp(sys, lam)
    hll_inv = schur.inv_blocks(d.hll)
    pre = fp.build_fused_precond(d, hll_inv, graph, s_diag, cfg.pcg_precond,
                                 cfg.pcg_coarse_group)
    planes = schur.build_tridiag_planes_ref(
        _planes(s_diag.to(plain_dtype)), _planes(upper.to(plain_dtype)))
    pre_plain = pre._replace(
        **{k: t.float().contiguous()
           for k, t in zip(("alphas", "gammas", "binv"), planes)})

    def iterations(p):
        _, _, stats = fp.fused_schur_solve(
            sys, graph, lam, cfg.pcg_tol, cfg.pcg_max_iters, cfg.pcg_precond,
            cfg.pcg_coarse_group, cfg.pcg_fused_chunk, cfg.pcg_restart_every,
            pre=p, mode="resident")
        return int(stats.pcg_iters)

    assert iterations(pre) == iterations(pre_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["toyslam-150", "sparse-10k"])
def test_benchmark_paths_launch_once_per_build(cuda, cell):
    """One optimize of each configuration's first graph: one launch per
    preconditioner build -- a build every GN iteration at 150 poses, every
    5th of 15 at 10k."""
    from slambench import generators
    from toyslam_torch.models.graph import graph_from_numpy
    from toyslam_torch.optimizer import GaussNewton

    spec, cfg = _config(cell)
    problem = generators.pool(spec["graph"], 0)[0]
    gn = GaussNewton(cfg)
    graph = gn._prepare(graph_from_numpy(**problem["graph"])).to(cuda)
    before = pcr.pcr_factor.launches
    res = gn.optimize(graph)
    torch.cuda.synchronize()
    builds = -(-res.iterations_run // cfg.pcg_precond_refresh)
    assert pcr.pcr_factor.launches - before == builds


@pytest.mark.cuda
def test_float64_and_other_dps_on_the_card(cuda):
    """On the card every build is the kernel's: float64, which it does not
    take, and float32 at a dp it is not built for raise, as B1's wrapper
    does, and launch nothing."""
    diag, upper = _chain(40, 3, dtype=torch.float64, device=cuda)
    before = pcr.pcr_factor.launches
    with pytest.raises(TypeError, match="float32"):
        schur.build_tridiag_planes(_planes(diag), _planes(upper))
    d4, u4 = _chain(40, 4, device=cuda)
    with pytest.raises(ValueError, match="dp=4"):
        schur.build_tridiag_planes(_planes(d4), _planes(u4))
    assert pcr.pcr_factor.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dp", [3, 6])
def test_kernel_keeps_its_registers(cuda, dp):
    """No instantiation spills to local memory."""
    attrs = pcr.pcr_kernel_attrs(dp)
    assert attrs["local_bytes"] == 0, attrs


@pytest.mark.cuda
def test_profiler_names_the_kernel_apart_from_b1_and_b2(cuda):
    """The profiler shows one kernel event a launch, named
    pcr_factor_kernel, which no roofline reader matches."""
    diag, upper = _chain(192, 3, device=cuda)
    schur.build_tridiag_planes(_planes(diag), _planes(upper))
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        schur.build_tridiag_planes(_planes(diag), _planes(upper))
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    ours = [n for n in names if "pcr_factor_kernel" in n]
    assert len(ours) == 1, names
    assert not any(r in n for n in names for r in ROOFLINE_NAMES)
