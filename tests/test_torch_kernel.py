"""The fused-PCG chunk wrappers and their hand-written CUDA kernels (the
resident B1; the band B2 on the card only, its CPU side is in
test_torch_band.py).

This file imports neither JAX nor the JAX package, so the GPU tests run on
a machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernel.py

On the CPU the wrapper runs its plain PyTorch version and counts no launch,
and it validates what it would hand the kernel.  Tests marked ``cuda``
launch the kernel, compare it with the plain version on the same inputs
(x at rel 1e-4; r_true within 1e-4 of max|rhs|; the same ``it`` and
``stop``) and run the main path through it; they skip without a GPU.
"""

import numpy as np
import pytest
import torch

from toyslam_torch.config import OptimizerConfig, SimConfig, SlamConfig
from toyslam_torch.ops import fused_pcg as fp
from toyslam_torch.ops import schur
from toyslam_torch.ops.blockmath import mv
from toyslam_torch.ops.gather_plan import attach_plan
from toyslam_torch.optimizer import GaussNewton
from toyslam_torch.sim import frontend

torch.set_num_threads(1)


def _tiny_system(np_=16, mw=8, nc=0, seed=0):
    """A small SPD system in the kernel layout, block-Jacobi preconditioned,
    with an optional coarse level over ``nc`` groups."""
    rng = np.random.default_rng(seed)
    eye = torch.eye(3)[..., None].expand(3, 3, np_)
    up = torch.zeros(3, 3, np_)
    up[:, :, :-1] = -0.5 * torch.eye(3)[..., None]
    op = fp.FusedOperator(
        u=torch.tensor(rng.normal(0.0, 0.05, (3, np_, mw)), dtype=torch.float32),
        tdiag=(4.0 * eye).contiguous(), tupper=up,
        tlower=torch.roll(up.transpose(0, 1), 1, dims=-1).contiguous())
    cinv = rmat = None
    if nc:
        rmat = (torch.arange(np_)[:, None] // (np_ // nc)
                == torch.arange(nc)[None]).float()
        c = torch.tensor(rng.normal(size=(3 * nc, 3 * nc)), dtype=torch.float32)
        cinv = (0.01 * c @ c.T).reshape(3, nc, 3, nc).permute(0, 2, 1, 3)
        cinv = cinv.contiguous()
    pre = fp.FusedPrecond(torch.zeros(0, 3, 3, np_), torch.zeros(0, 3, 3, np_),
                          (0.25 * eye).contiguous(), cinv, rmat)
    rhs = torch.tensor(rng.normal(size=(3, np_)), dtype=torch.float32)
    return op, pre, rhs


def _start(rhs):
    z = torch.zeros_like(rhs)
    st = fp.ChunkState(
        x=z, r=z, p=z, rt=rhs.clone(),
        it=torch.zeros(1, dtype=torch.int32, device=rhs.device),
        rz=torch.zeros(1, device=rhs.device),
        stop=torch.zeros(1, dtype=torch.int32, device=rhs.device),
        rr=(rhs * rhs).sum().reshape(1))
    return st, (1e-12 * (rhs * rhs).sum()).reshape(1)


def _to(tree, device):
    return type(tree)(*(None if t is None else t.to(device) for t in tree))


def test_wrapper_on_cpu_runs_plain_version_uncounted():
    op, pre, rhs = _tiny_system()
    st, atol2 = _start(rhs)
    before = fp.fused_pcg_chunk.launches
    a = fp.fused_pcg_chunk(op, pre, rhs, st, atol2, 50, True, 4)
    b = fp.fused_pcg_chunk_ref(op, pre, rhs, st, atol2, 50, True, 4)
    assert fp.fused_pcg_chunk.launches == before
    for name in fp.ChunkState._fields:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    with pytest.raises(ValueError, match="no kernel"):
        fp.fused_pcg_chunk(op, pre, rhs.to("meta"), st, atol2, 50, True, 4)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "rmat",
                                 "dp"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    op, pre, rhs = _tiny_system()
    st, atol2 = _start(rhs)
    if bad == "dtype":
        op = op._replace(u=op.u.double())
    elif bad == "shape":
        pre = pre._replace(binv=pre.binv[:, :, :-1])
    elif bad == "contiguous":
        op = op._replace(tupper=op.tupper.transpose(0, 1))
    elif bad == "rmat":
        pre = pre._replace(rmat=torch.zeros(16, 2))
    else:
        rhs = torch.zeros(6, 16)
    with pytest.raises((TypeError, ValueError, NotImplementedError)):
        fp._launch(op, pre, rhs, st, atol2, 50, True, 4)


def test_resident_shared_memory_formula():
    """The wrapper's budget formula: seven [dp, Np] vectors, the V^T x row,
    the coarse scratch and 66 reduction slots, in bytes."""
    assert fp.chunk_smem_bytes(3, 192, 768, 0) == 4 * (7 * 576 + 768 + 66)
    assert fp.chunk_smem_bytes(3, 2048, 768, 0) <= fp.SMEM_BUDGET_BYTES


# --- on the GPU ---------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _compare(op, pre, rhs, restart=True, chunk=16):
    """One chunk of kernel and plain version from the same state: the fresh
    start (restart) or the state after a first plain chunk (carried)."""
    st, atol2 = _start(rhs)
    if not restart:
        st = fp.fused_pcg_chunk_ref(op, pre, rhs, st, atol2, 200, True, chunk)
    before = fp.fused_pcg_chunk.launches
    ker = fp.fused_pcg_chunk(op, pre, rhs, st, atol2, 200, restart, chunk)
    torch.cuda.synchronize()
    assert fp.fused_pcg_chunk.launches == before + 1
    ref = fp.fused_pcg_chunk_ref(op, pre, rhs, st, atol2, 200, restart, chunk)
    assert int(ker.it) == int(ref.it) and int(ker.stop) == int(ref.stop)
    rel_x = float((ker.x - ref.x).abs().max() / ref.x.abs().max())
    assert rel_x <= 1e-4
    assert float((ker.rt - ref.rt).abs().max()) <= \
        1e-4 * float(rhs.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("precond", ["jacobi", "tridiag"])
def test_kernel_matches_plain_version_on_main_path_system(cuda, precond):
    cfg = SlamConfig()
    g = attach_plan(frontend.build_graph(frontend.simulate(cfg.sim),
                                         cfg)[0].to(cuda))
    d = schur.damp(schur.assemble_blocks(g, 1.5),
                   torch.tensor(1e-3, device=cuda))
    hll_inv = schur.inv_blocks(d.hll)
    op = fp.build_fused_operator(d, hll_inv, g)
    pre = fp.build_fused_precond(d, hll_inv, g,
                                 schur.schur_s_diag(d, hll_inv, g), precond,
                                 64)
    rhs = -d.bp + schur.hpl_matvec(d, g.lm_edges.lm, mv(hll_inv, d.bl),
                                   g.plan)
    _compare(op, pre, rhs.T.contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("restart", [True, False])
def test_kernel_matches_plain_version_with_coarse_level(cuda, restart):
    op, pre, rhs = _tiny_system(np_=64, mw=40, nc=4)
    _compare(_to(op, cuda), _to(pre, cuda), rhs.to(cuda), restart, chunk=5)


@pytest.mark.cuda
def test_kernel_refuses_more_shared_memory_than_the_card_has(cuda):
    op, pre, rhs = _tiny_system(np_=20_000, mw=8)
    st, atol2 = _start(rhs.to(cuda))
    with pytest.raises(ValueError, match="shared"):
        fp.fused_pcg_chunk(_to(op, cuda), _to(pre, cuda), rhs.to(cuda), st,
                           atol2, 50, True, 4)


def _tiny_band(np_=300, seed=0):
    """A small SPD band system (K=2 windows per chunk, one past Np, two
    wide columns), block-Jacobi preconditioned."""
    from toyslam_torch.ops import band_plan

    rng = np.random.default_rng(seed)
    win_off = np.array([[0, 128], [128, 256]], np.int32)

    def f32(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32)

    eye = torch.eye(3)[..., None].expand(3, 3, np_)
    up = torch.zeros(3, 3, np_)
    up[:, :, :-1] = -0.5 * torch.eye(3)[..., None]
    op = fp.BandOperator(
        tiles=f32(rng.normal(0.0, 0.01, (2, 2, 3, 128, 128))),
        win_off=torch.as_tensor(win_off),
        cover=torch.as_tensor(
            band_plan._window_cover(win_off, np_, 128, 3).astype(np.int32)),
        u=f32(rng.normal(0.0, 0.02, (3, 2, np_))),
        tdiag=(4.0 * eye).contiguous(), tupper=up,
        tlower=torch.roll(up.transpose(0, 1), 1, dims=-1).contiguous())
    pre = fp.FusedPrecond(torch.zeros(0, 3, 3, np_), torch.zeros(0, 3, 3, np_),
                          (0.25 * eye).contiguous(), None, None)
    return op, pre, f32(rng.normal(size=(3, np_)))


@pytest.mark.cuda
@pytest.mark.parametrize("restart", [True, False])
def test_band_kernel_matches_plain_version(cuda, restart):
    op, pre, rhs = _tiny_band()
    op, pre, rhs = _to(op, cuda), _to(pre, cuda), rhs.to(cuda)
    st, atol2 = _start(rhs)
    if not restart:
        st = fp.band_fused_pcg_chunk_ref(op, pre, rhs, st, atol2, 200, True, 8)
    before = fp.band_fused_pcg_chunk.launches
    ker = fp.band_fused_pcg_chunk(op, pre, rhs, st, atol2, 200, restart, 8)
    torch.cuda.synchronize()
    assert fp.band_fused_pcg_chunk.launches == before + 1
    ref = fp.band_fused_pcg_chunk_ref(op, pre, rhs, st, atol2, 200, restart, 8)
    assert int(ker.it) == int(ref.it) and int(ker.stop) == int(ref.stop)
    assert float((ker.x - ref.x).abs().max() / ref.x.abs().max()) <= 1e-4
    assert float((ker.rt - ref.rt).abs().max()) <= \
        1e-4 * float(rhs.abs().max())


@pytest.mark.cuda
def test_main_path_on_gpu_goes_through_the_kernel(cuda):
    cfg = SlamConfig(sim=SimConfig(robot_steps=150, seed=0),
                     optimizer=OptimizerConfig(solver="schur"))
    sim = frontend.simulate(cfg.sim)
    graph, _ = frontend.build_graph(sim, cfg)
    before = fp.fused_pcg_chunk.launches
    res = GaussNewton(cfg.optimizer).optimize(graph.to(cuda))
    assert fp.fused_pcg_chunk.launches > before
    ate = frontend.ate_rmse(res.graph.poses[:150], sim.poses_gt)
    assert abs(ate - 0.7552) <= 2e-3
    np.testing.assert_allclose(res.errors[0].item(), 228733.5, rtol=1e-4)
    np.testing.assert_allclose(res.errors[-1].item(), 27524.9, rtol=1e-3)
