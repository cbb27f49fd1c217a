"""The fused-PCG chunk wrappers and their hand-written CUDA kernels (the
resident B1; the band B2 on the card only, its CPU side is in
test_torch_band.py), and on the card the slab band matvec B3 (its CPU side
is in test_torch_band_matvec.py).

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


def _tiny_system(np_=16, mw=8, nc=0, seed=0, dp=3):
    """A small SPD system in the kernel layout, block-Jacobi preconditioned,
    with an optional coarse level over ``nc`` groups."""
    rng = np.random.default_rng(seed)
    eye = torch.eye(dp)[..., None].expand(dp, dp, np_)
    up = torch.zeros(dp, dp, np_)
    up[:, :, :-1] = -0.5 * torch.eye(dp)[..., None]
    # dp=6: V V^T kept well inside T at the BA widths (SPD, slow CG)
    scale = 0.05 if dp == 3 else 0.05 * (24.0 / (dp * mw)) ** 0.5
    op = fp.FusedOperator(
        u=torch.tensor(rng.normal(0.0, scale, (dp, np_, mw)),
                       dtype=torch.float32),
        tdiag=(4.0 * eye).contiguous(), tupper=up,
        tlower=torch.roll(up.transpose(0, 1), 1, dims=-1).contiguous())
    cinv = rmat = None
    if nc:
        rmat = (torch.arange(np_)[:, None] // (np_ // nc)
                == torch.arange(nc)[None]).float()
        c = torch.tensor(rng.normal(size=(dp * nc, dp * nc)),
                         dtype=torch.float32)
        cinv = (0.01 * c @ c.T).reshape(dp, nc, dp, nc).permute(0, 2, 1, 3)
        cinv = cinv.contiguous()
    pre = fp.FusedPrecond(torch.zeros(0, dp, dp, np_),
                          torch.zeros(0, dp, dp, np_),
                          (0.25 * eye).contiguous(), cinv, rmat)
    rhs = torch.tensor(rng.normal(size=(dp, np_)), dtype=torch.float32)
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
    else:   # a pose block size the kernel is not built for
        rhs = torch.zeros(5, 16)
    with pytest.raises((TypeError, ValueError, NotImplementedError)):
        fp._launch(op, pre, rhs, st, atol2, 50, True, 4)


def test_resident_shared_memory_formula():
    """The wrapper's budget formula per block of the cluster: seven [dp, Np]
    vectors, the block's ceil(Mw / 16) V^T x columns, the 576 float4
    column-sum scratch, the coarse scratch and 38 reduction slots, plus the
    block's U slice when it stays in shared memory, in bytes."""
    streamed = 4 * (7 * 576 + 48 + 4 * 576 + 38)
    assert fp.chunk_smem_bytes(3, 192, 768, 0) == streamed
    assert fp.chunk_smem_bytes(3, 192, 768, 0, resident=True) == \
        streamed + 4 * 576 * 52          # rows of 13 float4s (odd)
    assert fp.chunk_smem_bytes(3, 192, 768, 3, cluster=8) == \
        4 * (7 * 576 + 96 + 4 * 576 + 18 + 38)
    assert fp.chunk_smem_bytes(3, 2048, 768, 0) <= fp.SMEM_BUDGET_BYTES


@pytest.mark.parametrize("dp,np_,mw,nc,nl,clusters,planes,local,want", [
    # U columns of 112 blocks (7 a block, row stride 7), two whole vectors,
    # four shares of 68 poses, the local levels' two buffers over 68 + 2 x
    # 15 poses, the planes' share (2 L + 4 planes) and the four local
    # levels' planes over 96, 92, 84 and 68 poses, 384 column sums, urow,
    # 48 + 8 reduction slots
    (3, 1088, 768, 0, 11, 7, True, 4,
     4 * (3264 * 7 + 2 * 3264 + 4 * 204 + 2 * 3 * 98 + 26 * 3 * 204
          + 2 * 9 * (96 + 92 + 84 + 68) + 384 + 7 + 56)),
    # no local level: one buffer over the block's own poses; no planes
    (3, 2048, 768, 0, 11, 7, False, 0,
     4 * (6144 * 7 + 2 * 6144 + 4 * 384 + 384 + 384 + 7 + 56)),
    # three clusters: 32 columns a block take a row stride of 33; a coarse
    # level of 4 groups adds 4 dp nc floats
    (6, 128, 1536, 4, 7, 3, True, 4,
     4 * (768 * 33 + 2 * 768 + 4 * 48 + 2 * 6 * 38 + 18 * 6 * 48
          + 2 * 36 * (36 + 32 + 24 + 8) + 4 * 6 * 4 + 384 + 32 + 56)),
    # small layouts ask for the floor that keeps one block an SM
    (6, 64, 768, 0, 6, 1, True, 4, 116 * 1024),
    (3, 100, 768, 3, 7, 7, True, 5, 116 * 1024),
])
def test_split_shared_memory_formula(dp, np_, mw, nc, nl, clusters, planes,
                                     local, want):
    """The split schedules' shared memory per block (mirrors
    ``split_layout`` in csrc/fused_pcg_chunk.cu), in bytes."""
    assert fp.split_smem_bytes(dp, np_, mw, nc, nl, clusters,
                               planes=planes, local=local) == want


@pytest.mark.parametrize("dp,np_,mw,nl,want", [
    # the main path and the ba3d defaults: the one-cluster schedule holds U
    (3, 192, 768, 8, ("cluster", 16, 1, 48, 0, True, False, 0)),
    (6, 64, 768, 6, ("cluster", 16, 1, 48, 0, True, False, 0)),
    # the ba3d bench row, multi-loop-1k, the 2000-pose request: U over the
    # card, the planes on chip where they fit beside it, the first PCR
    # levels (4: shifts 1-8) on an extended range while it stays one
    # element a thread and fits
    (6, 128, 1536, 7, ("grid", 16, 7, 14, 8, True, True, 4)),
    (3, 1088, 768, 11, ("grid", 16, 7, 7, 68, True, True, 4)),
    (3, 2048, 768, 11, ("grid", 16, 7, 7, 128, True, False, 0)),
    # past the grid's shared memory: the one-cluster schedule, U from L2
    (3, 2600, 768, 12, ("cluster", 16, 1, 48, 0, False, False, 0)),
])
def test_b1_plan_at_the_suite_layouts(dp, np_, mw, nl, want):
    """Which schedule, cluster size, cluster count, columns and poses a
    block, U and planes residency and local PCR levels each path's layout
    takes on an H100."""
    plan = fp.b1_plan(dp, np_, mw, 0, nl, fp.SMEM_BUDGET_BYTES,
                      fp.H100_CLUSTERS)
    assert tuple(plan)[:8] == want
    assert plan.smem_bytes <= fp.SMEM_BUDGET_BYTES
    assert plan.grid == plan.clusters * plan.cluster
    assert fp.b1_fits(dp, np_, mw, 0, nl)


@pytest.mark.parametrize("case", ["few_clusters", "split_forced",
                                  "cluster8", "coarse"])
def test_b1_plan_forced_and_edge_layouts(case):
    """A card that runs fewer clusters (wider column slices), the split
    schedule forced on one cluster, clusters of 8, a coarse level."""
    budget, h100 = fp.SMEM_BUDGET_BYTES, fp.H100_CLUSTERS
    if case == "few_clusters":
        plan = fp.b1_plan(3, 1088, 768, 0, 11, budget, {16: 5})
        assert (plan.schedule, plan.clusters, plan.cols_per_block,
                plan.planes) == ("grid", 5, 10, False)
        # at three, a block's 16 columns no longer fit: the one-cluster schedule
        assert fp.b1_plan(3, 1088, 768, 0, 11, budget,
                          {16: 3}).schedule == "cluster"
    elif case == "split_forced":
        plan = fp.b1_plan(6, 64, 768, 0, 6, budget, h100, "split")
        assert (plan.schedule, plan.clusters, plan.cols_per_block,
                plan.poses_per_block) == ("split", 1, 48, 4)
    elif case == "cluster8":
        plan = fp.b1_plan(6, 128, 1536, 0, 7, budget, h100, "grid", 8)
        assert (plan.cluster, plan.clusters, plan.cols_per_block,
                plan.poses_per_block) == (8, 15, 13, 16)
    else:
        plan = fp.b1_plan(3, 1088, 768, 17, 11, budget, h100)
        assert plan.smem_bytes == fp.split_smem_bytes(3, 1088, 768, 17, 11, 7,
                                                      local=4)


@pytest.mark.parametrize("case,match", [
    ("schedule", "is not one of"), ("grid_tall", "grid schedule"),
    ("split_big", "split schedule"), ("nothing", "no schedule fits"),
    ("no_cluster", "grid schedule"), ("cluster_tall", "no cluster of 16"),
])
def test_b1_plan_refuses(case, match):
    """An unknown schedule, a forced grid or split schedule whose slices do
    not fit (2600 poses; 1088 poses on one cluster), a layout that nothing
    fits, a card that runs no cluster of 16, and the one-cluster schedule forced where
    not even its vectors fit are refused; nothing gives way to another
    schedule."""
    budget, h100 = fp.SMEM_BUDGET_BYTES, fp.H100_CLUSTERS
    args = {
        "schedule": ((3, 192, 768, 0, 8, budget, h100), dict(schedule="x")),
        "grid_tall": ((3, 2600, 768, 0, 12, budget, h100),
                      dict(schedule="grid")),
        "split_big": ((3, 1088, 768, 0, 11, budget, h100),
                      dict(schedule="split")),
        "nothing": ((3, 20_000, 8, 0, 15, budget, h100), {}),
        "no_cluster": ((3, 1088, 768, 0, 11, budget, {}),
                       dict(schedule="grid")),
        "cluster_tall": ((3, 20_000, 8, 0, 15, budget, h100),
                         dict(schedule="cluster")),
    }[case]
    with pytest.raises(ValueError, match=match):
        fp.b1_plan(*args[0], **args[1])
    if case == "nothing":
        assert not fp.b1_fits(3, 20_000, 8, 0, 15)


def test_band_shared_memory_formula():
    """A ring of `slots` parts of `pr` rows by `cols` columns with the rows'
    state values, the two cluster-visible partial t buffers and t over the
    columns, the 256 float4 combination slots, u^T v and 64 reduction
    slots (rounded to 8 bytes), and an 8-byte mbarrier per slot, in
    bytes."""
    assert fp.band_smem_bytes(192, 128, 2, 2) == \
        4 * (2 * 192 * 129 + 3 * 128 + 1024 + 4 + 64 + 2 * 2)
    assert fp.band_smem_bytes(240, 64, 3, 0) == \
        4 * (3 * 240 * 65 + 3 * 64 + 1024 + 0 + 64 + 2 * 3)
    assert fp.band_smem_bytes(48, 32, 1, 1) == \
        4 * (48 * 33 + 3 * 32 + 1024 + 4 + 64 + 2 * 1)


def _three_configs():
    """The graphs of the main path (150 poses), the shape check (2000
    poses) and the scale path (10k poses), with their optimizer configs."""
    from toyslam_torch.sim import synthetic

    out = {}
    for steps in (150, 2000):
        cfg = SlamConfig(sim=SimConfig(robot_steps=steps, seed=0),
                         optimizer=OptimizerConfig(solver="schur",
                                                   pcg_precond="tridiag"))
        g = attach_plan(frontend.build_graph(frontend.simulate(cfg.sim),
                                             cfg)[0])
        out[steps] = (cfg.optimizer, g)
    g = attach_plan(synthetic.make_large_problem(
        num_poses=10_000, num_landmarks=10_000, obs_per_pose=6, seed=0)[0])
    out[10_000] = (OptimizerConfig(
        solver="schur", exact_odom_jacobians=True,
        pcg_precond="tridiag+coarse", pcg_coarse_group=160), g)
    return out


@pytest.fixture(scope="module")
def three_configs():
    return _three_configs()


@pytest.mark.parametrize("poses,mode,np_,resident", [
    (150, "resident", 192, True),
    (2000, "resident", 2048, False),
    (10_000, "band", 10_240, None),
])
def test_kernel_layouts_at_the_three_configs(three_configs, poses, mode,
                                              np_, resident):
    """The gate's pick and the host-side layout each kernel would launch
    with on an H100 (227 KB of shared memory per block, 132 SMs): B1's
    cluster split (U in shared memory at 150 poses, streamed from L2 at
    2000), B2's slab schedule and workspace at 10k poses."""
    cfg, g = three_configs[poses]
    assert g.num_poses == np_
    assert fp.fused_mode(cfg, g) == mode
    if mode == "resident":
        mw = 2 * g.num_landmarks
        assert mw == 768
        nl = (np_ - 1).bit_length()
        # the one-cluster schedule: U in shared memory at 150 poses, not at 2000
        one = fp.b1_plan(3, np_, mw, 0, nl, fp.SMEM_BUDGET_BYTES,
                         fp.H100_CLUSTERS, "cluster")
        assert (one.cluster, one.clusters, one.cols_per_block) == (16, 1, 48)
        assert one.resident is resident
        assert one.smem_bytes == fp.chunk_smem_bytes(3, np_, mw, 0,
                                                     resident=resident)
        # the plan keeps it where U fits, else spreads U over the card
        plan = fp.b1_plan(3, np_, mw, 0, nl, fp.SMEM_BUDGET_BYTES,
                          fp.H100_CLUSTERS)
        if resident:
            assert plan == one
        else:
            assert plan == fp.B1Plan("grid", 16, 7, 7, 128, True, False, 0,
                                     fp.split_smem_bytes(3, np_, mw, 0, nl,
                                                         7, planes=False))
        assert plan.smem_bytes <= fp.SMEM_BUDGET_BYTES
        return
    band = g.plan.band
    b_dl, mw = band.chunk_b * band.dl, band.n_wide * band.dl
    assert (band.n_chunks, band.k_windows, band.w_row, b_dl, mw) == \
        (39, 2, 512, 512, 2)
    plan = fp.band_tile_plan(band.n_chunks, band.k_windows, 3, band.w_row,
                             b_dl, mw, fp.SMEM_BUDGET_BYTES, fp.H100_CLUSTERS)
    # 3072 rows per chunk: whole-height slabs of 16 of the 512 columns fit
    # a block (32 do not), so the slab schedule: 32 slabs a chunk, one
    # unit each, 1248 in all, at most 10 per block of 132
    assert plan == fp.BandTilePlan(True, 3072, 1, 1, 3072, 16, 32, 32, 1,
                                   132, 10,
                                   fp.band_smem_bytes(3072, 16, 1, 2))
    assert plan.grid == 132 and plan.smem_bytes <= fp.SMEM_BUDGET_BYTES < \
        fp.band_smem_bytes(3072, 32, 1, 2)
    nc = 10_240 // 160
    assert fp.band_workspace_floats(3, np_, 39, plan, mw, nc) == (
        7 * 3 * np_ + 39 * 3072 + 32 * 39 * 3072 + 10 * 2 + 2 * 3 * nc
        + 2 * 132 * 4)


def test_slab_major_stack_and_its_cache():
    """The band wrapper's slab-major copy: slab (c, s) is rows x cols of
    chunk c's columns s*cols ..., contiguous; it is made once per stack and
    made again once the stack is written to."""
    tiles = torch.arange(2 * 2 * 3 * 4 * 16, dtype=torch.float32).reshape(
        2, 2, 3, 4, 16)
    slabs = fp._slab_major(tiles, 4)
    assert slabs.shape == (2, 4, 24, 4) and slabs.is_contiguous()
    rows = tiles.reshape(2, 24, 16)
    for c in range(2):
        for sl in range(4):
            assert torch.equal(slabs[c, sl], rows[c, :, 4 * sl:4 * sl + 4])
    assert fp._slab_major(tiles, 4) is slabs
    tiles.add_(1.0)
    again = fp._slab_major(tiles, 4)
    assert again is not slabs and torch.equal(again, slabs + 1.0)


# (n_chunks, K, dp, Wrow, B*dl, Mw): the 10k path, the 10k grid rows
# (nc=320: the same stack), the 512 x 4096 BA graph and the 100k row
BAND_LAYOUTS = {
    "10k": (39, 2, 3, 512, 512, 2),
    "grid10k_nc320": (39, 2, 3, 512, 512, 2),
    "ba512_dp6": (31, 4, 6, 128, 384, 36),
    "100k": (388, 10, 3, 256, 256, 0),
}


@pytest.mark.parametrize("name,want", [
    ("10k", (True, 1, 1, 3072, 16, 32, 32, 1, 132, 10)),
    ("grid10k_nc320", (True, 1, 1, 3072, 16, 32, 32, 1, 132, 10)),
    ("ba512_dp6", (True, 1, 1, 3072, 16, 24, 24, 1, 132, 6)),
    ("100k", (False, 16, 2, 240, 64, 4, 1, 3, 7, 56)),
])
def test_band_tile_plan_at_the_path_layouts(name, want):
    """The plan on an H100 at each layout the port runs B2 on: the slab
    schedule where a whole-height slab of 16 columns fits a block (3072
    rows a chunk), else the widest cluster band whose ring of parts holds
    it over the fewest blocks, then the fewest segments that deal the
    units evenly: at 100k (7680 rows) clusters of 16 blocks (non-portable)
    of 480 rows take bands of 64 columns, one unit per chunk, 388 over 7
    clusters (56 at most)."""
    nch, k, dp, w, b_dl, mw = BAND_LAYOUTS[name]
    plan = fp.band_tile_plan(nch, k, dp, w, b_dl, mw, fp.SMEM_BUDGET_BYTES,
                             fp.H100_CLUSTERS)
    assert (plan.slab, plan.cluster, plan.parts, plan.pr, plan.cols,
            plan.bands, plan.segments, plan.slots, plan.clusters,
            plan.units_per_cluster) == want
    assert plan.rows == k * dp * w
    assert plan.rows_per_block * plan.cluster >= plan.rows
    assert plan.slots >= plan.parts
    assert plan.bands * plan.cols == b_dl and plan.bands % plan.segments == 0
    assert plan.units_per_cluster == -(-nch * plan.segments // plan.clusters)
    assert plan.smem_bytes == fp.band_smem_bytes(plan.pr, plan.cols,
                                                 plan.slots, mw)
    assert plan.smem_bytes <= fp.SMEM_BUDGET_BYTES
    # the w partials: one per row per unit, at most a sixteenth of the
    # stack's bytes
    assert plan.segments * fp.BAND_SLAB_MIN_COLS <= b_dl
    if not plan.slab:
        assert plan.pr % 8 == 0 and plan.pr <= fp.BAND_THREADS


@pytest.mark.parametrize("case", ["tiny", "small_smem", "forced",
                                  "forced_cols", "uneven_rows",
                                  "few_clusters", "slab_forced",
                                  "band_forced"])
def test_band_tile_plan_edge_shapes(case):
    """A chunk of 48 rows takes one slab of the widest width; a smaller
    shared-memory limit that leaves slabs under 16 columns takes cluster
    bands, splitting rows wider to keep wide bands; a forced cluster size,
    band width or schedule is kept (a slab of 4 columns at 100k, cluster
    bands at 10k); rows that R does not divide round up to a part of a
    multiple of 8 rows; a card with fewer clusters deals more units to
    each."""
    if case == "tiny":
        plan = fp.band_tile_plan(1, 1, 3, 16, 128, 0, 232_448,
                                 fp.H100_CLUSTERS)
        assert (plan.slab, plan.pr, plan.cols, plan.bands,
                plan.segments) == (True, 48, 128, 1, 1)
    elif case == "small_smem":
        plan = fp.band_tile_plan(39, 2, 3, 512, 512, 2, 120_000,
                                 fp.H100_CLUSTERS)
        assert (plan.slab, plan.cluster, plan.cols, plan.parts) == \
            (False, 16, 128, 1)
        assert plan.smem_bytes <= 120_000 < fp.band_smem_bytes(192, 128, 2,
                                                               2)
    elif case == "forced":
        plan = fp.band_tile_plan(39, 2, 3, 512, 512, 2, 232_448,
                                 fp.H100_CLUSTERS, cluster=16)
        assert (plan.slab, plan.cluster, plan.parts, plan.pr, plan.cols,
                plan.clusters) == (False, 16, 1, 192, 128, 7)
    elif case == "forced_cols":
        plan = fp.band_tile_plan(39, 2, 3, 512, 512, 2, 232_448,
                                 fp.H100_CLUSTERS, cols=64)
        assert (plan.slab, plan.cluster, plan.cols, plan.bands,
                plan.slots) == (False, 4, 64, 8, 3)
    elif case == "uneven_rows":
        plan = fp.band_tile_plan(5, 3, 3, 20, 128, 0, 232_448,
                                 fp.H100_CLUSTERS, cluster=8)
        assert (plan.rows, plan.parts, plan.pr) == (180, 1, 24)
        assert 7 * plan.rows_per_block < plan.rows <= 8 * plan.rows_per_block
    elif case == "few_clusters":
        plan = fp.band_tile_plan(388, 10, 3, 256, 256, 0, 232_448, {16: 3})
        assert (plan.cluster, plan.clusters, plan.units_per_cluster) == \
            (16, 3, 130)
    elif case == "slab_forced":
        plan = fp.band_tile_plan(388, 10, 3, 256, 256, 0, 232_448,
                                 fp.H100_CLUSTERS, slab=True)
        assert (plan.slab, plan.pr, plan.cols, plan.segments) == \
            (True, 7680, 4, 64)
    else:
        plan = fp.band_tile_plan(39, 2, 3, 512, 512, 2, 232_448,
                                 fp.H100_CLUSTERS, slab=False)
        assert (plan.slab, plan.cluster, plan.cols) == (False, 8, 128)


@pytest.mark.parametrize("case,match", [
    ("rows", "multiple of 4"), ("tall", "does not fit"),
    ("parts", "does not fit"), ("no_cluster", "does not fit"),
    ("narrow", "is built"), ("slab_tall", "no slab"),
    ("dp6_band", "no cluster band is built at dp=6"),
])
def test_band_tile_plan_refuses(case, match):
    """Rows the 16-byte copies cannot take, a chunk too tall for 16 blocks
    of 8 parts, a forced cluster too small for its rows, a card that runs
    no cluster, a band width that is not built (32 columns: no path's plan
    takes it), a forced slab too tall for a block, and cluster bands at
    dp=6 (only slabs are built there) are refused."""
    args = {
        "rows": ((39, 1, 3, 5, 512, 2, 232_448, fp.H100_CLUSTERS), {}),
        "tall": ((4, 10, 3, 4096, 512, 0, 232_448, fp.H100_CLUSTERS), {}),
        "parts": ((388, 10, 3, 256, 256, 0, 232_448, fp.H100_CLUSTERS),
                  dict(cluster=2, cols=64)),
        "no_cluster": ((39, 2, 3, 512, 512, 2, 232_448, {}), {}),
        "narrow": ((39, 2, 3, 512, 512, 2, 232_448, fp.H100_CLUSTERS),
                   dict(cols=32)),
        "slab_tall": ((4, 10, 6, 2048, 512, 0, 232_448, fp.H100_CLUSTERS),
                      dict(slab=True)),
        "dp6_band": ((31, 4, 6, 128, 384, 36, 232_448, fp.H100_CLUSTERS),
                     dict(slab=False)),
    }[case]
    with pytest.raises(ValueError, match=match):
        fp.band_tile_plan(*args[0], **args[1])


def _kernel_band_rows(tiles, win_off, cover, x, plan):
    """V V^T x as the band kernel computes it, in numpy f32 and in its
    order: xwin, then per unit (chunk c, segment s) of the plan the bands
    in order, each band's t as the cluster ranks' partials over their rows
    added in rank order, the w rows summed over the unit's bands into the
    unit's slot of wpart [n_chunks, rows, segments]; then the gather: per
    pose and component the cover entries in order, each over its row's
    unit slots in order."""
    nch, k_win, dp, w_row, b_dl = tiles.shape
    n = x.shape[1]
    rows, r, rpb, cb, seg = (plan.rows, plan.cluster, plan.rows_per_block,
                             plan.cols, plan.segments)
    nbu = plan.bands // seg
    d = tiles.reshape(nch, rows, b_dl)
    xext = np.concatenate([x, np.zeros((dp, w_row), np.float32)], axis=1)
    rho = np.arange(rows)
    ka, w = rho // w_row, rho % w_row
    xwin = xext[ka % dp, win_off[:, ka // dp] + w]           # [nch, rows]
    wpart = np.zeros((nch, rows, seg), np.float32)
    for u in range(nch * seg):
        c, s = divmod(u, seg)
        for b in range(nbu):
            j = (s * nbu + b) * cb
            t = np.zeros(cb, np.float32)
            for k in range(r):
                lo, hi = k * rpb, min(rows, (k + 1) * rpb)
                t = t + xwin[c, lo:hi] @ d[c, lo:hi, j:j + cb]
            wpart[c, :, s] += d[c, :, j:j + cb] @ t
    out = np.zeros((dp, n), np.float32)
    flat = wpart.reshape(-1)
    for q in range(n):
        for cv in cover[q]:
            if cv < 0:
                break
            for a in range(dp):
                slot = (cv + a * w_row) * seg
                for s in range(seg):
                    out[a, q] += flat[slot + s]
    return out


@pytest.mark.parametrize("dp,cluster,cols", [(3, None, None), (3, 4, 64),
                                             (6, None, None), (3, 8, 64),
                                             (3, 16, 128), (3, "slab", 8)])
def test_band_cover_and_unit_slots_give_the_plain_matvec(dp, cluster, cols):
    """The kernel's tables applied in numpy on a small banded system (6
    chunks, K=3 windows at random multiples of 128, one past Np): the
    cover table's rows, the unit slots of wpart per segment and the rank
    split of each band's rows give V V^T x of ``band_matvec_ref`` within
    f32 rounding, at the plan's own choice (the slab schedule), a forced
    narrow slab and forced cluster sizes and band widths (more segments
    than one), at dp=3 and dp=6 (slabs)."""
    from toyslam_torch.ops import band_plan

    rng = np.random.default_rng(3)
    n, nch, k_win, w_row, b_dl = 900, 6, 3, 128, 256
    win_off = rng.choice(np.arange(0, n, 128), size=(nch, k_win))
    win_off[-1, -1] = 896
    win_off = win_off.astype(np.int32)
    cover = band_plan._window_cover(win_off, n, w_row, dp).astype(np.int32)
    live = (win_off[..., None] + np.arange(w_row)) < n
    tiles = (rng.normal(size=(nch, k_win, dp, w_row, b_dl))
             * live[:, :, None, :, None]).astype(np.float32)
    x = rng.normal(size=(dp, n)).astype(np.float32)
    force = (dict(slab=True, cols=cols) if cluster == "slab"
             else dict(cluster=cluster, cols=cols))
    plan = fp.band_tile_plan(nch, k_win, dp, w_row, b_dl, 0,
                             fp.SMEM_BUDGET_BYTES,
                             {1: 7, 2: 5, 4: 4, 8: 4, 16: 4}, **force)
    assert plan.cols == (cols or plan.cols)
    assert plan.slab == (cluster in (None, "slab"))
    assert plan.segments > 1    # 6 chunks deal unevenly to these clusters
    got = _kernel_band_rows(tiles, win_off, cover, x, plan)
    zero = torch.zeros(dp, dp, n)
    op = fp.BandOperator(torch.from_numpy(tiles), torch.from_numpy(win_off),
                         torch.from_numpy(cover), None, zero, zero, zero)
    want = -fp.band_matvec_ref(op, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-5 * float(np.abs(want).max()))


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


@pytest.mark.parametrize("kernel", ["resident", "band"])
def test_dp6_wrapper_on_cpu_runs_plain_version_uncounted(kernel):
    """SE(3) pose blocks (dp=6): on the CPU both wrappers run their plain
    versions, count no launch, and CG makes progress."""
    if kernel == "resident":
        op, pre, rhs = _tiny_system(np_=64, mw=96, dp=6)
        fn, ref_fn = fp.fused_pcg_chunk, fp.fused_pcg_chunk_ref
    else:
        op, pre, rhs = _tiny_band(np_=300, dp=6)
        fn, ref_fn = fp.band_fused_pcg_chunk, fp.band_fused_pcg_chunk_ref
    st, atol2 = _start(rhs)
    before = fn.launches
    a = fn(op, pre, rhs, st, atol2, 50, True, 4)
    b = ref_fn(op, pre, rhs, st, atol2, 50, True, 4)
    assert fn.launches == before
    for name in fp.ChunkState._fields:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert int(a.it) == 4 and int(a.stop) == 0
    assert float(a.rr) < float(st.rr)


def _tiny_band(np_=300, seed=0, n_chunks=2, w_row=128, b_dl=128, dp=3,
               nc=0):
    """A small SPD band system (K=2 windows per chunk, two wide columns),
    block-Jacobi preconditioned, with an optional coarse level over ``nc``
    groups of consecutive poses.  Two chunks: windows at 0, 128, 128, 256
    (one past Np); more: windows at random multiples of 128."""
    from toyslam_torch.ops import band_plan

    rng = np.random.default_rng(seed)
    if n_chunks == 2:
        win_off = np.array([[0, 128], [128, 256]], np.int32)
    else:
        win_off = rng.choice(np.arange(0, np_, 128),
                             size=(n_chunks, 2)).astype(np.int32)

    def f32(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32)

    eye = torch.eye(dp)[..., None].expand(dp, dp, np_)
    up = torch.zeros(dp, dp, np_)
    up[:, :, :-1] = -0.5 * torch.eye(dp)[..., None]
    op = fp.BandOperator(
        tiles=f32(rng.normal(0.0, 0.01 * (128 / b_dl) ** 0.5
                             * (2 / n_chunks) ** 0.5 * (3 / dp) ** 0.5,
                             (n_chunks, 2, dp, w_row, b_dl))),
        win_off=torch.as_tensor(win_off),
        cover=torch.as_tensor(
            band_plan._window_cover(win_off, np_, w_row, dp).astype(np.int32)),
        u=f32(rng.normal(0.0, 0.02, (dp, 2, np_))),
        tdiag=(4.0 * eye).contiguous(), tupper=up,
        tlower=torch.roll(up.transpose(0, 1), 1, dims=-1).contiguous())
    cinv = rmat = None
    if nc:
        c = rng.normal(size=(dp * nc, dp * nc))
        cinv = f32((0.01 * c @ c.T).reshape(dp, nc, dp, nc)
                   .transpose(0, 2, 1, 3).copy())
        rmat = (torch.arange(np_)[:, None] // (np_ // nc)
                == torch.arange(nc)[None]).float()
    pre = fp.FusedPrecond(torch.zeros(0, dp, dp, np_),
                          torch.zeros(0, dp, dp, np_),
                          (0.25 * eye).contiguous(), cinv, rmat)
    return op, pre, f32(rng.normal(size=(dp, np_)))


@pytest.mark.parametrize("case", ["groups", "not_dividing", "moved",
                                  "scaled", "negative"])
def test_band_coarse_restriction_must_be_consecutive_groups(case):
    """The band kernel reads the coarse group of pose q as q / (Np / nc):
    the wrapper takes the 0/1 restriction of consecutive equal groups, once
    per tensor until it is written to, and refuses any other (a pose moved
    to another group, a weight other than 1, a negative entry that keeps
    the sums, a group count not dividing Np)."""
    n, nc = 120, 6
    rmat = (torch.arange(n)[:, None] // 20 == torch.arange(nc)[None]).float()
    if case == "groups":
        assert fp._coarse_group(rmat, n) == 20
        # checked once per tensor; written to, it is checked again
        assert fp._coarse_group(rmat, n) == 20
        rmat[7] = torch.roll(rmat[7], 1)
        with pytest.raises(ValueError):
            fp._coarse_group(rmat, n)
        return
    if case == "not_dividing":
        rmat = rmat[:, :5].contiguous()
    elif case == "moved":
        rmat[7] = torch.roll(rmat[7], 1)
    elif case == "scaled":
        rmat[7, 0], rmat[8, 0] = 2.0, 0.0
    else:
        rmat[7, 1], rmat[8, 0] = -1.0, 2.0
    with pytest.raises(ValueError):
        fp._coarse_group(rmat, n)


@pytest.mark.cuda
@pytest.mark.parametrize("restart,chunks", [(True, 2), (False, 2),
                                            (True, 60), (False, 60)])
def test_band_kernel_matches_plain_version(cuda, restart, chunks):
    """Two chunks: a few bands; sixty: 60 chunks x 2 windows x 3
    components x 256 rows cut into bands of 32 columns, more units than
    clusters, so clusters walk several and copy the next while working."""
    op, pre, rhs = _tiny_band(np_=1000 if chunks > 2 else 300,
                              n_chunks=chunks,
                              w_row=256 if chunks > 2 else 128)
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
@pytest.mark.parametrize("restart", [True, False])
@pytest.mark.parametrize("cluster,cols,w_row,np_", [
    (1, 64, 128, 2000), (2, 64, 256, 1000), (4, 64, 256, 1000),
    (8, 128, 256, 1000), (16, 64, 256, 1000), (16, 128, 128, 2000),
    ("slab", 16, 256, 1000), ("slab", 4, 256, 1000)])
def test_band_kernel_at_every_cluster_size(cuda, cluster, cols, w_row, np_,
                                           restart):
    """B2 with its plan forced to each cluster size (blocks splitting a
    band's 1536 rows, or 768 where one block takes them all, their partial
    t exchanged in shared memory across the cluster), to both band widths
    and to wide and narrow slabs, with a coarse level over 10 groups:
    against the plain version, the same bits on a rerun, and no spilled
    register in any instantiation.  The 768-row system spreads its 60
    chunks over 2000 poses: over 1000 its carried chunk leaves the f32
    plain version as far from its own float64 run as the tolerance."""
    op, pre, rhs = _tiny_band(np_=np_, n_chunks=60, w_row=w_row, nc=10)
    op, pre, rhs = _to(op, cuda), _to(pre, cuda), rhs.to(cuda)
    st, atol2 = _start(rhs)
    if not restart:
        st = fp.band_fused_pcg_chunk_ref(op, pre, rhs, st, atol2, 200, True, 8)
    force = (dict(slab=True, cols=cols) if cluster == "slab"
             else dict(slab=False, cluster=cluster, cols=cols))
    plan = fp.band_schedule(0, 60, 2, 3, w_row, 128, 2, **force)
    assert plan.cols == cols and plan.slab == (cluster == "slab")
    before = fp.band_fused_pcg_chunk.launches
    ker = fp._band_launch(op, pre, rhs, st, atol2, 200, restart, 8, **force)
    again = fp._band_launch(op, pre, rhs, st, atol2, 200, restart, 8, **force)
    torch.cuda.synchronize()
    assert fp.band_fused_pcg_chunk.launches == before + 2
    ref = fp.band_fused_pcg_chunk_ref(op, pre, rhs, st, atol2, 200, restart, 8)
    assert int(ker.it) == int(ref.it) and int(ker.stop) == int(ref.stop)
    assert float((ker.x - ref.x).abs().max() / ref.x.abs().max()) <= 1e-4
    assert float((ker.rt - ref.rt).abs().max()) <= \
        1e-4 * float(rhs.abs().max())
    for name in fp.ChunkState._fields:
        assert torch.equal(getattr(ker, name), getattr(again, name)), name
    for dp in fp.KERNEL_DPS:
        for c in fp.BAND_COLS[dp]:
            assert fp.band_kernel_attrs(dp, c)["local_bytes"] == 0, (dp, c)
        assert fp.band_kernel_attrs(dp, 16, slab=True)["local_bytes"] == 0


@pytest.mark.cuda
def test_band_kernel_with_rows_the_cluster_does_not_divide(cuda):
    """Cluster bands over rows that the cluster does not divide: 2 windows
    x 3 components x 30 rows = 180 a chunk over 8 blocks of parts of 24
    rows, so the last rank's TMA box reaches 12 rows into the next chunk
    (for the last chunk, into the zero fill past the stack), rows the
    kernel must mask off.  First the matvec alone, where a row read past
    the share would move the result by a fifth: with T = 0 and no wide
    column, a launch of no iteration returns rhs - S x = V V^T x in its
    true residual, held within 1e-5 of the plain version's largest entry.
    Then a chunk of 8 iterations with a coarse level against the plain
    version, and the same bits on a rerun of each."""
    op, pre, rhs = _tiny_band(np_=1000, n_chunks=60, w_row=30, nc=10)
    force = dict(slab=False, cluster=8, cols=128)
    plan = fp.band_schedule(0, 60, 2, 3, 30, 128, 2, **force)
    assert (plan.rows, plan.parts, plan.pr) == (180, 1, 24)
    zero = torch.zeros_like(op.tdiag)
    vop = op._replace(tdiag=zero, tupper=zero, tlower=zero, u=None)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=rhs.shape).astype(np.float32))
    z = torch.zeros_like(x)
    st = fp.ChunkState(x=x, r=z, p=z, rt=z,
                       it=torch.zeros(1, dtype=torch.int32),
                       rz=torch.zeros(1),
                       stop=torch.zeros(1, dtype=torch.int32),
                       rr=torch.zeros(1))
    vop, vpre, st = _to(vop, cuda), _to(pre, cuda), _to(st, cuda)
    atol0 = torch.zeros(1, device=cuda)
    mv = [fp._band_launch(vop, vpre, st.rt, st, atol0, 200, True, 0, **force)
          for _ in range(2)]
    want = fp.band_fused_pcg_chunk_ref(vop, vpre, st.rt, st, atol0, 200,
                                       True, 0).rt
    assert float(want.abs().max()) > 0
    assert float((mv[0].rt - want).abs().max()) <= \
        1e-5 * float(want.abs().max())
    assert torch.equal(mv[0].rt, mv[1].rt)

    op, pre, rhs = _to(op, cuda), _to(pre, cuda), rhs.to(cuda)
    st, atol2 = _start(rhs)
    ker = fp._band_launch(op, pre, rhs, st, atol2, 200, True, 8, **force)
    again = fp._band_launch(op, pre, rhs, st, atol2, 200, True, 8, **force)
    ref = fp.band_fused_pcg_chunk_ref(op, pre, rhs, st, atol2, 200, True, 8)
    assert int(ker.it) == int(ref.it) and int(ker.stop) == int(ref.stop)
    assert float((ker.x - ref.x).abs().max() / ref.x.abs().max()) <= 1e-4
    assert float((ker.rt - ref.rt).abs().max()) <= \
        1e-4 * float(rhs.abs().max())
    for name in fp.ChunkState._fields:
        assert torch.equal(getattr(ker, name), getattr(again, name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [8, 16])
def test_kernel_matches_plain_version_at_both_cluster_sizes(cuda, cluster):
    """The portable (8) and the non-portable (16) cluster: U streamed from
    L2 at 8 (the slice does not fit beside the vectors), resident at 16."""
    op, pre, rhs = _tiny_system(np_=192, mw=768, nc=3)
    op, pre, rhs = _to(op, cuda), _to(pre, cuda), rhs.to(cuda)
    st, atol2 = _start(rhs)
    ker = fp._launch(op, pre, rhs, st, atol2, 200, True, 16,
                     schedule="cluster", cluster=cluster)
    ref = fp.fused_pcg_chunk_ref(op, pre, rhs, st, atol2, 200, True, 16)
    assert int(ker.it) == int(ref.it)
    assert float((ker.x - ref.x).abs().max() / ref.x.abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["resident", "band"])
def test_kernel_repeats_bit_for_bit(cuda, kernel):
    """Two launches from the same state give the same bits."""
    if kernel == "resident":
        op, pre, rhs = _tiny_system(np_=192, mw=768, nc=3)
        fn = fp.fused_pcg_chunk
    else:
        op, pre, rhs = _tiny_band(np_=1000, n_chunks=60, w_row=256)
        fn = fp.band_fused_pcg_chunk
    op, pre, rhs = _to(op, cuda), _to(pre, cuda), rhs.to(cuda)
    st, atol2 = _start(rhs)
    a = fn(op, pre, rhs, st, atol2, 200, True, 8)
    b = fn(op, pre, rhs, st, atol2, 200, True, 8)
    for name in fp.ChunkState._fields:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


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


@pytest.mark.cuda
@pytest.mark.parametrize("np_,mw,restart", [
    (64, 768, True), (64, 768, False), (128, 1536, True), (128, 1536, False),
])
def test_dp6_resident_kernel_matches_plain_version(cuda, np_, mw, restart):
    """fused_pcg_chunk_kernel<6> at the BA shapes: Np=64, Mw=768 (the ba3d
    defaults: U slice in shared memory) and Np=128, Mw=1536 (the bench
    row: 768 elements on 576 threads, U from L2)."""
    op, pre, rhs = _tiny_system(np_=np_, mw=mw, nc=2, dp=6)
    plan = fp.b1_schedule(cuda.index or 0, 6, np_, mw, 2, 0)
    assert plan.schedule == ("cluster" if np_ == 64 else "grid")
    _compare(_to(op, cuda), _to(pre, cuda), rhs.to(cuda), restart, chunk=8)


def _pcr_system(np_, mw, nc=0, seed=0, dp=3):
    """:func:`_tiny_system` preconditioned by PCR on its chain (the split
    schedules distribute the PCR levels over a cluster)."""
    op, pre, rhs = _tiny_system(np_, mw, nc, seed, dp)
    al, ga, binv = schur.build_tridiag_planes(op.tdiag.double(),
                                              op.tupper.double())
    pre = pre._replace(alphas=al.float().contiguous(),
                       gammas=ga.float().contiguous(),
                       binv=binv.float().contiguous())
    return op, pre, rhs


@pytest.mark.cuda
@pytest.mark.parametrize("restart", [True, False])
@pytest.mark.parametrize("nc", [0, 4])
@pytest.mark.parametrize("schedule", ["grid", "split"])
@pytest.mark.parametrize("dp", [3, 6])
def test_split_schedules_match_plain_version(cuda, dp, schedule, nc,
                                             restart):
    """The split schedules (csrc/fused_pcg_chunk.cu, fused_pcg_split_kernel)
    against the plain version: 100 poses, which 16 blocks do not divide
    (7 a block, the last rank none), and on the grid Mw=200 (dp=3) or 300
    (dp=6) over 112 blocks, so the last blocks hold no column; PCR (L=7),
    with and without a coarse level of 4 groups, a fresh and a carried
    chunk; one counted launch each, and the same bits on a rerun."""
    op, pre, rhs = _pcr_system(np_=100, mw=100 * (dp - 1), nc=nc, dp=dp)
    op, pre, rhs = _to(op, cuda), _to(pre, cuda), rhs.to(cuda)
    plan = fp.b1_schedule(cuda.index or 0, dp, 100, 100 * (dp - 1), nc, 7,
                          schedule)
    assert plan.schedule == schedule and plan.poses_per_block == 7
    st, atol2 = _start(rhs)
    if not restart:
        st = fp.fused_pcg_chunk_ref(op, pre, rhs, st, atol2, 200, True, 8)
    before = fp.fused_pcg_chunk.launches
    ker = fp._launch(op, pre, rhs, st, atol2, 200, restart, 8,
                     schedule=schedule)
    again = fp._launch(op, pre, rhs, st, atol2, 200, restart, 8,
                       schedule=schedule)
    torch.cuda.synchronize()
    assert fp.fused_pcg_chunk.launches == before + 2
    ref = fp.fused_pcg_chunk_ref(op, pre, rhs, st, atol2, 200, restart, 8)
    assert int(ker.it) == int(ref.it) and int(ker.stop) == int(ref.stop)
    assert float((ker.x - ref.x).abs().max() / ref.x.abs().max()) <= 1e-4
    assert float((ker.rt - ref.rt).abs().max()) <= \
        1e-4 * float(rhs.abs().max())
    for name in fp.ChunkState._fields:
        assert torch.equal(getattr(ker, name), getattr(again, name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["grid", "split"])
def test_split_schedule_matvec(cuda, schedule):
    """A launch of no iteration returns rhs - S x in its true residual: the
    split matvec alone (U's columns over the blocks, the cluster and grid
    sums, T at the elements), within 1e-5 of max|S x| of the plain
    operator, at 100 poses and Mw=200."""
    op, pre, rhs = _pcr_system(np_=100, mw=200)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=rhs.shape).astype(np.float32))
    z = torch.zeros_like(x)
    st = fp.ChunkState(x=x, r=z, p=z, rt=z,
                       it=torch.zeros(1, dtype=torch.int32),
                       rz=torch.zeros(1),
                       stop=torch.zeros(1, dtype=torch.int32),
                       rr=torch.zeros(1))
    op, pre, rhs, st = _to(op, cuda), _to(pre, cuda), rhs.to(cuda), \
        _to(st, cuda)
    ker = fp._launch(op, pre, rhs, st, torch.zeros(1, device=cuda), 200,
                     True, 0, schedule=schedule)
    sx = fp.fused_matvec_ref(op, st.x)
    assert float((ker.rt - (rhs - sx)).abs().max()) <= \
        1e-5 * float(sx.abs().max())
    assert torch.equal(ker.x, st.x)


@pytest.mark.cuda
@pytest.mark.parametrize("dp,np_,mw", [(3, 1088, 768), (6, 128, 1536),
                                       (3, 2048, 768)])
def test_grid_schedule_at_the_path_layouts(cuda, dp, np_, mw):
    """The layouts the plan sends card-wide (multi-loop-1k, the ba3d bench
    row, the 2000-pose request: planes from L2) with PCR at their levels:
    the plan picks the grid, the chunk agrees with the plain version, a
    rerun gives the same bits, and no instantiation spills registers but
    the cluster schedule at dp=3 (8 bytes)."""
    op, pre, rhs = _pcr_system(np_=np_, mw=mw, dp=dp)
    nl = pre.alphas.shape[0]
    plan = fp.b1_schedule(cuda.index or 0, dp, np_, mw, 0, nl)
    assert plan.schedule == "grid" and plan.planes == (np_ != 2048)
    op, pre, rhs = _to(op, cuda), _to(pre, cuda), rhs.to(cuda)
    _compare(op, pre, rhs, restart=True, chunk=8)
    st, atol2 = _start(rhs)
    a = fp.fused_pcg_chunk(op, pre, rhs, st, atol2, 200, True, 8)
    b = fp.fused_pcg_chunk(op, pre, rhs, st, atol2, 200, True, 8)
    for name in fp.ChunkState._fields:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    # the cluster schedule at dp=3 keeps 8 bytes of spilled registers (576
    # threads, 96 registers each); every other instantiation none
    for d in fp.KERNEL_DPS:
        for split in (False, True):
            want = 8 if (d, split) == (3, False) else 0
            assert fp.b1_kernel_attrs(d, split)["local_bytes"] <= want, \
                (d, split)


@pytest.mark.cuda
def test_forced_schedule_the_card_refuses_raises(cuda):
    """A forced schedule that does not fit raises; nothing gives way."""
    op, pre, rhs = _pcr_system(np_=1088, mw=768)
    op, pre, rhs = _to(op, cuda), _to(pre, cuda), rhs.to(cuda)
    st, atol2 = _start(rhs)
    with pytest.raises(ValueError, match="split schedule"):
        fp._launch(op, pre, rhs, st, atol2, 200, True, 4, schedule="split")


@pytest.mark.cuda
@pytest.mark.parametrize("restart", [True, False])
def test_dp6_band_kernel_matches_plain_version(cuda, restart):
    """band_fused_pcg_chunk_kernel<6>: 60 chunks x 2 windows x 6 components
    x 256 rows, more units than clusters."""
    op, pre, rhs = _tiny_band(np_=1000, n_chunks=60, w_row=256, dp=6)
    op, pre, rhs = _to(op, cuda), _to(pre, cuda), rhs.to(cuda)
    st, atol2 = _start(rhs)
    if not restart:
        st = fp.band_fused_pcg_chunk_ref(op, pre, rhs, st, atol2, 200, True, 8)
    before = fp.band_fused_pcg_chunk.launches
    ker = fp.band_fused_pcg_chunk(op, pre, rhs, st, atol2, 200, restart, 8)
    again = fp.band_fused_pcg_chunk(op, pre, rhs, st, atol2, 200, restart, 8)
    torch.cuda.synchronize()
    assert fp.band_fused_pcg_chunk.launches == before + 2
    ref = fp.band_fused_pcg_chunk_ref(op, pre, rhs, st, atol2, 200, restart, 8)
    assert int(ker.it) == int(ref.it) and int(ker.stop) == int(ref.stop)
    assert float((ker.x - ref.x).abs().max() / ref.x.abs().max()) <= 1e-4
    assert float((ker.rt - ref.rt).abs().max()) <= \
        1e-4 * float(rhs.abs().max())
    for name in fp.ChunkState._fields:
        assert torch.equal(getattr(ker, name), getattr(again, name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("np_,W,B", [(1024, 64, 256), (512, 96, 64),
                                     (1000, 40, 64), (10240, 576, 512)])
def test_slab_band_matvec_matches_plain_version(cuda, np_, W, B):
    """B3 (csrc/slab_band_matvec.cu) against its plain version: W < B,
    W > B, Np not a multiple of B, and a sweep shape; rel 1e-5 of max|want|
    and the same bits on a rerun."""
    from toyslam_torch.ops import band_matvec as bmv

    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(3, np_)), dtype=torch.float32,
                     device=cuda)
    slab = torch.tensor(rng.normal(size=(np_ // B, W, 6, B)),
                        dtype=torch.float32, device=cuda)
    before = bmv.slab_band_matvec.launches
    got = bmv.slab_band_matvec(x, slab, W, B)
    again = bmv.slab_band_matvec(x, slab, W, B)
    torch.cuda.synchronize()
    assert bmv.slab_band_matvec.launches == before + 2
    want = bmv.slab_band_matvec_ref(x, slab, W, B)
    assert float((got - want).abs().max()) <= \
        1e-5 * float(want.abs().max())
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("np_,W,B,cs", [
    (1024, 1, 256, None), (1024, 33, 64, 4), (1024, 33, 64, 8),
    (520, 96, 40, None), (1000, 40, 64, 3), (500, 50, 37, None),
    (100, 8, 128, None), (2048, 800, 256, None), (2048, 1024, 256, None)])
def test_slab_band_matvec_edge_shapes(cuda, np_, W, B, cs):
    """B3 at W=1, W=33 on clusters of 4 and of 7 (the last rank short),
    W > B with B=40 (a short last tile), Np=1000 with B=64 on 3 ranks, a B
    that is not a multiple of 4 (4-byte copies), Np < B (no landmark), and
    the widest windows, on 8 blocks of 16 warps x 7 and x 8 rows: rel 1e-5
    of max|want|, the same bits on a rerun, one counted launch per call,
    the plan's shared memory as the kernel computes it, and no spilled
    register.  A forced cluster size goes through ``_launch`` (the smoke's
    sweep), the plan's own through the wrapper."""
    from toyslam_torch.ops import band_matvec as bmv

    rng = np.random.default_rng(1)
    x = torch.tensor(rng.normal(size=(3, np_)), dtype=torch.float32,
                     device=cuda)
    slab = torch.tensor(rng.normal(size=(np_ // B, W, 6, B)),
                        dtype=torch.float32, device=cuda)
    plan = bmv.slab_plan(W, B, cs)
    attrs = bmv._tile_attrs(plan)
    assert attrs["smem_bytes"] == plan.smem_bytes
    assert attrs["local_bytes"] == 0

    def run():
        if cs is None:
            return bmv.slab_band_matvec(x, slab, W, B)
        return bmv._launch(x, slab, W, B, plan)

    before = bmv.slab_band_matvec.launches
    got = run()
    assert bmv.slab_band_matvec.launches == before + 1
    again = run()
    torch.cuda.synchronize()
    assert bmv.slab_band_matvec.launches == before + 2
    want = bmv.slab_band_matvec_ref(x, slab, W, B)
    assert torch.isfinite(got).all() and got.shape == (3, np_)
    assert float((got - want).abs().max()) <= \
        1e-5 * float(want.abs().max())
    assert torch.equal(got, again)
