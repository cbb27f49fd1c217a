"""The SE(3) edges' kernels (csrc/edges3d.cu, ops/edges3d_kernel.py) and
the dispatch of ``schur3d`` to them.

This file imports neither JAX nor the JAX package, so the GPU tests run on
a machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_edges3d_kernel.py

On the CPU, in float32 and float64, ``assemble_blocks_3d`` and
``total_error_3d`` take the plain version (the batched formulas of
``residuals3d`` and ``edge_blocks3d``, held against the JAX package by
tests/test_torch_se3.py and tests/test_torch_ba.py): the same bits as
before the kernels, no launch.  On the card they take the kernels, which
take float32 alone: float64 there is refused.  The wrapper's refusals run
without a card.  Tests marked ``cuda`` hold the kernels' float32 outputs
against the plain version in float64 (on the CPU), and require the plain
version in float32 to meet the same tolerances on the same inputs:

* the relative-pose Jacobians within 1e-5 of each edge's largest entry of
  ``jacfwd``'s;
* each per-edge block tensor within 1e-5 of its largest entry, the
  relative-pose edges' with the exact Jacobians and with ``A = -I,
  B = I``;
* the summed robust chi^2 within 1.5e-7 (the configuration's
  ``chi2_start_gap`` limit is 3e-7);

on the benchmark configuration's maps (points inside its near plane and
behind a camera), at the start and off it, with four intrinsics, and on
relative poses at the identity and across rotation angles; and two
launches an assembly and a chi^2, the same bits on a rerun, no spilled
register, and a whole LM solve of a pool map within the configuration's
limits against the plain float64 reference (``slambench/reference_se3``).
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from slambench import check
from slambench.families import se3 as family
from slambench.graphs import camera_ring
from toyslam_torch.config import OptimizerConfig
from toyslam_torch.models.graph3d import (FactorGraph3D, Odom3DEdges,
                                          ReprojEdges)
from toyslam_torch.ops import blockmath as bm
from toyslam_torch.ops import edge_blocks3d as eb3
from toyslam_torch.ops import edges3d_kernel as k3
from toyslam_torch.ops import gather_plan as gp
from toyslam_torch.ops import residuals3d as res3
from toyslam_torch.ops import schur3d, se3
from toyslam_torch.ops.gather_plan import attach_plan
from toyslam_torch.optimizer import GaussNewton

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads(
    (ROOT / "slambench/configs/ba3d-512x4096.json").read_text())
OPT = CONFIG["optimizer"]
NEAR = CONFIG["graph"]["near_plane"]
DELTA = OPT["huber_delta"]
FULL = dict(num_poses=512, num_landmarks=4096, obs_per_pose=24)
SMALL = dict(num_poses=16, num_landmarks=64, obs_per_pose=24)
TOL = {"jacobians": 1e-5, "blocks": 1e-5, "chi2": 1.5e-7}
# the kernel names the benchmark's b1_roofline and b2_roofline readers match
ROOFLINE_NAMES = ("fused_pcg_chunk_kernel", "fused_pcg_split_kernel",
                  "band_fused_pcg_chunk_kernel")


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def _map(seed, size=FULL, near=NEAR, moved=0.0, dtype=torch.float32,
         device="cpu") -> FactorGraph3D:
    """A camera-ring map of the configuration's kind (``near`` None: four
    intrinsics), its gather tables attached, its state moved by ``moved``
    from a fixed seed (off the start, where the relative-pose residuals
    are rounding alone)."""
    arrays = camera_ring.generate(seed, near_plane=near, **size)["graph"]
    graph = attach_plan(family.program_graph(arrays), want_band=False)
    rng = np.random.default_rng(seed + 1)
    step = torch.tensor(rng.normal(0.0, moved, (graph.num_poses, 6)),
                        dtype=torch.float32)
    lm = torch.tensor(rng.normal(0.0, moved, graph.landmarks.shape),
                      dtype=torch.float32)
    graph = graph.with_state(se3.retract(graph.poses, step),
                             graph.landmarks + lm)
    return graph.astype(dtype).to(device)


# --- the plain version before the kernels, verbatim -----------------------


def _assemble_before(graph, huber_delta, fixed_prior, exact):
    """``schur3d.assemble_blocks_3d``'s body before the kernels."""
    plan = schur3d._plan(graph)
    t_oi, t_oj = plan.odom_by_i, plan.odom_by_j
    t_lp, t_ll = plan.lm_by_pose, plan.lm_by_lm
    od = res3.eval_odom3d_edges(
        graph.poses, graph.odom.i, graph.odom.j, graph.odom.meas,
        graph.odom.info, graph.odom.mask, huber_delta, exact=exact)
    rb = eb3.reproj_edge_blocks(
        graph.poses, graph.landmarks, graph.intrinsics,
        graph.lm_edges.pose, graph.lm_edges.lm, graph.lm_edges.meas,
        graph.lm_edges.info, graph.lm_edges.mask, huber_delta)
    w_od = od.w[:, None, None] * graph.odom.info
    wr = bm.mv(w_od, od.r)
    bp = (gp.table_sum(bm.mtv(od.JA, wr), t_oi)
          + gp.table_sum(bm.mtv(od.JB, wr), t_oj))
    hpp_diag = (gp.table_sum(bm.quad(od.JA, w_od), t_oi)
                + gp.table_sum(bm.quad(od.JB, w_od), t_oj))
    hpp_off = bm.mtm(od.JA, bm.mm(w_od, od.JB))
    hpp_diag = hpp_diag + gp.table_sum(rb.w_ata, t_lp)
    hll = gp.table_sum(rb.w_btb, t_ll)
    bp = bp + gp.table_sum(rb.bp_c, t_lp)
    bl = gp.table_sum(rb.bl_c, t_ll)
    err = od.robust_err.sum() + rb.robust_err.sum()
    eye6 = torch.eye(6, dtype=hpp_diag.dtype, device=hpp_diag.device)
    eye3 = torch.eye(3, dtype=hll.dtype, device=hll.device)
    pose_reg = fixed_prior * graph.pose_fixed + (1.0 - graph.pose_mask)
    lm_reg = fixed_prior * graph.lm_fixed + (1.0 - graph.lm_mask)
    hpp_diag = hpp_diag + pose_reg[:, None, None] * eye6
    hll = hll + lm_reg[:, None, None] * eye3
    bp = bp * (1.0 - graph.pose_fixed)[:, None]
    bl = bl * (1.0 - graph.lm_fixed)[:, None]
    return dict(hpp_diag=hpp_diag, hpp_off=hpp_off, hll=hll, hpl=rb.w_hpl,
                bp=bp, bl=bl, err=err)


def _total_error_before(graph, huber_delta):
    """``schur3d.total_error_3d``'s body before the kernels."""
    od = res3.eval_odom3d_edges(
        graph.poses, graph.odom.i, graph.odom.j, graph.odom.meas,
        graph.odom.info, graph.odom.mask, huber_delta, exact=False)
    rp = res3.eval_reproj_edges(
        graph.poses, graph.landmarks, graph.intrinsics,
        graph.lm_edges.pose, graph.lm_edges.lm, graph.lm_edges.meas,
        graph.lm_edges.info, graph.lm_edges.mask, huber_delta)
    return od.robust_err.sum() + rp.robust_err.sum()


# --- without a card ----------------------------------------------------------


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("near", [NEAR, None])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_and_float64_assemble_as_before(dtype, near, exact):
    """A CPU graph, float32 or float64, assembles the blocks and chi^2 of
    the plain version before the kernels bit for bit and launches
    nothing."""
    graph = _map(1, SMALL, near=near, moved=0.02, dtype=dtype)
    before = k3.launches
    got = schur3d.assemble_blocks_3d(graph, DELTA, OPT["fixed_prior"],
                                     exact_odom_jacobians=exact)
    want = _assemble_before(graph, DELTA, OPT["fixed_prior"], exact)
    assert k3.launches == before
    for name, w in want.items():
        g = getattr(got, name)
        assert g.dtype == dtype and torch.equal(g, w), name


@pytest.mark.parametrize("near", [NEAR, None])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_and_float64_chi2_as_before(dtype, near):
    graph = _map(1, SMALL, near=near, moved=0.02, dtype=dtype)
    before = k3.launches
    got = schur3d.total_error_3d(graph, DELTA, exact_odom_jacobians=True)
    assert k3.launches == before
    assert torch.equal(got, _total_error_before(graph, DELTA))


@pytest.mark.parametrize("exact", [True, False])
def test_cpu_assembly_and_chi2_read_the_same_bits(exact):
    """The plain version's assembly and step-rejection chi^2 of one state
    agree bit for bit (the card's kernels are held to the same)."""
    graph = _map(1, SMALL, moved=0.02)
    sys = schur3d.assemble_blocks_3d(graph, DELTA, exact_odom_jacobians=exact)
    assert torch.equal(sys.err, schur3d.total_error_3d(graph, DELTA))


def test_the_kernels_refuse_float64_poses():
    """The kernels take float32 alone: float64 poses are refused before
    any launch (on the card, where ``schur3d`` hands every graph to them,
    a float64 graph raises; it is not evaluated by other means)."""
    g = _map(0, SMALL)
    before = k3.launches
    with pytest.raises(TypeError, match="poses of dtype torch.float64"):
        k3.edge_blocks(g.poses.double(), g.landmarks, g.intrinsics, g.odom,
                       g.lm_edges, DELTA, exact=True)
    with pytest.raises(TypeError, match="poses of dtype torch.float64"):
        k3.odom_errors(g.poses.double(), g.odom, DELTA)
    assert k3.launches == before


def _bad(case):
    """A graph's tensors with one fault (``cpu``: valid, but no card)."""
    g = _map(0, SMALL)
    poses, lms, k, od, lm = (g.poses, g.landmarks, g.intrinsics, g.odom,
                             g.lm_edges)
    if case == "poses_shape":
        poses = poses[:, :9]
    elif case == "intrinsics_shape":
        k = k[:3]
    elif case == "info_shape":
        od = Odom3DEdges(od.i, od.j, od.meas, od.info[:, :3], od.mask)
    elif case == "mask_length":
        lm = ReprojEdges(lm.pose, lm.lm, lm.meas, lm.info, lm.mask[:-1])
    elif case == "float64_info":
        lm = ReprojEdges(lm.pose, lm.lm, lm.meas, lm.info.double(), lm.mask)
    elif case == "int32_index":
        od = Odom3DEdges(od.i.int(), od.j, od.meas, od.info, od.mask)
    elif case == "not_contiguous":
        od = Odom3DEdges(od.i, od.j, od.meas,
                         od.info.transpose(1, 2).contiguous().transpose(1, 2),
                         od.mask)
        assert not od.info.is_contiguous()
    elif case == "meta_device":
        lms = lms.to("meta")
    return poses, lms, k, od, lm


# the faults of the reprojection edges reach edge_blocks and edge_errors
# alone: odom_jacobians reads the relative-pose edges
REFUSALS = [("poses_shape", ValueError), ("info_shape", ValueError),
            ("int32_index", TypeError), ("not_contiguous", ValueError),
            ("cpu", ValueError)]
REPROJ_REFUSALS = [("intrinsics_shape", ValueError),
                   ("mask_length", ValueError), ("float64_info", TypeError),
                   ("meta_device", ValueError)]


@pytest.mark.parametrize("entry,case,err", [
    (entry, case, err)
    for entry in ("edge_blocks", "edge_errors", "odom_jacobians")
    for case, err in REFUSALS + (
        REPROJ_REFUSALS if entry != "odom_jacobians" else [])
])
def test_wrapper_refuses_what_the_kernels_do_not_take(entry, case, err):
    poses, lms, k, od, lm = _bad(case)
    before = k3.launches
    with pytest.raises(err):
        if entry == "edge_blocks":
            k3.edge_blocks(poses, lms, k, od, lm, DELTA, exact=True)
        elif entry == "edge_errors":
            k3.edge_errors(poses, lms, k, od, lm, DELTA)
        else:
            k3.odom_jacobians(poses, od, DELTA)
    assert k3.launches == before


def test_kernel_source_has_no_atomics_and_misses_the_roofline_readers():
    """No atomic in the source (the sums stay in the caller's fixed order),
    and no kernel name the benchmark's roofline readers match."""
    src = (ROOT / "toyslam_torch" / "csrc" / "edges3d.cu").read_text()
    assert not re.search(r"\batomic\w*\s*[(<]", src)
    names = set(re.findall(r"\b(\w+_kernel)\s*[(<]", src))
    assert names == {"odom3d_kernel", "reproj_kernel"}
    assert not any(r in n for n in names for r in ROOFLINE_NAMES)


# --- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rel(a, b):
    """Largest error over the largest entry of ``b`` (on ``b``'s device)."""
    a = a.to(b.device, torch.float64)
    return float((a - b).abs().max() / b.abs().max())


def _rel_per_edge(a, b):
    """Largest over edges of each edge's largest error over its largest
    entry of ``b`` (on ``b``'s device)."""
    err = (a.to(b.device, torch.float64) - b).abs().flatten(1).max(1).values
    return float((err / b.abs().flatten(1).max(1).values).max())


def _errors(graph):
    """The kernels' and the float32 plain version's errors against the
    float64 plain version (on the CPU), on ``graph`` (float32 on the card);
    ``odom_fixed`` the relative-pose blocks with ``A = -I, B = I``."""
    cpu = graph.to("cpu")
    g64 = cpu.astype(torch.float64)
    args = (graph.odom, graph.lm_edges, DELTA)
    ob, rb = k3.edge_blocks(graph.poses, graph.landmarks, graph.intrinsics,
                            *args, exact=True)
    ob_fixed = k3.odom_blocks(graph.poses, graph.odom, DELTA, exact=False)
    ja, jb = k3.odom_jacobians(graph.poses, graph.odom, DELTA)
    chi2 = schur3d.total_error_3d(graph, DELTA)
    err = schur3d.assemble_blocks_3d(graph, DELTA, exact_odom_jacobians=True
                                     ).err
    args64 = (g64.poses, g64.landmarks, g64.intrinsics, g64.odom,
              g64.lm_edges, DELTA)
    args32 = (cpu.poses, cpu.landmarks, cpu.intrinsics, cpu.odom,
              cpu.lm_edges, DELTA)
    want = (schur3d.edge_blocks_3d(*args64, exact=True)
            + schur3d.edge_blocks_3d(*args64, exact=False)[:1])
    plain = (schur3d.edge_blocks_3d(*args32, exact=True)
             + schur3d.edge_blocks_3d(*args32, exact=False)[:1])
    od64 = res3.eval_odom3d_edges(g64.poses, g64.odom.i, g64.odom.j,
                                  g64.odom.meas, g64.odom.info, g64.odom.mask,
                                  DELTA, exact=True)
    od32 = res3.eval_odom3d_edges(cpu.poses, cpu.odom.i, cpu.odom.j,
                                  cpu.odom.meas, cpu.odom.info, cpu.odom.mask,
                                  DELTA, exact=True)
    chi2_64 = float(schur3d.total_error_3d(g64, DELTA))
    chi2_32 = float(schur3d.total_error_3d(cpu, DELTA))
    out = {"kernel": {}, "plain32": {}}
    for who, blocks in (("kernel", (ob, rb, ob_fixed)), ("plain32", plain)):
        for part, got, w in zip(("odom", "reproj", "odom_fixed"), blocks,
                                want):
            for name in w._fields:
                if name not in ("robust_err", "chi2"):
                    out[who][f"{part}.{name}"] = _rel(getattr(got, name),
                                                      getattr(w, name))
    out["kernel"]["JA"] = _rel_per_edge(ja, od64.JA)
    out["kernel"]["JB"] = _rel_per_edge(jb, od64.JB)
    out["plain32"]["JA"] = _rel_per_edge(od32.JA, od64.JA)
    out["plain32"]["JB"] = _rel_per_edge(od32.JB, od64.JB)
    out["kernel"]["chi2"] = abs(float(chi2) - chi2_64) / chi2_64
    out["kernel"]["assemble_err"] = abs(float(err) - chi2_64) / chi2_64
    out["plain32"]["chi2"] = abs(chi2_32 - chi2_64) / chi2_64
    return out, rb


def _within(errs):
    bad = {}
    for who, e in errs.items():
        for name, v in e.items():
            tol = (TOL["jacobians"] if name in ("JA", "JB") else
                   TOL["chi2"] if name in ("chi2", "assemble_err") else
                   TOL["blocks"])
            if not v <= tol:
                bad[f"{who}.{name}"] = v
    return bad


# Graph seeds of the configuration's maps: 1 and 18 have points inside
# the near plane and behind a camera at the start (22 and 15 inside, 5 and
# 3 behind), 23 two inside, 2200000522 one behind (depth -0.02).
@pytest.mark.cuda
@pytest.mark.parametrize("moved", [0.0, 0.02])
@pytest.mark.parametrize("seed,near", [
    (1, NEAR), (18, NEAR), (23, NEAR), (2200000522, NEAR), (0, NEAR),
    (0, None), (1, None),
])
def test_kernels_match_the_plain_version(cuda, seed, near, moved):
    graph = _map(seed, near=near, moved=moved, device=cuda)
    errs, rb = _errors(graph)
    if not moved:
        # at the start the initial cameras integrate the relative poses, so
        # those residuals are float32 rounding alone, and so are their
        # gradients b_a, b_b in either float32 version (up to 1.8 times
        # the float64 largest entry, CPU): off the start they are held
        for e in errs.values():
            for part in ("odom", "odom_fixed"):
                del e[f"{part}.b_a"], e[f"{part}.b_b"]
    assert not _within(errs), (_within(errs), errs)
    if moved:
        # off the start Huber has outliers to weigh
        assert int((rb.chi2 > DELTA ** 2).sum()) > 0


def _odom_set(device):
    """Relative poses at the identity and across rotation angles: random
    cameras 8 from the origin on the scale of the configuration's ring,
    the first two with the identity rotation, which float32 holds exactly,
    so the first edge's residual rotation is the identity (log_so3's
    near_zero series); then residual rotations of 1e-9 to 2.5 rad; the
    last edge masked out (padding)."""
    rng = np.random.default_rng(3)
    n = 40
    R = se3.exp_so3(torch.tensor(rng.normal(size=(n, 3))))
    R[0] = R[1] = torch.eye(3, dtype=torch.float64)
    t = torch.tensor(rng.normal(size=(n, 3)) * 8)
    poses = se3.make(R, t).float()
    i = torch.arange(n - 1)
    j = i + 1
    angles = np.concatenate([[0.0, 1e-9, 1e-6, 1e-4, 1e-3, 3e-3, 1e-2, 0.1,
                              0.5, 1.0, 2.0, 2.5],
                             rng.uniform(0, 2.5, n - 13)])
    axes = rng.normal(size=(n - 1, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    noise = se3.make(se3.exp_so3(torch.tensor(axes * angles[:, None])),
                     torch.tensor(rng.normal(size=(n - 1, 3)) * 0.05))
    meas = se3.compose(se3.relative(poses[i].double(), poses[j].double()),
                       se3.inverse(noise)).float()
    meas[0] = se3.relative(poses[0:1], poses[1:2])[0]
    info = torch.diag(torch.tensor([400.0] * 3 + [1e4] * 3)).expand(
        n - 1, 6, 6).contiguous()
    mask = torch.ones(n - 1)
    mask[-1] = 0.0
    odom = Odom3DEdges(i=i, j=j, meas=meas, info=info, mask=mask)
    return poses.to(device), odom.to(device)


@pytest.mark.cuda
def test_relative_pose_jacobians_at_the_identity_and_across_angles(cuda):
    poses, odom = _odom_set(cuda)
    r64 = res3.eval_odom3d_edges(poses.double(), odom.i, odom.j,
                                 odom.meas.double(), odom.info.double(),
                                 odom.mask.double(), DELTA, exact=True)
    # the identity: log_so3's near_zero series at cos = 1
    assert float(r64.r[0, 3:].abs().max()) == 0.0
    cpu = poses.cpu()
    r32 = res3.eval_odom3d_edges(cpu, odom.i.cpu(), odom.j.cpu(),
                                 odom.meas.cpu(), odom.info.cpu(),
                                 odom.mask.cpu(), DELTA, exact=True)
    ja, jb = k3.odom_jacobians(poses, odom, DELTA)
    for got in ((ja, jb), (r32.JA.to(cuda), r32.JB.to(cuda))):
        assert _rel_per_edge(got[0], r64.JA) <= TOL["jacobians"]
        assert _rel_per_edge(got[1], r64.JB) <= TOL["jacobians"]


@pytest.mark.cuda
def test_masked_edges_and_huber_outliers(cuda):
    """Padding edges (mask 0) add nothing; an edge past Huber's delta is
    weighed down as the plain version weighs it."""
    poses, odom = _odom_set(cuda)
    g = _map(1, near=NEAR, moved=0.02, device=cuda)
    ob, rb = k3.edge_blocks(poses, g.landmarks, g.intrinsics, odom,
                            g.lm_edges, DELTA, exact=True)
    for t in ob:
        assert float(t[-1].abs().max()) == 0.0
    assert bool(torch.isfinite(ob.w_aa).all())
    want = res3.eval_odom3d_edges(poses.double(), odom.i, odom.j,
                                  odom.meas.double(), odom.info.double(),
                                  odom.mask.double(), DELTA, exact=True)
    outliers = want.chi2 > DELTA ** 2
    assert 0 < int(outliers.sum()) < outliers.numel()
    assert _rel(ob.robust_err, want.robust_err) <= TOL["blocks"]


@pytest.mark.cuda
def test_an_index_outside_its_table_gives_nan(cuda):
    poses, odom = _odom_set(cuda)
    i = odom.i.clone()
    i[3] = poses.shape[0]
    bad = Odom3DEdges(i=i, j=odom.j, meas=odom.meas, info=odom.info,
                      mask=odom.mask)
    g = _map(0, SMALL, device=cuda)
    ob, _ = k3.edge_blocks(poses, g.landmarks, g.intrinsics, bad,
                           g.lm_edges, DELTA, exact=True)
    assert bool(torch.isnan(ob.w_aa[3]).all())
    assert bool(torch.isfinite(ob.w_aa[:3]).all())


@pytest.mark.cuda
def test_launches_and_the_same_bits_on_a_rerun(cuda):
    """Two launches an assembly and two a chi^2; a rerun repeats every
    output bit for bit; float64 on the card is refused and launches
    nothing."""
    graph = _map(1, near=NEAR, moved=0.02, device=cuda)
    before = k3.launches
    a = schur3d.assemble_blocks_3d(graph, DELTA, exact_odom_jacobians=True)
    assert k3.launches == before + 2
    b = schur3d.assemble_blocks_3d(graph, DELTA, exact_odom_jacobians=True)
    e1 = schur3d.total_error_3d(graph, DELTA)
    assert k3.launches == before + 6
    e2 = schur3d.total_error_3d(graph, DELTA)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(e1, e2)
    g64 = graph.astype(torch.float64)
    before = k3.launches
    with pytest.raises(TypeError):
        schur3d.assemble_blocks_3d(g64, DELTA, exact_odom_jacobians=True)
    with pytest.raises(TypeError):
        schur3d.total_error_3d(g64, DELTA)
    assert k3.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [True, False])
def test_the_step_rejection_compares_like_with_like(cuda, exact):
    """The chi^2 of a state from the assembly's launches and from the
    residuals-only launches are the same bits, as the plain version's are:
    the LM step rejection accepts a step that leaves the state as it was,
    and compares every other on the same rounding."""
    for seed, moved in ((1, 0.0), (1, 0.02), (18, 0.02)):
        graph = _map(seed, near=NEAR, moved=moved, device=cuda)
        sys = schur3d.assemble_blocks_3d(graph, DELTA,
                                         exact_odom_jacobians=exact)
        assert torch.equal(sys.err, schur3d.total_error_3d(graph, DELTA))


@pytest.mark.cuda
def test_kernels_keep_their_registers(cuda):
    """No instantiation spills to local memory, by the card's attributes
    and by ptxas's own report."""
    attrs = k3.kernel_attrs()
    assert set(attrs) == set(k3.INSTANTIATIONS)
    for name, a in attrs.items():
        assert a["local_bytes"] == 0, (name, a)
    from toyslam_torch import kernels

    log = kernels.load("edges3d").ptxas_log
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        log)
    assert spills and all(s == ("0", "0") for s in spills), log
    frames = re.findall(r"(\d+) bytes stack frame", log)
    assert frames and all(f == "0" for f in frames), log


@pytest.mark.cuda
def test_profiler_names_two_kernels_an_assembly(cuda):
    graph = _map(0, SMALL, device=cuda)
    schur3d.assemble_blocks_3d(graph, DELTA, exact_odom_jacobians=True)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        schur3d.assemble_blocks_3d(graph, DELTA, exact_odom_jacobians=True)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    ours = [n for n in names if "odom3d_kernel" in n or "reproj_kernel" in n]
    assert len(ours) == 2, names
    assert not any(r in n for n in names for r in ROOFLINE_NAMES)


@pytest.mark.cuda
def test_a_pool_maps_solve_through_the_kernels(cuda):
    """The configuration's 20-iteration LM solve of one pool map (graph
    seed 1: points inside the near plane and behind a camera) on the card,
    four launches a GN iteration, judged under the configuration's limits
    against the float64 reference."""
    problem = camera_ring.generate(1, near_plane=NEAR, **FULL)
    gn = GaussNewton(OptimizerConfig(**OPT))
    graph = gn._prepare(family.program_graph(problem["graph"])).to(cuda)
    before = k3.launches
    res = gn.optimize(graph)
    torch.cuda.synchronize()
    assert k3.launches - before == 4 * res.iterations_run
    ref = family.optimize(problem["graph"], OPT, cuda, family.REFERENCE)
    answer = (res.graph.poses.cpu(), res.graph.landmarks.cpu(),
              res.errors.cpu())
    numbers = family.gaps(problem["graph"], problem["n_poses"],
                          problem["n_landmarks"], OPT, ref, [answer], cuda)
    correct, compared = check.judge(numbers, CONFIG["correct"])
    assert correct, compared
    limits = CONFIG["correct"]
    for name in ("chi2_final_excess", "camera_decrement"):
        assert numbers[name] <= limits[name], (name, numbers[name])
