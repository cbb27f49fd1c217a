"""Keyframe/map-block *state* partitioning: the port of
``toyslam_tpu.parallel.partition``.

The edge-sharded solve (``parallel/distributed.py``) replicates every state
array on every rank.  Here each rank holds only its block:

* **poses** are cut into contiguous keyframe blocks: rank ``d`` owns poses
  ``[d*Nb, (d+1)*Nb)``;
* **landmarks** are permuted so that each rank owns the landmarks first
  observed by its keyframes, padded per rank to ``Mb``;
* **edges** live on the rank that owns their observing pose;
* poses, landmarks, ``hpp_diag``, ``hll``, gradients, PCG iterates and the
  local preconditioner are all ``O(N/D + boundary)`` per rank;
* the only traffic between ranks is **boundary exchange**: the poses and
  landmarks referenced across a cut are listed once in small registries,
  and publishing states or summing partials over them takes a few
  boundary-sized all-reduces per operation (3 per PCG matvec).

Inner products sum scalars; chi^2 is summed once per linearization; the
Galerkin coarse level is a three-level hierarchy
(:func:`_coarse_build_partitioned`) whose only replicated object is the
small super-group system, fed by one ``[Nc2, dp]`` all-reduce per apply.

Each rank runs this in its own process (``torch.distributed``, SPMD): where
the JAX package's ``shard_map`` body psums, the rank calls ``all_reduce``
on its group (``ops/collective.py``), and where it psums a tuple, one
all-reduce takes the tuple.  ``build_partition`` keeps global indices in
the stacked edges and rank-local "ext" indices in the plan; on a rank only
the ext indices are valid.  Under a group the kernels never run.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from toyslam_torch.config import OptimizerConfig
from toyslam_torch.models.graph import FactorGraph2D, TensorTree
from toyslam_torch.models.graph import to_numpy as _np
from toyslam_torch.ops import blockmath as bm
from toyslam_torch.ops import schur
from toyslam_torch.ops.collective import all_gather, all_reduce
from toyslam_torch.ops.schur import SolveStats
from toyslam_torch.parallel.mesh import Mesh


# ---------------------------------------------------------------------------
# the plan (per-rank tables, leading rank axis on the host) and metadata
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PartitionPlan(TensorTree):
    """Per-rank index tables of the partitioned solve.

    :func:`build_partition` stacks every table on a leading rank axis
    ``[D, ...]``; :func:`partition_shard` gives rank ``d`` its ``[...]``
    slice.  "ext" index spaces are ``concat(local block, boundary
    buffer)``: poses ``[0, Nb+Bp)``, landmarks ``[0, Mb+Bl)``."""

    # odometry edges (local shard, padded)
    odom_i_loc: torch.Tensor       # int64[D,Eo] local row of pose i (owned)
    odom_j_ext: torch.Tensor       # int64[D,Eo] ext index of pose j
    odom_chain_mask: torch.Tensor  # f32[D,Eo] 1 = j=i+1 on the same rank
    odom_gi: torch.Tensor          # int64[D,Eo] global coarse group of pose i
    odom_gj: torch.Tensor          # int64[D,Eo] global coarse group of pose j
    # landmark edges (local shard, padded)
    lm_p_loc: torch.Tensor         # int64[D,El] local row of observing pose
    lm_ext: torch.Tensor           # int64[D,El] ext index of landmark
    lm_gp: torch.Tensor            # int64[D,El] global coarse group of pose
    # boundary-pose ownership: the registry slots this rank owns
    own_bp_slot: torch.Tensor      # int64[D,Kp]
    own_bp_row: torch.Tensor       # int64[D,Kp] local pose row of each slot
    own_bp_mask: torch.Tensor      # f32[D,Kp]
    # boundary-landmark ownership
    own_bl_slot: torch.Tensor      # int64[D,Kl]
    own_bl_row: torch.Tensor       # int64[D,Kl]
    own_bl_mask: torch.Tensor      # f32[D,Kl]
    # owned landmarks whose edges are all local (no remote observer): their
    # coarse-fill columns are complete on this rank
    lm_interior_mask: torch.Tensor  # f32[D,Mb]
    n_bp: int = 0                  # boundary-pose registry size
    n_bl: int = 0                  # boundary-landmark registry size


class PartitionMeta(NamedTuple):
    """Host-side byproducts of the partition build."""

    n_dev: int
    nb: int                 # poses per rank
    mb: int                 # landmark slots per rank
    n_bp: int               # boundary-pose registry size (padded)
    n_bl: int               # boundary-landmark registry size (padded)
    old_of_new_lm: np.ndarray   # i64[D*mb] original landmark index (-1 pad)
    new_of_old_lm: np.ndarray   # i64[M] permuted landmark index
    boundary_pose_frac: float   # real boundary poses / real poses
    boundary_lm_frac: float     # real boundary landmarks / real landmarks

    def unpermute_landmarks(self, landmarks: np.ndarray,
                            num_old: int) -> np.ndarray:
        """Map optimized landmarks back to the original index order."""
        out = np.zeros((num_old,) + landmarks.shape[1:], landmarks.dtype)
        valid = self.old_of_new_lm >= 0
        out[self.old_of_new_lm[valid]] = np.asarray(landmarks)[valid]
        return out


def _round_up(n: int, k: int) -> int:
    return -(-n // k) * k


def build_partition(
    graph: FactorGraph2D,
    n_dev: int,
    align: int = 64,
    coarse_group: int = 64,
) -> tuple[FactorGraph2D, PartitionMeta]:
    """Host-side partition of a graph (2D or SE(3)) into ``n_dev`` blocks.

    Returns a graph of CPU tensors whose state arrays are padded and
    permuted into rectangular per-rank blocks, whose edge arrays are
    stacked ``[D, E_max, ...]`` in owner order (global indices), and whose
    ``plan`` is the :class:`PartitionPlan`, plus the
    :class:`PartitionMeta`.  The integer tables and the permutation are
    those of the JAX package's ``build_partition``."""
    graph = dataclasses.replace(graph, plan=None).to("cpu")
    n, m = graph.num_poses, graph.num_landmarks
    align = max(align, coarse_group)
    nb = _round_up(max(1, -(-n // n_dev)), align)
    n_p = nb * n_dev

    od_i = _np(graph.odom.i)
    od_j = _np(graph.odom.j)
    od_mask = _np(graph.odom.mask)
    lm_p = _np(graph.lm_edges.pose)
    lm_l = _np(graph.lm_edges.lm)
    lm_mask = _np(graph.lm_edges.mask)
    real_od = od_mask > 0
    real_lm = lm_mask > 0

    owner_pose = np.minimum(np.arange(n_p) // nb, n_dev - 1)

    # --- landmark ownership: the rank of the first observing pose ---------
    first_edge = np.full(m, lm_l.shape[0], np.int64)
    e_idx = np.nonzero(real_lm)[0]
    np.minimum.at(first_edge, lm_l[e_idx], e_idx)
    observed = first_edge < lm_l.shape[0]
    owner_lm = np.where(
        observed,
        owner_pose[np.where(observed, lm_p[np.minimum(
            first_edge, lm_l.shape[0] - 1)], 0)],
        np.arange(m) % n_dev,  # unobserved/padding: round-robin
    )

    # --- landmark permutation into per-rank contiguous blocks -------------
    dev_lists = [np.nonzero(owner_lm == d)[0] for d in range(n_dev)]
    mb = _round_up(max(max(len(ix) for ix in dev_lists), 1), 8)
    m_p = mb * n_dev
    old_of_new = np.full(m_p, -1, np.int64)
    for d, lst in enumerate(dev_lists):
        old_of_new[d * mb: d * mb + len(lst)] = lst
    new_of_old = np.full(m, -1, np.int64)
    valid_new = old_of_new >= 0
    new_of_old[old_of_new[valid_new]] = np.nonzero(valid_new)[0]

    def permute_lm(x):
        x = _np(x)
        out = np.zeros((m_p,) + x.shape[1:], x.dtype)
        out[valid_new] = x[old_of_new[valid_new]]
        return out

    def pad_pose(x):
        x = _np(x)
        out = np.zeros((n_p,) + x.shape[1:], x.dtype)
        out[:n] = x
        return out

    lm_mask_v = permute_lm(graph.lm_mask)
    owner_lm_new = np.arange(m_p) // mb

    # --- edge -> rank assignment ------------------------------------------
    dev_od = np.where(real_od, owner_pose[od_i], 0)
    lm_l_new = np.where(real_lm, new_of_old[np.where(real_lm, lm_l, 0)], 0)
    dev_lm = np.where(real_lm, owner_pose[lm_p], 0)

    # --- boundary registries -----------------------------------------------
    cross_od = real_od & (owner_pose[od_j] != dev_od)
    bp_ids = np.unique(od_j[cross_od])
    n_bp = _round_up(max(len(bp_ids), 1), 8)
    bp_slot_of = np.full(n_p, -1, np.int64)
    bp_slot_of[bp_ids] = np.arange(len(bp_ids))

    cross_lm = real_lm & (owner_lm_new[lm_l_new] != dev_lm)
    bl_ids = np.unique(lm_l_new[cross_lm])
    n_bl = _round_up(max(len(bl_ids), 1), 8)
    bl_slot_of = np.full(m_p, -1, np.int64)
    bl_slot_of[bl_ids] = np.arange(len(bl_ids))

    # --- per-rank stacked edge arrays and local index tables --------------
    def stack_edges(dev_of, fields, count):
        idxs = [np.nonzero((dev_of == d) & count)[0] for d in range(n_dev)]
        cap = _round_up(max(max(len(ix) for ix in idxs), 1), 8)
        out = []
        for f in fields:
            f = _np(f)
            buf = np.zeros((n_dev, cap) + f.shape[1:], f.dtype)
            for d, ix in enumerate(idxs):
                buf[d, : len(ix)] = f[ix]
            out.append(buf)
        sel_mask = np.zeros((n_dev, cap), np.float32)
        for d, ix in enumerate(idxs):
            sel_mask[d, : len(ix)] = 1.0
        return out, sel_mask

    (s_oi, s_oj, s_om, s_oinf), od_m = stack_edges(
        dev_od, [od_i, od_j, graph.odom.meas, graph.odom.info], real_od)
    (s_lp, s_ll, s_lm_, s_linf), lm_m = stack_edges(
        dev_lm, [lm_p, lm_l_new, graph.lm_edges.meas, graph.lm_edges.info],
        real_lm)

    dev_col = np.arange(n_dev)[:, None]
    odom_i_loc = np.where(od_m > 0, s_oi - dev_col * nb, 0)
    j_local = owner_pose[s_oj] == dev_col
    odom_j_ext = np.where(
        od_m > 0,
        np.where(j_local, s_oj - dev_col * nb, nb + bp_slot_of[s_oj]),
        0,
    )
    odom_chain = ((od_m > 0) & j_local & (s_oj == s_oi + 1)).astype(
        np.float32)
    odom_gi = np.where(od_m > 0, s_oi // coarse_group, 0)
    odom_gj = np.where(od_m > 0, s_oj // coarse_group, 0)

    lm_p_loc = np.where(lm_m > 0, s_lp - dev_col * nb, 0)
    l_local = owner_lm_new[s_ll] == dev_col
    lm_ext = np.where(
        lm_m > 0,
        np.where(l_local, s_ll - dev_col * mb, mb + bl_slot_of[s_ll]),
        0,
    )
    lm_gp = np.where(lm_m > 0, s_lp // coarse_group, 0)

    # --- ownership tables over the registries -------------------------------
    def own_tables(ids, slot_of, owner_of, block):
        per_dev = [np.nonzero(owner_of[ids] == d)[0] for d in range(n_dev)]
        k = _round_up(max(max(len(x) for x in per_dev), 1), 8)
        slot = np.zeros((n_dev, k), np.int64)
        row = np.zeros((n_dev, k), np.int64)
        msk = np.zeros((n_dev, k), np.float32)
        for d, sel in enumerate(per_dev):
            ii = ids[sel]
            slot[d, : len(sel)] = slot_of[ii]
            row[d, : len(sel)] = ii - d * block
            msk[d, : len(sel)] = 1.0
        return slot, row, msk

    bp_slot, bp_row, bp_msk = own_tables(bp_ids, bp_slot_of, owner_pose, nb)
    bl_slot, bl_row, bl_msk = own_tables(bl_ids, bl_slot_of, owner_lm_new,
                                         mb)

    # owned landmarks with no remote observers: complete coarse-fill columns
    interior = np.ones((n_dev, mb), np.float32)
    interior[lm_mask_v.reshape(n_dev, mb) == 0] = 0.0
    if len(bl_ids):
        interior[bl_ids // mb, bl_ids % mb] = 0.0

    def t(a, dtype=None):
        a = np.asarray(a)
        if dtype is None and np.issubdtype(a.dtype, np.integer):
            dtype = np.int64
        return torch.as_tensor(a if dtype is None else a.astype(dtype))

    plan = PartitionPlan(
        odom_i_loc=t(odom_i_loc), odom_j_ext=t(odom_j_ext),
        odom_chain_mask=t(odom_chain), odom_gi=t(odom_gi),
        odom_gj=t(odom_gj), lm_p_loc=t(lm_p_loc), lm_ext=t(lm_ext),
        lm_gp=t(lm_gp), own_bp_slot=t(bp_slot), own_bp_row=t(bp_row),
        own_bp_mask=t(bp_msk), own_bl_slot=t(bl_slot),
        own_bl_row=t(bl_row), own_bl_mask=t(bl_msk),
        lm_interior_mask=t(interior), n_bp=n_bp, n_bl=n_bl,
    )
    # type-generic rebuild: FactorGraph3D shares every field name (plus the
    # intrinsics, which dataclasses.replace keeps), and its edge classes
    # share (i, j | pose, lm, meas, info, mask)
    pgraph = dataclasses.replace(
        graph,
        poses=t(pad_pose(graph.poses)),
        landmarks=t(permute_lm(graph.landmarks)),
        pose_mask=t(pad_pose(graph.pose_mask)),
        lm_mask=t(lm_mask_v),
        pose_fixed=t(pad_pose(graph.pose_fixed)),
        lm_fixed=t(permute_lm(graph.lm_fixed)),
        odom=type(graph.odom)(i=t(s_oi), j=t(s_oj), meas=t(s_om),
                              info=t(s_oinf), mask=t(od_m)),
        lm_edges=type(graph.lm_edges)(pose=t(s_lp), lm=t(s_ll),
                                      meas=t(s_lm_), info=t(s_linf),
                                      mask=t(lm_m)),
        plan=plan,
    )
    n_real = int((_np(graph.pose_mask) > 0).sum())
    m_real = int((_np(graph.lm_mask) > 0).sum())
    meta = PartitionMeta(
        n_dev=n_dev, nb=nb, mb=mb, n_bp=n_bp, n_bl=n_bl,
        old_of_new_lm=old_of_new, new_of_old_lm=new_of_old,
        boundary_pose_frac=len(bp_ids) / max(n_real, 1),
        boundary_lm_frac=len(bl_ids) / max(m_real, 1),
    )
    return pgraph, meta


def partition_shard(pgraph, meta: PartitionMeta, rank: int):
    """Rank ``rank``'s block of a partitioned graph: its ``Nb`` poses and
    ``Mb`` landmark slots, its stacked edges and its plan tables (the
    camera intrinsics of an SE(3) graph whole)."""

    def rows(x, size):
        return x[rank * size:(rank + 1) * size]

    def own(tree):
        return dataclasses.replace(tree, **{
            f.name: getattr(tree, f.name)[rank]
            for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), torch.Tensor)})

    return dataclasses.replace(
        pgraph,
        poses=rows(pgraph.poses, meta.nb),
        pose_mask=rows(pgraph.pose_mask, meta.nb),
        pose_fixed=rows(pgraph.pose_fixed, meta.nb),
        landmarks=rows(pgraph.landmarks, meta.mb),
        lm_mask=rows(pgraph.lm_mask, meta.mb),
        lm_fixed=rows(pgraph.lm_fixed, meta.mb),
        odom=own(pgraph.odom),
        lm_edges=own(pgraph.lm_edges),
        plan=own(pgraph.plan),
    )


# ---------------------------------------------------------------------------
# sums and boundary exchange on a rank
# ---------------------------------------------------------------------------


def _segment_sum(values: torch.Tensor, ids: torch.Tensor,
                 num: int) -> torch.Tensor:
    """``out[k] = sum of values[e] over ids[e] == k``, ``index_add_`` on
    int64 ids; ids outside ``[0, num)`` are dropped, as ``segment_sum``
    drops them (padded edges map there on every rank but the first)."""
    valid = (ids >= 0) & (ids < num)
    vals = torch.where(valid.reshape(valid.shape + (1,) * (values.dim() - 1)),
                       values, torch.zeros((), dtype=values.dtype,
                                           device=values.device))
    out = values.new_zeros((num,) + values.shape[1:])
    return out.index_add_(0, torch.where(valid, ids, 0), vals)


def _masked(vals: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return vals * mask.to(vals.dtype).reshape(
        mask.shape + (1,) * (vals.dim() - 1))


def _publish_buf(vals, slot, row, mask, size):
    """The owner's boundary rows scattered into a ``[size, ...]`` registry
    buffer (zero elsewhere); summed across the ranks it is complete."""
    return _segment_sum(_masked(vals[row], mask), slot, size)


def _publish(vals, slot, row, mask, size, group):
    """Every rank ends with the complete ``[size, ...]`` registry buffer of
    the owners' boundary rows: one all-reduce."""
    return all_reduce(group, _publish_buf(vals, slot, row, mask, size))[0]


def _pickup(tail, slot, row, mask, nloc):
    """The owner claims its slots of a summed boundary buffer, adding them
    into its local rows."""
    return _segment_sum(_masked(tail[slot], mask), row, nloc)


# ---------------------------------------------------------------------------
# the rank's solve
# ---------------------------------------------------------------------------


class _LocalSystem(NamedTuple):
    hpp_diag: torch.Tensor   # [Nb,dp,dp] complete (owner rows)
    hpp_off: torch.Tensor    # [Eo,dp,dp] per local odometry edge
    hll: torch.Tensor        # [Mb,dl,dl] complete (owner rows)
    hpl: torch.Tensor        # [El,dp,dl] per local landmark edge
    bp: torch.Tensor         # [Nb,dp]
    bl: torch.Tensor         # [Mb,dl]
    err: torch.Tensor        # [] chi^2 summed over the ranks


def _is_3d(g) -> bool:
    """SE(3)/BA graphs carry camera intrinsics; the partition machinery is
    otherwise block-size generic (dp/dl read off the arrays)."""
    return hasattr(g, "intrinsics")


def _ext_graph(g, x_ext, l_ext):
    """The rank's edges over the extended (local + boundary) state: the
    states ``x_ext``/``l_ext`` and the plan's ext indices in place of the
    global ones, so the single-device residual code runs on it."""
    pl: PartitionPlan = g.plan
    return dataclasses.replace(
        g, poses=x_ext, landmarks=l_ext, plan=None,
        odom=dataclasses.replace(g.odom, i=pl.odom_i_loc, j=pl.odom_j_ext),
        lm_edges=dataclasses.replace(g.lm_edges, pose=pl.lm_p_loc,
                                     lm=pl.lm_ext),
    )


def _linearize_local(g, cfg: OptimizerConfig, x_ext, l_ext):
    """Per-edge linearization on the extended state, SE(2) or SE(3).
    Returns ``(ata, btb, hpp_off, wr_i, wr_j, odom_err, lb)``."""
    e = _ext_graph(g, x_ext, l_ext)
    od_, lm_ = e.odom, e.lm_edges
    if _is_3d(g):
        from toyslam_torch.ops import edge_blocks3d as eb3
        from toyslam_torch.ops import residuals3d as res3

        od = res3.eval_odom3d_edges(
            x_ext, od_.i, od_.j, od_.meas, od_.info, od_.mask,
            cfg.huber_delta, exact=cfg.exact_odom_jacobians)
        lb = eb3.reproj_edge_blocks(
            x_ext, l_ext, g.intrinsics, lm_.pose, lm_.lm, lm_.meas,
            lm_.info, lm_.mask, cfg.huber_delta)
    else:
        from toyslam_torch.ops import edge_blocks
        from toyslam_torch.ops import residuals as res_ops

        lb = edge_blocks.lm_edge_blocks(
            x_ext, l_ext, lm_.pose, lm_.lm, lm_.meas, lm_.info, lm_.mask,
            cfg.huber_delta)
        if not cfg.exact_odom_jacobians:
            ob = edge_blocks.odom_edge_blocks(
                x_ext, od_.i, od_.j, od_.meas, od_.info, od_.mask,
                cfg.huber_delta)
            return (ob.w_info, ob.w_info, -ob.w_info, -ob.wr, ob.wr,
                    ob.robust_err.sum(), lb)
        od = res_ops.eval_odom_edges(
            x_ext, od_.i, od_.j, od_.meas, od_.info, od_.mask,
            cfg.huber_delta, exact=True)
    w_od = od.w[:, None, None] * od_.info
    return (
        bm.quad(od.JA, w_od), bm.quad(od.JB, w_od),
        bm.mtm(od.JA, bm.mm(w_od, od.JB)),
        bm.mtv(od.JA, bm.mv(w_od, od.r)),
        bm.mtv(od.JB, bm.mv(w_od, od.r)),
        od.robust_err.sum(), lb,
    )


def _publish_states(g, group):
    """The boundary poses and landmarks, complete on every rank (one
    all-reduce)."""
    pl: PartitionPlan = g.plan
    return all_reduce(
        group,
        _publish_buf(g.poses, pl.own_bp_slot, pl.own_bp_row, pl.own_bp_mask,
                     pl.n_bp),
        _publish_buf(g.landmarks, pl.own_bl_slot, pl.own_bl_row,
                     pl.own_bl_mask, pl.n_bl),
    )


def _assemble_local(g, cfg: OptimizerConfig, group, pose_bnd,
                    lm_bnd) -> _LocalSystem:
    """Linearize the rank's edge shard into owner-complete local blocks.

    ``pose_bnd [Bp,dp]`` / ``lm_bnd [Bl,dl]`` are the published boundary
    states; cross contributions ride the registry tails of the local sums
    and are summed across the ranks in one all-reduce."""
    pl: PartitionPlan = g.plan
    nb = g.poses.shape[0]
    mb = g.landmarks.shape[0]
    x_ext = torch.cat([g.poses, pose_bnd], dim=0)
    l_ext = torch.cat([g.landmarks, lm_bnd], dim=0)

    ata, btb, hpp_off, wr_i, wr_j, odom_err, lb = _linearize_local(
        g, cfg, x_ext, l_ext)

    # pose-space sums over [Nb + Bp]: row-i terms land locally, row-j terms
    # may land on the registry tail
    hpp_acc = (_segment_sum(ata, pl.odom_i_loc, nb + pl.n_bp)
               + _segment_sum(btb, pl.odom_j_ext, nb + pl.n_bp))
    hpp_acc[:nb] += _segment_sum(lb.w_ata, pl.lm_p_loc, nb)
    bp_acc = (_segment_sum(wr_i, pl.odom_i_loc, nb + pl.n_bp)
              + _segment_sum(wr_j, pl.odom_j_ext, nb + pl.n_bp))
    bp_acc[:nb] += _segment_sum(lb.bp_c, pl.lm_p_loc, nb)
    # landmark-space sums over [Mb + Bl]
    hll_acc = _segment_sum(lb.w_btb, pl.lm_ext, mb + pl.n_bl)
    bl_acc = _segment_sum(lb.bl_c, pl.lm_ext, mb + pl.n_bl)

    err_local = odom_err + lb.robust_err.sum()
    hpp_tail, bp_tail, hll_tail, bl_tail, err = all_reduce(
        group, hpp_acc[nb:], bp_acc[nb:], hll_acc[mb:], bl_acc[mb:],
        err_local)
    bp_own = (pl.own_bp_slot, pl.own_bp_row, pl.own_bp_mask, nb)
    bl_own = (pl.own_bl_slot, pl.own_bl_row, pl.own_bl_mask, mb)
    hpp_diag = hpp_acc[:nb] + _pickup(hpp_tail, *bp_own)
    bp = bp_acc[:nb] + _pickup(bp_tail, *bp_own)
    hll = hll_acc[:mb] + _pickup(hll_tail, *bl_own)
    bl = bl_acc[:mb] + _pickup(bl_tail, *bl_own)

    # gauge priors and padding regularization (local rows: the owner adds)
    eye_p = torch.eye(hpp_diag.shape[-1], dtype=hpp_diag.dtype,
                      device=hpp_diag.device)
    eye_l = torch.eye(hll.shape[-1], dtype=hll.dtype, device=hll.device)
    pose_reg = cfg.fixed_prior * g.pose_fixed + (1.0 - g.pose_mask)
    lm_reg = cfg.fixed_prior * g.lm_fixed + (1.0 - g.lm_mask)
    hpp_diag = hpp_diag + pose_reg[:, None, None] * eye_p
    hll = hll + lm_reg[:, None, None] * eye_l
    bp = bp * (1.0 - g.pose_fixed)[:, None]
    bl = bl * (1.0 - g.lm_fixed)[:, None]
    return _LocalSystem(hpp_diag=hpp_diag, hpp_off=hpp_off, hll=hll,
                        hpl=lb.w_hpl, bp=bp, bl=bl, err=err)


def _lm_leg_u(sys: _LocalSystem, pl: PartitionPlan, x, x_bnd, mb, group,
              extra=None):
    """``u = Hlp x``, complete at each landmark's owner ``[Mb, dl]``.
    ``extra``, where given, is summed in the same all-reduce.  Returns
    ``(u, extra summed)``."""
    x_ext = torch.cat([x, x_bnd], dim=0)
    u_acc = _segment_sum(bm.mtv(sys.hpl, x_ext[pl.lm_p_loc]), pl.lm_ext,
                         mb + pl.n_bl)
    if extra is None:
        u_tail, extra_sum = all_reduce(group, u_acc[mb:])[0], None
    else:
        u_tail, extra_sum = all_reduce(group, u_acc[mb:], extra)
    u = u_acc[:mb] + _pickup(u_tail, pl.own_bl_slot, pl.own_bl_row,
                             pl.own_bl_mask, mb)
    return u, extra_sum


def _partitioned_matvec(sys: _LocalSystem, hll_inv, pl: PartitionPlan,
                        nb, mb, group):
    """The damped Schur operator ``S @ x`` on the rank's ``x [Nb, dp]``.

    3 boundary-sized all-reduces per call: x publication, the u tail and
    the odometry row-j tail together, v publication."""

    def matvec(x):
        x_bnd = _publish(x, pl.own_bp_slot, pl.own_bp_row, pl.own_bp_mask,
                         pl.n_bp, group)
        x_ext = torch.cat([x, x_bnd], dim=0)
        # odometry off-diagonal: row i local, row j through the registry
        yj_acc = _segment_sum(bm.mtv(sys.hpp_off, x[pl.odom_i_loc]),
                              pl.odom_j_ext, nb + pl.n_bp)
        u, yj_tail = _lm_leg_u(sys, pl, x, x_bnd, mb, group,
                               extra=yj_acc[nb:])
        v = bm.mv(hll_inv, u)
        v_bnd = _publish(v, pl.own_bl_slot, pl.own_bl_row, pl.own_bl_mask,
                         pl.n_bl, group)
        v_ext = torch.cat([v, v_bnd], dim=0)
        w = _segment_sum(bm.mv(sys.hpl, v_ext[pl.lm_ext]), pl.lm_p_loc, nb)
        y = _segment_sum(bm.mv(sys.hpp_off, x_ext[pl.odom_j_ext]),
                         pl.odom_i_loc, nb)
        y = y + yj_acc[:nb] + _pickup(yj_tail, pl.own_bp_slot,
                                      pl.own_bp_row, pl.own_bp_mask, nb)
        return bm.mv(sys.hpp_diag, x) + y - w

    return matvec


def _s_diag_local(sys: _LocalSystem, hll_inv_ext, pl: PartitionPlan, nb):
    """Exact diagonal blocks of S for the owned poses (every landmark edge
    of a pose is local by construction)."""
    contrib = bm.mm(bm.mm(sys.hpl, hll_inv_ext[pl.lm_ext]),
                    sys.hpl.transpose(-1, -2))
    return sys.hpp_diag - _segment_sum(contrib, pl.lm_p_loc, nb)


def _eq_inv_dense(mat: torch.Tensor) -> torch.Tensor:
    """Jacobi-equilibrated dense inverse (batched over leading dims): the
    1e6 gauge prior otherwise costs the f32 inverse its digits."""
    s = torch.rsqrt(torch.clamp(torch.diagonal(mat, dim1=-2, dim2=-1),
                                min=1e-30))
    scale = s[..., :, None] * s[..., None, :]
    return torch.linalg.inv(mat * scale) * scale


def _planes_times_chol(planes, el, dp, dl, cols):
    """``V = U chol``: for each (row component a, column component b2),
    ``sum_b planes[a*dl + b][:, :cols] * el[:, b, b2]``, laid out
    ``[dp*rows, dl*cols]`` (component-major)."""
    return torch.cat([
        torch.cat([
            sum(planes[a * dl + b][:, :cols] * el[:, b, b2][None, :]
                for b in range(dl))
            for b2 in range(dl)
        ], dim=1)
        for a in range(dp)
    ], dim=0)


def _coarse_build_partitioned(
    sys: _LocalSystem, hll_inv, hll_inv_bnd, pl: PartitionPlan,
    nb, mb, coarse_group, group2, n_dev, rank, group,
):
    """The three-level sharded Galerkin coarse hierarchy.

    Each rank assembles only its row block ``S_c[mine, :]`` of the coarse
    system, and the correction splits into level 2, batched dense inverses
    of the super-group diagonal blocks of S_c (``group2`` coarse groups per
    super-group; its apply needs no communication), and level 3, the
    Galerkin re-aggregation over super-groups, the ``[dp*Nc2, dp*Nc2]``
    system that is the only replicated object, fed by one ``[Nc2, dp]``
    all-reduce per apply.

    Row-block assembly: odometry (group-i row) terms and the transpose terms
    of locally owned group-j land in the local rows; the cross-rank
    transpose terms ride an ``[Nc, Nc]`` grid summed across the ranks.
    Landmark fill: interior landmarks (every observer local) contribute
    ``V_int V_int^T`` locally; the boundary-landmark U columns, the owner's
    own observations included, are completed by one all-reduce (the same
    one as the grid), and each rank takes its row slice of the exact
    ``V_bnd V_bnd^T``.

    Returns ``(dinv [nc2b, g2*dp, g2*dp], c3inv [dp*Nc2, dp*Nc2])``,
    component-major (row = a*width + position) throughout, as
    ``schur.build_coarse_precond``."""
    dp = sys.hpp_diag.shape[-1]
    dl = hll_inv.shape[-1]
    dev = sys.hpp_diag.device
    ncb = nb // coarse_group
    nc = ncb * n_dev
    # largest divisor of ncb not above group2: any ncb works with no
    # coordination between the ranks
    g2 = next(g for g in range(min(group2, ncb), 0, -1) if ncb % g == 0)
    nc2b = ncb // g2
    nc2 = nc2b * n_dev
    row0 = rank * ncb

    gid_local = torch.arange(nb, device=dev) // coarse_group
    g_glob = row0 + gid_local

    # --- R^T Hpp R rows (block layout [ncb*nc, dp, dp]) ------------------
    gi_l = pl.odom_gi - row0          # the i-side pose is always owned
    rows = _segment_sum(sys.hpp_diag, gid_local * nc + g_glob, ncb * nc)
    rows = rows + _segment_sum(sys.hpp_off, gi_l * nc + pl.odom_gj,
                               ncb * nc)
    off_t = sys.hpp_off.transpose(-1, -2)
    j_owned = (pl.odom_gj >= row0) & (pl.odom_gj < row0 + ncb)
    rows = rows + _segment_sum(
        off_t * j_owned[:, None, None].to(off_t.dtype),
        torch.where(j_owned, pl.odom_gj - row0, 0) * nc + pl.odom_gi,
        ncb * nc)
    # cross edges: the (group j row, group i column) transpose block belongs
    # to a remote row, delivered through the grid (zero but at the few
    # cross pairs; padded edges carry zero blocks)
    cross_grid = _segment_sum(
        off_t * (~j_owned)[:, None, None].to(off_t.dtype),
        pl.odom_gj * nc + pl.odom_gi, nc * nc)

    # --- landmark U planes over the local columns [mb + Bl] --------------
    vals = sys.hpl.reshape(-1, dp * dl)
    gp_l = pl.lm_gp - row0            # the observing pose is always owned
    ids = gp_l * (mb + pl.n_bl) + pl.lm_ext
    planes = [
        _segment_sum(vals[:, k], ids, ncb * (mb + pl.n_bl)).reshape(
            ncb, mb + pl.n_bl)
        for k in range(dp * dl)
    ]
    # boundary columns with global rows: the local rows placed at row0, plus
    # the owner's own-column contributions on their registry slots, so that
    # the summed column is complete
    bnd_local = torch.stack([p[:, mb:] for p in planes])   # [dp*dl,ncb,Bl]
    own_cols = torch.stack([
        _segment_sum(_masked(p[:, pl.own_bl_row].T, pl.own_bl_mask),
                     pl.own_bl_slot, pl.n_bl).T
        for p in planes
    ])                                                     # [dp*dl,ncb,Bl]
    bnd_embed = bnd_local.new_zeros((dp * dl, nc, pl.n_bl))
    bnd_embed[:, row0:row0 + ncb] = bnd_local + own_cols
    cross_grid, bnd_planes = all_reduce(group, cross_grid, bnd_embed)

    # --- fill terms --------------------------------------------------------
    el_own = schur._chol_small(hll_inv)                    # [mb, dl, dl]
    w_int = pl.lm_interior_mask[None, :].to(vals.dtype)
    vf_int = _planes_times_chol([p[:, :mb] * w_int for p in planes], el_own,
                                dp, dl, mb)                # [dp*ncb, dl*mb]
    el_bnd = schur._chol_small(hll_inv_bnd)                # [Bl, dl, dl]
    vf_bnd_all = _planes_times_chol(list(bnd_planes), el_bnd, dp, dl,
                                    pl.n_bl)               # [dp*nc, dl*Bl]
    vf_bnd_mine = vf_bnd_all.reshape(dp, nc, -1)[:, row0:row0 + ncb].reshape(
        dp * ncb, -1)
    with schur._full_f32_matmul():
        fill_int = vf_int @ vf_int.T
        fill_bnd = vf_bnd_mine @ vf_bnd_all.T

    # --- the component-major row block [dp, ncb, dp, nc] -------------------
    rows4 = rows.reshape(ncb, nc, dp, dp).permute(2, 0, 3, 1)
    cross_mine = cross_grid.reshape(nc, nc, dp, dp)[row0:row0 + ncb].permute(
        2, 0, 3, 1)
    rows4 = rows4 + cross_mine - fill_bnd.reshape(dp, ncb, dp, nc)
    rows4[:, :, :, row0:row0 + ncb] -= fill_int.reshape(dp, ncb, dp, ncb)

    # --- level 2: super-group diagonal blocks, batched inverse -------------
    diag4 = rows4[:, :, :, row0:row0 + ncb]
    d6 = diag4.reshape(dp, nc2b, g2, dp, nc2b, g2)
    blocks = torch.diagonal(d6, dim1=1, dim2=4)           # [dp,g2,dp,g2,nc2b]
    blocks = blocks.permute(4, 0, 1, 2, 3).reshape(nc2b, dp * g2, dp * g2)
    blocks = blocks + torch.diag_embed(
        1e-4 * torch.diagonal(blocks, dim1=-2, dim2=-1))
    dinv = _eq_inv_dense(blocks)

    # --- level 3: super-group Galerkin, replicated but tiny ----------------
    r3 = rows4.reshape(dp, nc2b, g2, dp, nc).sum(2)
    r3 = r3.reshape(dp, nc2b, dp, nc2, g2).sum(4)         # [dp,nc2b,dp,nc2]
    c3 = r3.new_zeros((dp, nc2, dp, nc2))
    c3[:, rank * nc2b:(rank + 1) * nc2b] = r3
    c3 = all_reduce(group, c3)[0].reshape(dp * nc2, dp * nc2)
    c3 = c3 + torch.diag(1e-4 * torch.diagonal(c3))
    return dinv, _eq_inv_dense(c3)


def _coarse_apply_partitioned(pre, coarse_group, r, nb, n_dev, rank, group):
    """The 3-level coarse correction on the rank's residual ``r [Nb, dp]``:
    level 2 a batched block matvec on the owned super-groups (no
    communication), level 3 one all-reduce of the tiny ``[Nc2, dp]``
    coarse residual and the replicated ``[dp*Nc2]`` explicit inverse."""
    dinv, c3inv = pre
    dp = r.shape[-1]
    ncb = nb // coarse_group
    g2 = dinv.shape[-1] // dp
    nc2b = ncb // g2
    nc2 = nc2b * n_dev

    rc = r.reshape(ncb, coarse_group, dp).sum(1)           # [ncb, dp]
    # level 2: component-major within a super-group (row = a*g2 + t)
    rc2 = rc.reshape(nc2b, g2, dp).permute(0, 2, 1).reshape(nc2b, dp * g2)
    with schur._full_f32_matmul():
        z2 = torch.einsum("bij,bj->bi", dinv, rc2)
    z2 = z2.reshape(nc2b, dp, g2).permute(0, 2, 1).reshape(ncb, dp)

    # level 3
    rc3 = rc.new_zeros((nc2, dp))
    rc3[rank * nc2b:(rank + 1) * nc2b] = rc.reshape(nc2b, g2, dp).sum(1)
    rc3 = all_reduce(group, rc3)[0]
    with schur._full_f32_matmul():
        zc3 = c3inv @ rc3.T.reshape(-1)
    z3 = zc3.reshape(dp, nc2).T[rank * nc2b:(rank + 1) * nc2b]
    z3_fine = z3[:, None, :].expand(nc2b, g2, dp).reshape(ncb, dp)

    zc = z2 + z3_fine                                      # [ncb, dp]
    return zc[:, None, :].expand(ncb, coarse_group, dp).reshape(nb, dp)


def _build_local_precond(cfg, sys, s_diag, pl, nb):
    """The preconditioner on the rank's own block (the chain couplings
    across ranks are dropped: the coarse level owns the global modes)."""
    kind, _, _ = cfg.pcg_precond.partition("+")
    if kind in ("tridiag", "chunk"):
        upper = _segment_sum(
            _masked(sys.hpp_off, pl.odom_chain_mask), pl.odom_i_loc, nb)
        if kind == "tridiag":
            return schur.build_tridiag_precond(s_diag, upper)
        return schur.build_chunk_precond(s_diag, upper, cfg.pcg_chunk)
    return schur.inv_blocks(s_diag)


def _local_precond_apply(cfg, local):
    kind, _, _ = cfg.pcg_precond.partition("+")
    if kind == "tridiag":
        return lambda r: schur.tridiag_apply(local, r)
    if kind == "chunk":
        return lambda r: schur.chunk_apply(local, r)
    return lambda r: bm.mv(local, r)


def _solve_local(g, lam, cfg: OptimizerConfig, mesh: Mesh):
    """The rank's linearize-solve on its partition block ``g``: the body of
    the JAX package's ``shard_map``."""
    group, n_dev, rank = mesh.group, mesh.size, mesh.rank
    pl: PartitionPlan = g.plan
    nb = g.poses.shape[0]
    mb = g.landmarks.shape[0]
    bl_own = (pl.own_bl_slot, pl.own_bl_row, pl.own_bl_mask, pl.n_bl)

    # the boundary states, once per linearization
    pose_bnd, lm_bnd = _publish_states(g, group)
    sys = _assemble_local(g, cfg, group, pose_bnd, lm_bnd)
    d = schur.damp(sys, lam)
    hll_inv = schur.inv_blocks(d.hll)
    # the boundary hll_inv (for s_diag and the back-substitution) and the
    # v-leg of the right-hand side, published in one all-reduce
    v0 = bm.mv(hll_inv, d.bl)
    hll_inv_bnd, v0_bnd = all_reduce(
        group, _publish_buf(hll_inv, *bl_own), _publish_buf(v0, *bl_own))
    hll_inv_ext = torch.cat([hll_inv, hll_inv_bnd], dim=0)
    v0_ext = torch.cat([v0, v0_bnd], dim=0)
    # rhs = -bp + Hpl Hll^-1 bl
    rhs = -d.bp + _segment_sum(bm.mv(d.hpl, v0_ext[pl.lm_ext]), pl.lm_p_loc,
                               nb)

    matvec = _partitioned_matvec(d, hll_inv, pl, nb, mb, group)
    s_diag = _s_diag_local(d, hll_inv_ext, pl, nb)
    local_apply = _local_precond_apply(
        cfg, _build_local_precond(cfg, d, s_diag, pl, nb))
    if cfg.pcg_precond.endswith("+coarse"):
        pre_c = _coarse_build_partitioned(
            d, hll_inv, hll_inv_bnd, pl, nb, mb, cfg.pcg_coarse_group,
            cfg.pcg_coarse_group2, n_dev, rank, group)

        def precond_apply(r):
            return local_apply(r) + _coarse_apply_partitioned(
                pre_c, cfg.pcg_coarse_group, r, nb, n_dev, rank, group)
    else:
        precond_apply = local_apply

    res = schur.pcg(matvec, precond_apply, rhs, cfg.pcg_tol,
                    cfg.pcg_max_iters, cfg.pcg_restart_every,
                    cfg.pcg_unroll, group=group, dot_group=group)
    dx_p = res.x
    # back-substitution: dx_l = Hll^-1 (-bl - Hlp dx_p)
    x_bnd = _publish(dx_p, pl.own_bp_slot, pl.own_bp_row, pl.own_bp_mask,
                     pl.n_bp, group)
    u, _ = _lm_leg_u(d, pl, dx_p, x_bnd, mb, group)
    dx_l = bm.mv(hll_inv, -d.bl - u)
    return dx_p, dx_l, sys.err, SolveStats(pcg_iters=res.iterations,
                                           pcg_residual=res.residual_norm)


def _error_local(g, cfg: OptimizerConfig, group):
    """The robust chi^2 of the state on the rank's block, summed over the
    ranks: the boundary states published, the rank's edges evaluated on
    the extended state, one all-reduce (the ``error_fn`` of the
    Levenberg-Marquardt step rejection)."""
    pose_bnd, lm_bnd = _publish_states(g, group)
    e = _ext_graph(g, torch.cat([g.poses, pose_bnd], dim=0),
                   torch.cat([g.landmarks, lm_bnd], dim=0))
    if _is_3d(g):
        from toyslam_torch.ops.schur3d import total_error_3d as total
    else:
        from toyslam_torch.ops.assemble import total_error as total
    err = total(e, cfg.huber_delta,
                exact_odom_jacobians=cfg.exact_odom_jacobians)
    return all_reduce(group, err)[0]


def partitioned_linearize_solve(cfg: OptimizerConfig, mesh: Mesh):
    """A linearize-solve over keyframe/map-block partitioned state.

    Plugs into ``GaussNewton(config, solve=...)``: ``prepare(graph)`` runs
    the host-side partition build (once per structure) and gives this rank
    its block on ``mesh.device``; ``solve`` is the rank's linearize, Schur
    and PCG, whose state never leaves its owner.  After ``prepare``,
    ``solve.meta`` holds the :class:`PartitionMeta`.  The loop sees only
    the rank's block, so the solve also gives ``GaussNewton`` the chi^2 of
    a state (``error_fn``) and a sum over the ranks (``global_sum``, for
    the step norm); :func:`gather_result` assembles the whole result."""
    align = max(cfg.pcg_chunk, cfg.pcg_coarse_group)

    def prepare(graph):
        if isinstance(graph.plan, PartitionPlan):
            return graph
        pgraph, meta = build_partition(graph, mesh.size, align=align,
                                       coarse_group=cfg.pcg_coarse_group)
        solve.meta = meta
        return partition_shard(pgraph, meta, mesh.rank).to(mesh.device)

    def solve(graph, lam):
        return _solve_local(prepare(graph), lam, cfg, mesh)

    solve.prepare = prepare
    solve.meta = None
    solve.error_fn = functools.partial(_error_local, cfg=cfg,
                                       group=mesh.group)
    solve.global_sum = functools.partial(all_reduce, mesh.group)
    return solve


def gather_result(result, meta: PartitionMeta, mesh: Mesh):
    """The whole optimized state from every rank's block: the pose blocks
    gathered in rank order ``[D*Nb, dp]`` (the padded pose order of the
    input graph) and the landmarks in their original order ``[M, dl]``,
    on every rank."""
    g = result.graph
    poses = all_gather(mesh.group, g.poses)
    lms = all_gather(mesh.group, g.landmarks)
    poses = poses.reshape((-1,) + tuple(g.poses.shape[1:]))
    lms = lms.reshape((-1,) + tuple(g.landmarks.shape[1:]))
    landmarks = meta.unpermute_landmarks(lms.cpu().numpy(),
                                         meta.new_of_old_lm.shape[0])
    return poses, torch.as_tensor(landmarks, device=lms.device)
