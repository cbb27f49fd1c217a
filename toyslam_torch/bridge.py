"""Graph state across packages.

A SLAM system has no weights: the state both sides must share is the graph
(poses, landmarks, edges and, once attached, the gather tables and the band
layout).  :func:`graph_from_arrays` reads any object with the
``FactorGraph2D`` attribute protocol, and :func:`graph3d_from_arrays` any
with the ``FactorGraph3D`` one (numpy arrays, device arrays of another
framework, or this package's own tensors), through ``np.asarray``, and
return this package's graph.  :func:`partition_from_arrays` carries a
partitioned graph and its ``PartitionMeta`` (``build_partition``'s output)
across the same way, so that the port's partitioned solve can run on tables
that the JAX package built.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from toyslam_torch.models.graph import (
    FactorGraph2D,
    graph_from_numpy,
    to_numpy as _np,
)
from toyslam_torch.models.graph import LandmarkEdges, OdomEdges
from toyslam_torch.models.graph3d import (
    FactorGraph3D,
    Odom3DEdges,
    ReprojEdges,
    graph3d_from_numpy,
)
from toyslam_torch.ops import gather_plan as gp
from toyslam_torch.ops.band_plan import BandAux, band_aux_from_arrays


def _table(t, device) -> gp.VertexTable:
    return gp.VertexTable(
        idx=torch.as_tensor(_np(t.idx).astype(np.int64), device=device),
        mask=torch.as_tensor(_np(t.mask).astype(np.float32), device=device),
    )


def _band(band, n: int, device) -> BandAux:
    arrays = {f: _np(getattr(band, f)) for f in (
        "scatter_base", "band_mask", "win_off", "wide_idx", "wide_mask",
        "src_edges", "elem_ids", "wide_edges")}
    static = {f: int(getattr(band, f)) for f in (
        "chunk_b", "k_windows", "w_row", "n_chunks", "n_wide", "dp", "dl")}
    return band_aux_from_arrays(device, n=n, **arrays, **static)


def plan_from_arrays(plan, device="cpu") -> gp.GatherPlan:
    """The gather tables, the loop-closure aux and the band layout of
    ``plan`` (the layout's kernel cover table is derived here)."""
    fused = getattr(plan, "fused", None)
    if fused is not None:
        fused = gp.FusedAux(*(
            torch.as_tensor(_np(a).astype(np.int64), device=device)
            for a in (fused.closure_e, fused.closure_i, fused.closure_j)
        ))
    band = getattr(plan, "band", None)
    if band is not None:
        band = _band(band, plan.lm_by_pose.idx.shape[0], device)
    return gp.GatherPlan(
        lm_by_pose=_table(plan.lm_by_pose, device),
        lm_by_lm=_table(plan.lm_by_lm, device),
        odom_by_i=_table(plan.odom_by_i, device),
        odom_by_j=_table(plan.odom_by_j, device),
        fused=fused,
        band=band,
    )


def graph_from_arrays(g, device="cpu") -> FactorGraph2D:
    """This package's graph, on ``device``, from any ``FactorGraph2D``-like
    object; its ``plan``, if any, comes along."""
    o, l = g.odom, g.lm_edges
    graph = graph_from_numpy(
        _np(g.poses), _np(g.landmarks), _np(g.pose_mask), _np(g.lm_mask),
        _np(g.pose_fixed), _np(g.lm_fixed),
        tuple(_np(a) for a in (o.i, o.j, o.meas, o.info, o.mask)),
        tuple(_np(a) for a in (l.pose, l.lm, l.meas, l.info, l.mask)),
        device=device,
    )
    plan = getattr(g, "plan", None)
    if plan is not None:
        graph = dataclasses.replace(graph, plan=plan_from_arrays(plan, device))
    return graph


def graph3d_from_arrays(g, device="cpu") -> FactorGraph3D:
    """This package's SE(3) BA graph, on ``device``, from any
    ``FactorGraph3D``-like object; its ``plan``, if any, comes along (with
    a band layout, its ``(dp, dl) = (6, 3)`` geometry)."""
    o, l = g.odom, g.lm_edges
    graph = graph3d_from_numpy(
        _np(g.poses), _np(g.landmarks), _np(g.pose_mask), _np(g.lm_mask),
        _np(g.pose_fixed), _np(g.lm_fixed),
        tuple(_np(a) for a in (o.i, o.j, o.meas, o.info, o.mask)),
        tuple(_np(a) for a in (l.pose, l.lm, l.meas, l.info, l.mask)),
        _np(g.intrinsics), device=device,
    )
    plan = getattr(g, "plan", None)
    if plan is not None:
        graph = dataclasses.replace(graph, plan=plan_from_arrays(plan, device))
    return graph


def _tensor(a, device) -> torch.Tensor:
    """A tensor of ``a`` on ``device``: floats keep their width, integers
    become int64."""
    a = _np(a)
    if np.issubdtype(a.dtype, np.integer):
        a = a.astype(np.int64)
    return torch.as_tensor(a, device=device)


def partition_from_arrays(pgraph, meta, device="cpu"):
    """This package's partitioned graph (stacked ``[D, E, ...]`` edges and a
    ``parallel.partition.PartitionPlan``, 2D or SE(3)) and
    ``PartitionMeta`` from any objects with the attribute protocol of
    ``build_partition``'s output, float widths kept."""
    from toyslam_torch.parallel.partition import PartitionMeta, PartitionPlan

    pl = pgraph.plan
    plan = PartitionPlan(**{
        f.name: (int(getattr(pl, f.name)) if f.name in ("n_bp", "n_bl")
                 else _tensor(getattr(pl, f.name), device))
        for f in dataclasses.fields(PartitionPlan)})
    is3d = hasattr(pgraph, "intrinsics")
    odom_cls, lm_cls = ((Odom3DEdges, ReprojEdges) if is3d
                        else (OdomEdges, LandmarkEdges))
    o, l = pgraph.odom, pgraph.lm_edges
    fields = {f: _tensor(getattr(pgraph, f), device) for f in (
        "poses", "landmarks", "pose_mask", "lm_mask", "pose_fixed",
        "lm_fixed")}
    fields["odom"] = odom_cls(**{f: _tensor(getattr(o, f), device)
                                 for f in ("i", "j", "meas", "info", "mask")})
    fields["lm_edges"] = lm_cls(**{
        f: _tensor(getattr(l, f), device)
        for f in ("pose", "lm", "meas", "info", "mask")})
    if is3d:
        graph = FactorGraph3D(intrinsics=_tensor(pgraph.intrinsics, device),
                              plan=plan, **fields)
    else:
        graph = FactorGraph2D(plan=plan, **fields)
    return graph, PartitionMeta(**{
        k: (np.asarray(v) if isinstance(v, np.ndarray) else v)
        for k, v in meta._asdict().items()})
