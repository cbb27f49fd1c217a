"""Graph state across packages.

A SLAM system has no weights: the state both sides must share is the graph
(poses, landmarks, edges and, once attached, the gather tables).
:func:`graph_from_arrays` reads any object with the ``FactorGraph2D``
attribute protocol — numpy arrays, device arrays of another framework, or
this package's own tensors — through ``np.asarray`` and returns this
package's graph.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from toyslam_torch.models.graph import FactorGraph2D, graph_from_numpy
from toyslam_torch.ops import gather_plan as gp


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _table(t, device) -> gp.VertexTable:
    return gp.VertexTable(
        idx=torch.as_tensor(_np(t.idx).astype(np.int64), device=device),
        mask=torch.as_tensor(_np(t.mask).astype(np.float32), device=device),
    )


def plan_from_arrays(plan, device="cpu") -> gp.GatherPlan:
    """The gather tables and the loop-closure aux of ``plan``; any band
    layout of the source is not carried (the band kernel is not ported)."""
    fused = getattr(plan, "fused", None)
    if fused is not None:
        fused = gp.FusedAux(*(
            torch.as_tensor(_np(a).astype(np.int64), device=device)
            for a in (fused.closure_e, fused.closure_i, fused.closure_j)
        ))
    return gp.GatherPlan(
        lm_by_pose=_table(plan.lm_by_pose, device),
        lm_by_lm=_table(plan.lm_by_lm, device),
        odom_by_i=_table(plan.odom_by_i, device),
        odom_by_j=_table(plan.odom_by_j, device),
        fused=fused,
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
