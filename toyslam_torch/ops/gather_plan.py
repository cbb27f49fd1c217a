"""Per-vertex incident-edge tables: every per-vertex sum as gather + dense
reduce.

For each vertex the (padded, fixed-capacity) list of incident edge indices
is built once per graph structure on the host; a per-vertex reduction is
then

    out[v] = sum_k values[ table[v, k] ] * mask[v, k]

On the GPU this sums in a fixed order, so every run gives the same bits and
the order matches the JAX package's tables; ``index_add_`` on CUDA tensors
is neither.  ``index_add_`` appears only where the reference itself uses
``segment_sum`` (``schur.chain_upper`` and ``fused_pcg._closure_columns``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from toyslam_torch.models.graph import FactorGraph2D, TensorTree


@dataclasses.dataclass(frozen=True)
class VertexTable(TensorTree):
    """Edges incident to each of V vertices, padded to capacity K."""

    idx: torch.Tensor    # int64[V, K] edge index (0 where padded)
    mask: torch.Tensor   # f32[V, K] 1.0 = real entry


@dataclasses.dataclass(frozen=True)
class FusedAux(TensorTree):
    """The non-chain odometry edges (j != i+1, loop closures), whose
    off-diagonal Hessian blocks fold into the fused operator's dense
    low-rank factor instead of its block-tridiagonal part."""

    closure_e: torch.Tensor   # int64[C] odometry edge index
    closure_i: torch.Tensor   # int64[C] first pose of that edge
    closure_j: torch.Tensor   # int64[C] second pose


@dataclasses.dataclass(frozen=True)
class GatherPlan(TensorTree):
    lm_by_pose: VertexTable   # landmark edges grouped by observing pose
    lm_by_lm: VertexTable     # landmark edges grouped by landmark
    odom_by_i: VertexTable    # odometry edges grouped by first pose
    odom_by_j: VertexTable    # odometry edges grouped by second pose
    fused: FusedAux | None = None


def _build_table(
    vertex_ids: np.ndarray, mask: np.ndarray, num_vertices: int,
    device="cpu",
) -> VertexTable:
    ids = vertex_ids[mask > 0]
    edge_idx = np.nonzero(mask > 0)[0]
    counts = np.bincount(ids, minlength=num_vertices)
    k = max(int(counts.max()) if counts.size else 0, 1)
    tbl = np.zeros((num_vertices, k), np.int64)
    msk = np.zeros((num_vertices, k), np.float32)
    # edges sorted by vertex id keep their relative order; slot = rank
    # within the vertex's run
    order = np.argsort(ids, kind="stable")
    sorted_ids = ids[order]
    sorted_edges = edge_idx[order]
    starts = np.searchsorted(sorted_ids, np.arange(num_vertices))
    slots = np.arange(sorted_ids.shape[0]) - starts[sorted_ids]
    tbl[sorted_ids, slots] = sorted_edges
    msk[sorted_ids, slots] = 1.0
    return VertexTable(
        idx=torch.as_tensor(tbl, device=device),
        mask=torch.as_tensor(msk, device=device),
    )


def build_gather_plan(graph: FactorGraph2D) -> GatherPlan:
    """Host-side construction from the graph's index arrays (one copy to the
    host per graph structure); the tables land on the graph's device."""
    n, m = graph.num_poses, graph.num_landmarks
    dev = graph.device

    def host(t):
        return t.detach().cpu().numpy()

    lm_pose = host(graph.lm_edges.pose)
    lm_lm = host(graph.lm_edges.lm)
    lm_mask = host(graph.lm_edges.mask)
    od_i = host(graph.odom.i)
    od_j = host(graph.odom.j)
    od_mask = host(graph.odom.mask)
    closure = np.nonzero((od_mask > 0) & (od_j != od_i + 1))[0]
    return GatherPlan(
        lm_by_pose=_build_table(lm_pose, lm_mask, n, dev),
        lm_by_lm=_build_table(lm_lm, lm_mask, m, dev),
        odom_by_i=_build_table(od_i, od_mask, n, dev),
        odom_by_j=_build_table(od_j, od_mask, n, dev),
        fused=FusedAux(
            closure_e=torch.as_tensor(closure, dtype=torch.int64,
                                      device=dev),
            closure_i=torch.as_tensor(od_i[closure], dtype=torch.int64,
                                      device=dev),
            closure_j=torch.as_tensor(od_j[closure], dtype=torch.int64,
                                      device=dev),
        ),
    )


def attach_plan(graph: FactorGraph2D) -> FactorGraph2D:
    """Graph with gather tables attached (host-side, once per structure)."""
    return dataclasses.replace(graph, plan=build_gather_plan(graph))


def table_sum(values: torch.Tensor, table: VertexTable) -> torch.Tensor:
    """``out[v] = sum over incident edges of values[e]``: ``values``
    f32[E, ...] per-edge quantities -> f32[V, ...]."""
    gathered = values[table.idx]                       # [V, K, ...]
    mask = table.mask.reshape(
        table.mask.shape + (1,) * (gathered.dim() - 2)
    )
    return (gathered * mask).sum(1)
