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

# pose count from which the band layout is searched, by landmark width:
# SE(2) (dl=2) from 2048 poses; BA (dl=3), whose resident V slabs are 3x
# larger per (pose, landmark), from 192
BAND_THRESHOLD = {2: 2048, 3: 192}


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
    # ops.band_plan.BandAux on large graphs with run-local observations:
    # opens the streamed band kernel (fused_pcg.fused_mode "band")
    band: object = None


def _build_table(
    vertex_ids: np.ndarray, mask: np.ndarray, num_vertices: int,
    device="cpu", k_override: int | None = None,
) -> VertexTable:
    ids = vertex_ids[mask > 0]
    edge_idx = np.nonzero(mask > 0)[0]
    counts = np.bincount(ids, minlength=num_vertices)
    k = max(int(counts.max()) if counts.size else 0, 1)
    if k_override is not None:
        if k_override < k:
            raise ValueError(f"k_override {k_override} < capacity {k}")
        k = k_override
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


def build_gather_plan(
    graph: FactorGraph2D, want_band: bool | None = None
) -> GatherPlan:
    """Host-side construction from the graph's index arrays (one copy to the
    host per graph structure); the tables land on the graph's device.

    From ``BAND_THRESHOLD`` poses on, the band layout search
    (``ops.band_plan.build_band_aux``, seconds of host time at 10k) runs
    too, unless ``want_band`` is False."""
    n, m = graph.num_poses, graph.num_landmarks
    dev = graph.device
    # block geometry off the state arrays: (3, 2) = SE(2), (6, 3) = BA
    dl = int(graph.landmarks.shape[-1])
    dp = 3 if dl == 2 else 6
    band = None
    if n >= BAND_THRESHOLD[dl] and want_band is not False:
        from toyslam_torch.ops.band_plan import build_band_aux

        band = build_band_aux(graph, dp=dp, dl=dl)

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
        band=band,
    )


def attach_plan(
    graph: FactorGraph2D, want_band: bool | None = None
) -> FactorGraph2D:
    """Graph with gather tables attached (host-side, once per structure)."""
    return dataclasses.replace(
        graph, plan=build_gather_plan(graph, want_band=want_band))


def _build_sharded_table(
    vertex_ids: np.ndarray, mask: np.ndarray, num_vertices: int, n_dev: int
) -> VertexTable:
    """Per-shard tables stacked on a leading rank axis ``[D, V, K]``: the
    edges split into ``n_dev`` contiguous chunks, and shard ``d``'s table
    lists the *local* indices of its chunk's edges per vertex.  ``K`` is
    the largest incident count over all shards, so the stack is
    rectangular.  Host-side, on CPU tensors."""
    e = vertex_ids.shape[0]
    if e % n_dev:
        raise ValueError(f"{e} edges do not split into {n_dev} shards "
                         "(pad_edges_for_mesh first)")
    chunk = e // n_dev
    shards = [slice(d * chunk, (d + 1) * chunk) for d in range(n_dev)]
    k = 1
    for sl in shards:
        ids = vertex_ids[sl][mask[sl] > 0]
        if ids.size:
            k = max(k, int(np.bincount(ids, minlength=num_vertices).max()))
    tables = [_build_table(vertex_ids[sl], mask[sl], num_vertices,
                           k_override=k) for sl in shards]
    return VertexTable(idx=torch.stack([t.idx for t in tables]),
                       mask=torch.stack([t.mask for t in tables]))


def build_sharded_plan(graph: FactorGraph2D, n_dev: int) -> GatherPlan:
    """The gather plan of an edge-sharded graph (edge count a multiple of
    ``n_dev``): every table carries a leading rank axis ``[D, V, K]``, and
    rank ``d`` takes its own ``[V, K]`` tables with its chunk of the edges
    (``parallel.mesh.shard_graph``).  No loop-closure aux and no band
    layout: under a process group the gate declines the kernels."""
    n, m = graph.num_poses, graph.num_landmarks

    def host(t):
        return t.detach().cpu().numpy()

    lm_mask, od_mask = host(graph.lm_edges.mask), host(graph.odom.mask)
    return GatherPlan(
        lm_by_pose=_build_sharded_table(host(graph.lm_edges.pose), lm_mask,
                                        n, n_dev),
        lm_by_lm=_build_sharded_table(host(graph.lm_edges.lm), lm_mask, m,
                                      n_dev),
        odom_by_i=_build_sharded_table(host(graph.odom.i), od_mask, n, n_dev),
        odom_by_j=_build_sharded_table(host(graph.odom.j), od_mask, n, n_dev),
    )


def table_sum(values: torch.Tensor, table: VertexTable) -> torch.Tensor:
    """``out[v] = sum over incident edges of values[e]``: ``values``
    f32[E, ...] per-edge quantities -> f32[V, ...]."""
    gathered = values[table.idx]                       # [V, K, ...]
    mask = table.mask.reshape(
        table.mask.shape + (1,) * (gathered.dim() - 2)
    )
    return (gathered * mask).sum(1)
