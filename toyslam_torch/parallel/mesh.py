"""Process groups and edge sharding: the port of
``toyslam_tpu.parallel.mesh``.

The JAX package shards global arrays over a device mesh inside one
program.  Here the design is SPMD on ``torch.distributed``: one process per
rank, each holding only its own shard, and every cross-rank sum an
``all_reduce`` on the rank's process group (``ops/collective.py``).

The rule for backend and device: rank r computes on
``cuda:{r % torch.cuda.device_count()}``, or on the CPU when the caller asks
for ``device="cpu"``; the backend is NCCL when every rank has a card of its
own and gloo otherwise (CPU ranks, or ranks that share a card: NCCL refuses
two ranks on one device).  Nothing here falls back to another device or
backend: a group that does not form is an error.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

from toyslam_torch.models.graph import FactorGraph2D

# how long a rank waits for the others in one collective before it fails
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=600)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the process group it computes in."""

    group: object            # torch.distributed ProcessGroup
    rank: int
    size: int
    device: torch.device
    backend: str             # "nccl" or "gloo"


def rank_device(rank: int, device: str = "cuda") -> torch.device:
    """The device rank ``rank`` computes on: ``cuda:{rank % count}``, or the
    CPU when ``device="cpu"``."""
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: ask for device='cpu' explicitly")
    return torch.device("cuda", rank % torch.cuda.device_count())


def backend_for(world_size: int, device: str = "cuda") -> str:
    """NCCL when every rank has a card of its own, gloo otherwise."""
    if torch.device(device).type == "cpu":
        return "gloo"
    return "nccl" if world_size <= torch.cuda.device_count() else "gloo"


def initialize_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    init_method: str | None = None,
    device: str = "cuda",
) -> bool:
    """Join (or skip) the process group of a multi-process run.

    The values default from the environment (``TOYSLAM_COORDINATOR`` as
    ``host:port``, ``TOYSLAM_NUM_PROCESSES``, ``TOYSLAM_PROCESS_ID``), as in
    the JAX package; ``init_method`` (for example a ``file://`` store) takes
    the coordinator's place.  With neither, this is single-process mode and
    returns False.  The backend follows :func:`backend_for`."""
    coordinator = coordinator or os.environ.get("TOYSLAM_COORDINATOR")
    if init_method is None:
        if not coordinator:
            return False
        init_method = f"tcp://{coordinator}"
    if num_processes is None:
        num_processes = int(os.environ.get("TOYSLAM_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("TOYSLAM_PROCESS_ID", "0"))
    dev = rank_device(process_id, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend_for(num_processes, device), init_method=init_method,
        world_size=num_processes, rank=process_id,
        timeout=COLLECTIVE_TIMEOUT,
    )
    return True


def make_mesh(num_devices: int | None = None,
              device: str = "cuda") -> Mesh:
    """This rank's :class:`Mesh` over the whole process group (the default
    group, which :func:`initialize_distributed` formed).  ``num_devices``,
    where given, must be the group's size: a rank computes on one device."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_distributed "
                           "first")
    size = dist.get_world_size()
    if num_devices is not None and num_devices != size:
        raise ValueError(f"num_devices={num_devices}: the group has {size} "
                         "ranks, one device each")
    rank = dist.get_rank()
    return Mesh(group=dist.group.WORLD, rank=rank, size=size,
                device=rank_device(rank, device),
                backend=dist.get_backend())


def make_host_mesh(device: str = "cuda") -> Mesh:
    """:func:`make_mesh` over every process of the run."""
    return make_mesh(None, device)


def _edge_fields(graph) -> dict[str, tuple[str, ...]]:
    from toyslam_torch.parallel.distributed import (
        graph3d_shard_specs,
        graph_shard_specs,
    )

    return (graph3d_shard_specs() if hasattr(graph, "intrinsics")
            else graph_shard_specs())


def _pad_axis0(x: torch.Tensor, target: int) -> torch.Tensor:
    pad = target - x.shape[0]
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((pad,) + x.shape[1:])], dim=0)


def pad_edges_for_mesh(graph: FactorGraph2D, num_devices: int):
    """Pad the edge arrays (mask 0, index 0: inert everywhere) to a multiple
    of ``num_devices`` so that they split evenly."""

    def round_up(n):
        return -(-n // num_devices) * num_devices

    changes = {}
    for name, fields in _edge_fields(graph).items():
        edges = getattr(graph, name)
        target = round_up(edges.count)
        changes[name] = dataclasses.replace(edges, **{
            f: _pad_axis0(getattr(edges, f), target) for f in fields})
    return dataclasses.replace(graph, **changes)


def shard_graph(graph: FactorGraph2D, mesh: Mesh):
    """This rank's shard of a host graph, on ``mesh.device``: the states
    and masks whole (replicated), the edge arrays padded to the mesh and cut
    to the rank's contiguous chunk, and the rank's per-shard gather tables
    (``gather_plan.build_sharded_plan``, local edge indices).

    Every rank must hold the same host graph (a deterministic build from
    one seed).  There are no global arrays: each rank slices its own shard
    and moves only that to its device."""
    from toyslam_torch.ops.gather_plan import GatherPlan, VertexTable
    from toyslam_torch.ops.gather_plan import build_sharded_plan

    graph = pad_edges_for_mesh(
        dataclasses.replace(graph.to("cpu"), plan=None), mesh.size)
    plan = build_sharded_plan(graph, mesh.size)
    r = mesh.rank
    changes = {}
    for name, fields in _edge_fields(graph).items():
        edges = getattr(graph, name)
        chunk = edges.count // mesh.size
        changes[name] = dataclasses.replace(edges, **{
            f: getattr(edges, f)[r * chunk:(r + 1) * chunk] for f in fields})
    local_plan = GatherPlan(**{
        f: VertexTable(idx=getattr(plan, f).idx[r],
                       mask=getattr(plan, f).mask[r])
        for f in ("lm_by_pose", "lm_by_lm", "odom_by_i", "odom_by_j")})
    return dataclasses.replace(graph, plan=local_plan, **changes).to(
        mesh.device)


def is_shard(graph) -> bool:
    """Whether ``graph`` is a rank's shard from :func:`shard_graph`: its
    plan holds per-shard tables, which carry no loop-closure aux (every
    single-device plan does)."""
    plan = getattr(graph, "plan", None)
    return (plan is not None and hasattr(plan, "lm_by_pose")
            and plan.fused is None)

