"""Sums and gathers over a ``torch.distributed`` process group: the
counterpart of the JAX package's ``jax.lax.psum`` inside ``shard_map``.

Every collective of the sharded solves (``toyslam_torch/parallel/``) goes
through here.  A ``group`` of None means one process: no collective runs
and the tensors come back as they were given.  Where the JAX package psums a
tuple, :func:`all_reduce` concatenates the tuple into one flat buffer and
issues one collective, so the count of collectives is that of the JAX
design; ``all_reduce.calls`` counts them (set it to 0 to start a count).

Gloo and NCCL give every rank the same bits from an all-reduce, and every
host-side decision of the sharded solves (PCG's stop, Gauss-Newton's
acceptance and convergence) reads only values that came out of one, which
keeps the ranks in lockstep.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def all_reduce(group, *tensors: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The sum over the ranks of ``group`` of each tensor, in one
    collective.  The tensors share one dtype and one device; the inputs are
    left as they were."""
    if group is None:
        return tensors
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise ValueError(f"all_reduce of mixed dtypes {sorted(map(str, dtypes))}")
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    all_reduce.calls += 1
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].reshape(t.shape))
        off += t.numel()
    return tuple(out)


all_reduce.calls = 0


def all_gather(group, tensor: torch.Tensor) -> torch.Tensor:
    """Every rank's ``tensor`` (one shape on all ranks) stacked along a new
    leading axis in rank order."""
    parts = [torch.empty_like(tensor)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, tensor.contiguous(), group=group)
    return torch.stack(parts)
