"""Multi-process distribution on ``torch.distributed``: the port of
``toyslam_tpu.parallel``.

The JAX package runs a ``shard_map`` over a device mesh; here every rank is
a process of its own (SPMD) that holds only its shard, and each ``psum`` of
the JAX package is an ``all_reduce`` on the rank's process group
(``ops/collective.py``).  Two solves plug into ``GaussNewton``: the
edge-sharded one (states replicated, ``distributed.py``) and the
state-partitioned one (keyframe and map blocks, ``partition.py``).  Under a
group the kernels never run, as the JAX package's gate declines its kernels
under an ``axis_name``.  ``launch.py`` starts N ranks on one host.
"""

from toyslam_torch.parallel.mesh import (
    Mesh,
    initialize_distributed,
    make_host_mesh,
    make_mesh,
    pad_edges_for_mesh,
    shard_graph,
)
from toyslam_torch.parallel.distributed import (
    distributed_linearize_solve,
    distributed_linearize_solve_3d,
    graph_shard_specs,
    graph3d_shard_specs,
)
from toyslam_torch.parallel.partition import (
    PartitionMeta,
    PartitionPlan,
    build_partition,
    gather_result,
    partitioned_linearize_solve,
)
