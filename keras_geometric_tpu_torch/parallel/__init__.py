"""Distribution tier: mesh construction, edge partitioning, halo exchange,
the kernelized per-rank bodies and the distributed training step, on
``torch.distributed``.

Counterpart of the JAX package's ``parallel/`` for partitioned full-graph
training; its dense tensor-parallel blocks (``column_parallel_dense``,
``row_parallel_dense``, ``tp_gcn_block_local``) are not ported yet.
"""

from .distributed import (
    distributed_gcn_encoder,
    make_distributed_eval_fn,
    make_distributed_train_step,
    shard_partitioned_graph,
)
from .halo import build_halo_plan
from .kernel_plan import build_kernel_plan, spmm_local_overlapped
from .mesh import make_mesh
from .partition import PartitionedGraph, partition_graph

__all__ = [
    "make_mesh",
    "PartitionedGraph",
    "partition_graph",
    "shard_partitioned_graph",
    "make_distributed_train_step",
    "make_distributed_eval_fn",
    "distributed_gcn_encoder",
    "build_halo_plan",
    "build_kernel_plan",
    "spmm_local_overlapped",
]
