"""Distribution tier: mesh construction, edge partitioning, halo exchange,
the kernelized per-rank bodies and the distributed training step, graph-
minibatch data parallelism and tensor (feature and head) parallelism, on
``torch.distributed``.

Counterpart of the JAX package's ``parallel/``: ``__all__`` is the
reference's; the names of ``data_parallel`` and ``tensor_parallel`` that it
leaves out are importable from here too.
"""

from .data_parallel import (
    make_dp_graph_classifier_step,
    stack_padded_batches,
)
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
from .tensor_parallel import (
    column_parallel_dense,
    row_parallel_dense,
    shard_params_gatv2_tp,
    shard_params_tp,
    tp_gatv2_block_local,
    tp_gcn_block_local,
    tp_graph_gatv2_block_local,
    tp_graph_gcn_block_local,
)

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
    "column_parallel_dense",
    "row_parallel_dense",
    "tp_gcn_block_local",
]
