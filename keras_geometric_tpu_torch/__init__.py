"""keras_geometric_tpu_torch: the PyTorch/CUDA port of the JAX package beside it.

A second package beside the JAX one, which stays as the reference. Ported so
far: the full-graph GCN training path (graph preparation, the sorted-CSR SpMM
with hand-written Hopper kernels, ``GCNConv``, ``GNNEncoder``, the training
step) and the GATv2 attention path, fused (``GraphContext.attend`` with
hand-written forward and backward kernels) and composed
(``GraphContext.sddmm_scores`` / ``edge_softmax`` with their own kernels,
``GATv2Conv(fused_attend=False)``, ``return_attention=True``), with
``GATv2Conv`` and ``GAT``; and the locality tier (``ops/reorder.py``, the
community graph generator, ``prepare_graph(band_window=..., attend_window=...)``
with hand-written band SpMM and window scatter kernels); and GIN and
GraphSAGE with all six aggregators (``GINConv``, ``SAGEConv``, ``GIN``,
``GraphSAGE``, ``propagate`` / ``MessagePassing``, ``aggregate``,
``PoolingAggregator``), whose max and pooling paths on a context run the
hand-written segment max kernel; and the data tier (``Graph``, ``GraphData``,
``batch_graphs``, the dataset loaders, the neighbour sampler) with
neighbour-sampled GraphSAGE minibatch training, checkpoints and metrics; and
the graph-level readout (``GlobalPooling``, ``BatchGlobalPooling``,
``AttentionPooling``, ``Set2Set``, ``global_pool``, ``batch_pool``) with
``models.GraphClassifier``, on the library segment ops. Every layer and
model has the reference's config round-trip (``get_config`` /
``from_config``). Entry points run on a CUDA device unless the caller passes another.
"""

from ._version import __version__
from .graph import Graph
from .models.gnn import GAT, GCN, GIN, GNNEncoder, GraphSAGE
from .nn.aggregators import PoolingAggregator, aggregate
from .nn.gatv2_conv import GATv2Conv
from .nn.gcn_conv import GCNConv
from .nn.gin_conv import GINConv
from .nn.message_passing import MessagePassing, propagate
from .nn.module import MLP, Dense, Module
from .nn.pooling.attention_pooling import AttentionPooling, Set2Set
from .nn.pooling.global_pooling import (
    BatchGlobalPooling,
    GlobalPooling,
    batch_pool,
    global_pool,
)
from .nn.sage_conv import SAGEConv
from .ops.csr import GraphContext, prepare_graph
from .ops.graph_ops import add_self_loops, ensure_edge_index, gcn_norm
from .ops.precompute import precompute_propagation
from .utils.data_utils import GraphData, batch_graphs


def compute_gcn_normalization(edge_index, num_nodes):
    """The reference's name for :func:`gcn_norm`."""
    return gcn_norm(edge_index, num_nodes)


def get_dataset_classes():
    """The dataset loaders, imported on first call."""
    from .data.datasets import CiteSeerDataset, CoraDataset, PubMedDataset

    return {
        "CoraDataset": CoraDataset,
        "CiteSeerDataset": CiteSeerDataset,
        "PubMedDataset": PubMedDataset,
    }


__all__ = [
    "__version__",
    "Graph",
    "Module",
    "Dense",
    "MLP",
    "MessagePassing",
    "propagate",
    "aggregate",
    "PoolingAggregator",
    "GCNConv",
    "GINConv",
    "GATv2Conv",
    "SAGEConv",
    "GlobalPooling",
    "BatchGlobalPooling",
    "AttentionPooling",
    "Set2Set",
    "global_pool",
    "batch_pool",
    "GNNEncoder",
    "GCN",
    "GIN",
    "GAT",
    "GraphSAGE",
    "GraphContext",
    "prepare_graph",
    "precompute_propagation",
    "add_self_loops",
    "gcn_norm",
    "ensure_edge_index",
    "compute_gcn_normalization",
    "GraphData",
    "batch_graphs",
    "get_dataset_classes",
]
