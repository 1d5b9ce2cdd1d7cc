"""Core sparse/graph compute ops: segment reductions, graph structure, SpMM."""

from . import edge_dropout, graph_ops, segment, spmm
from .csr import GraphContext, prepare_graph
from .graph_ops import (
    CSRGraph,
    add_self_loops,
    coo_to_csr,
    ensure_edge_index,
    gcn_norm,
    pad_edges,
    pad_nodes,
    round_up,
    sort_edges_by_receiver,
)
from .precompute import precompute_propagation
from .segment import (
    segment_count,
    segment_max,
    segment_mean,
    segment_min,
    segment_softmax,
    segment_std,
    segment_sum,
)

__all__ = [
    "edge_dropout",
    "graph_ops",
    "segment",
    "spmm",
    "GraphContext",
    "prepare_graph",
    "precompute_propagation",
    "CSRGraph",
    "add_self_loops",
    "coo_to_csr",
    "ensure_edge_index",
    "gcn_norm",
    "pad_edges",
    "pad_nodes",
    "round_up",
    "sort_edges_by_receiver",
    "segment_count",
    "segment_sum",
    "segment_mean",
    "segment_max",
    "segment_min",
    "segment_std",
    "segment_softmax",
]
