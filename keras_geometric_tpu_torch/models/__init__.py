"""Model compositions: multi-layer GNN encoders."""

from .gnn import GAT, GCN, GIN, GNNEncoder, GraphSAGE

__all__ = ["GNNEncoder", "GCN", "GIN", "GAT", "GraphSAGE"]
