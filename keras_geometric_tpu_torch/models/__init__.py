"""Model compositions: multi-layer GNN encoders."""

from .gnn import GAT, GCN, GNNEncoder

__all__ = ["GNNEncoder", "GCN", "GAT"]
