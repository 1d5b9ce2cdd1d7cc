"""Model compositions: multi-layer GNN encoders."""

from .gnn import GCN, GNNEncoder

__all__ = ["GNNEncoder", "GCN"]
