"""Model compositions: multi-layer GNN encoders and task heads."""

from .gnn import GAT, GCN, GIN, GNNEncoder, GraphClassifier, GraphSAGE

__all__ = ["GNNEncoder", "GCN", "GIN", "GAT", "GraphSAGE", "GraphClassifier"]
