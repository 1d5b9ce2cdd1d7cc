"""Dataset loaders (Planetoid citation graphs, synthetic, OGB-scale)."""

from .base import Dataset
from .citation import CitationDataset, CiteSeerDataset, PubMedDataset
from .cora import CoraDataset
from .ogb import OGB_STATS, OGBNodeDataset
from .synthetic import community_graph, synthetic_graph, synthetic_planetoid

__all__ = [
    "Dataset",
    "CoraDataset",
    "CitationDataset",
    "CiteSeerDataset",
    "PubMedDataset",
    "OGBNodeDataset",
    "OGB_STATS",
    "synthetic_graph",
    "synthetic_planetoid",
    "community_graph",
]
