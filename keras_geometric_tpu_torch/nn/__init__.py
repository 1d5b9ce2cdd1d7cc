"""Neural network layers: building blocks and conv layers."""

from .gatv2_conv import GATv2Conv
from .gcn_conv import GCNConv
from .module import MLP, Dense, dropout, get_activation, get_initializer

__all__ = [
    "Dense",
    "MLP",
    "dropout",
    "get_activation",
    "get_initializer",
    "GCNConv",
    "GATv2Conv",
]
