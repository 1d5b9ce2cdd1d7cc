"""Neural network layers: building blocks, message passing, conv layers and
pooling."""

from .aggregators import (
    AGGREGATORS,
    PoolingAggregator,
    aggregate,
    available_aggregators,
)
from .gatv2_conv import GATv2Conv
from .gcn_conv import GCNConv
from .gin_conv import GINConv
from .message_passing import MessagePassing, propagate
from .module import MLP, Dense, Module, dropout, get_activation, get_initializer
from .pooling import AttentionPooling, BatchGlobalPooling, GlobalPooling, Set2Set
from .sage_conv import SAGEConv

__all__ = [
    "Module",
    "Dense",
    "MLP",
    "dropout",
    "get_activation",
    "get_initializer",
    "MessagePassing",
    "propagate",
    "aggregate",
    "available_aggregators",
    "AGGREGATORS",
    "PoolingAggregator",
    "GCNConv",
    "GINConv",
    "GATv2Conv",
    "SAGEConv",
    "GlobalPooling",
    "BatchGlobalPooling",
    "AttentionPooling",
    "Set2Set",
]
