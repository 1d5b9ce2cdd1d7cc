"""Graph-level readouts: global and batched pooling, attention and Set2Set."""

from .attention_pooling import AttentionPooling, Set2Set
from .global_pooling import (
    BatchGlobalPooling,
    GlobalPooling,
    batch_pool,
    global_pool,
)

__all__ = [
    "GlobalPooling",
    "BatchGlobalPooling",
    "AttentionPooling",
    "Set2Set",
    "global_pool",
    "batch_pool",
]
