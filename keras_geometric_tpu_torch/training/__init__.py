"""Training tier: train state, steps, checkpointing, metrics."""

from .checkpoint import (
    load_config,
    restore_checkpoint,
    save_checkpoint,
    save_config,
)
from .metrics import MetricLogger
from .train import (
    TrainState,
    label_nll,
    make_eval_fn,
    make_node_classification_step,
    masked_accuracy,
    masked_softmax_cross_entropy,
)

__all__ = [
    "TrainState",
    "make_node_classification_step",
    "make_eval_fn",
    "masked_accuracy",
    "masked_softmax_cross_entropy",
    "label_nll",
    "save_checkpoint",
    "restore_checkpoint",
    "save_config",
    "load_config",
    "MetricLogger",
]
