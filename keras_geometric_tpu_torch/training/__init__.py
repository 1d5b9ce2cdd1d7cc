"""Training tier: losses, metrics, step factories."""

from .train import (
    make_eval_fn,
    make_node_classification_step,
    masked_accuracy,
    masked_softmax_cross_entropy,
)

__all__ = [
    "make_node_classification_step",
    "make_eval_fn",
    "masked_accuracy",
    "masked_softmax_cross_entropy",
]
