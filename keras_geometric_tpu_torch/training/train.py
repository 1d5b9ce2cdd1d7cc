"""Training steps: train state, losses, metrics, step and evaluation factories.

Counterpart of the JAX package's ``training/train.py``. State lives where
PyTorch keeps it: parameters in the model, moments in the ``torch.optim``
optimizer, randomness in an explicit ``torch.Generator``; :class:`TrainState`
gathers the four (with the step count) for checkpointing.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch import nn
from torch.func import functional_call

__all__ = [
    "TrainState",
    "label_nll",
    "masked_softmax_cross_entropy",
    "masked_accuracy",
    "make_node_classification_step",
    "make_eval_fn",
]


@dataclasses.dataclass
class TrainState:
    """Model, optimizer, step count and generator of one training run.

    The counterpart of the reference's ``TrainState`` pytree (``params``,
    ``opt_state``, ``step``, ``rng``): the parameters live in ``model``, the
    moments in ``optimizer``, the randomness in ``generator`` (the one the
    step factory was given; ``None`` when the run draws none). ``step`` is
    the caller's count of optimizer steps. ``state_dict()`` holds only
    tensors, ints and dicts, so a checkpoint of it loads under
    ``torch.load(weights_only=True)``; ``load_state_dict`` restores all four
    in place, so the run continues exactly where it stopped.
    """

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    generator: torch.Generator | None = None

    def state_dict(self) -> dict[str, Any]:
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "step": int(self.step),
            "generator": (None if self.generator is None
                          else self.generator.get_state()),
        }

    def load_state_dict(self, state: dict[str, Any]) -> "TrainState":
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        if (state["generator"] is None) != (self.generator is None):
            raise ValueError(
                "the checkpoint and this state disagree on having a generator")
        if self.generator is not None:
            self.generator.set_state(state["generator"])
        return self


def label_nll(logp: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``-logp[i, labels[i]]``, by a gather of each row's label column.

    The reference contracts with a one-hot instead (no fast row gather on
    its chip); the values are the same.
    """
    return -logp.gather(-1, labels.long()[..., None])[..., 0]


def masked_softmax_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Mean softmax cross-entropy over masked rows."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = label_nll(logp, labels)
    mask = mask.to(nll.dtype)
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def masked_accuracy(
    logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    pred = logits.argmax(dim=-1)
    mask = mask.to(torch.float32)
    hit = (pred == labels).to(torch.float32) * mask
    return hit.sum() / mask.sum().clamp_min(1.0)


def _forward(model, compute_dtype, x, edge_index, **kwargs):
    if compute_dtype is None:
        return model(x, edge_index, **kwargs)
    # bf16 IO / f32 master parameters: the cast is part of the graph, so
    # gradients arrive at (and the optimizer updates) the f32 masters.
    params = {
        name: p.to(compute_dtype) if p.is_floating_point() else p
        for name, p in model.named_parameters()
    }
    logits = functional_call(
        model, params, (x.to(compute_dtype), edge_index), kwargs
    )
    return logits.float()


def make_node_classification_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    *,
    loss_fn: Callable = masked_softmax_cross_entropy,
    compute_dtype: torch.dtype | None = None,
    generator: torch.Generator | None = None,
) -> Callable:
    """Build ``step(x, edge_index, y, mask, *, context=None) -> loss``.

    One call is one optimizer step: forward in ``train()`` mode, loss over the
    masked rows, backward, ``optimizer.step()``. ``model`` is any module with
    ``forward(x, edge_index, *, context=, generator=)``; ``optimizer`` holds
    its parameters. With ``compute_dtype=torch.bfloat16`` activations and the
    per-step parameter copies are bf16 while the master parameters, the loss
    and the gradients stay f32. The returned loss is a detached 0-dim tensor
    on the model's device (no host synchronisation).
    """

    def step(x, edge_index, y, mask, *, context=None):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        logits = _forward(
            model, compute_dtype, x, edge_index, context=context,
            generator=generator,
        )
        loss = loss_fn(logits, y, mask)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def make_eval_fn(
    model: nn.Module, *, compute_dtype: torch.dtype | None = None
) -> Callable:
    """Build ``evaluate(x, edge_index, y, mask, *, context=None) -> accuracy``."""

    @torch.no_grad()
    def evaluate(x, edge_index, y, mask, *, context=None):
        model.eval()
        logits = _forward(model, compute_dtype, x, edge_index, context=context)
        return masked_accuracy(logits, y, mask)

    return evaluate
