"""Functional message-passing core.

Counterpart of the JAX package's ``nn/message_passing.py``: one function,
:func:`propagate`, runs gather -> message -> aggregate -> update over a COO
edge list with the hooks as closures, and :class:`MessagePassing` is the
subclassable hook-style surface over it. Semantics kept from the reference:

- bipartite input as a ``(x_target, x_source)`` tuple;
- ``x_j`` gathered from senders, ``x_i`` from receivers;
- the default message is ``x_j``, the default update the identity;
- an empty graph (no target node) or a graph without edges returns zeros of
  the target's shape, without calling the update;
- ``edge_mask`` makes padded edges exactly neutral.
"""

from __future__ import annotations

from typing import Callable

import torch

from .aggregators import aggregate as _aggregate

__all__ = ["propagate", "MessagePassing"]


def propagate(
    x: torch.Tensor | tuple[torch.Tensor, torch.Tensor],
    edge_index: torch.Tensor,
    *,
    aggregator: str = "mean",
    message_fn: Callable | None = None,
    update_fn: Callable | None = None,
    pre_aggregate_fn: Callable | None = None,
    post_update_fn: Callable | None = None,
    aggregate_fn: Callable | None = None,
    edge_attr: torch.Tensor | None = None,
    edge_mask: torch.Tensor | None = None,
    indices_are_sorted: bool = False,
) -> torch.Tensor:
    """Run gather -> message -> aggregate -> update over a COO edge list.

    Args:
        x: ``[N, F]`` node features, or ``(x_target, x_source)`` for
            bipartite graphs.
        edge_index: ``[2, E]`` integer tensor; row 0 = senders (source j),
            row 1 = receivers (target i).
        aggregator: one of sum/mean/max/min/std (ignored if ``aggregate_fn``).
        message_fn: ``(x_i, x_j, edge_attr) -> [E, F']``; default ``x_j``.
        update_fn: ``(aggregated, x_target) -> [N, F'']``; default identity.
        pre_aggregate_fn: ``messages -> messages`` hook.
        post_update_fn: ``(x_target, updated) -> updated`` hook.
        aggregate_fn: full custom ``(messages, receivers, num_nodes) -> [N, F']``.
        edge_attr: optional ``[E, D]`` per-edge features.
        edge_mask: optional ``[E]`` bool; False edges are exactly neutral.
        indices_are_sorted: edges are receiver-sorted (passed on to the
            aggregator).

    Returns:
        ``[N_target, F_out]`` updated node features.
    """
    if isinstance(x, (tuple, list)):
        x_target, x_source = x[0], x[1]
    else:
        x_target = x_source = x
    num_nodes = x_target.shape[0]

    if num_nodes == 0:
        return torch.zeros((0, x_target.shape[1]), dtype=x_target.dtype,
                           device=x_target.device)
    if edge_index.shape[1] == 0:
        # Zeros of the input's width, without calling the update: layers
        # handle their own no-edge cases above this level.
        return torch.zeros((num_nodes, x_target.shape[1]),
                           dtype=x_target.dtype, device=x_target.device)

    senders = edge_index[0].long()
    receivers = edge_index[1].long()
    x_j = x_source.index_select(0, senders)
    x_i = x_target.index_select(0, receivers)

    messages = message_fn(x_i, x_j, edge_attr) if message_fn else x_j
    if pre_aggregate_fn is not None:
        messages = pre_aggregate_fn(messages)

    if aggregate_fn is not None:
        aggregated = aggregate_fn(messages, receivers, num_nodes)
    else:
        aggregated = _aggregate(
            aggregator,
            messages,
            receivers,
            num_nodes,
            mask=edge_mask,
            indices_are_sorted=indices_are_sorted,
        )

    if update_fn is not None:
        aggregated = update_fn(aggregated, x_target)
    if post_update_fn is not None:
        aggregated = post_update_fn(x_target, aggregated)
    return aggregated


class MessagePassing:
    """Subclassable hook-style API over :func:`propagate`.

    Subclass and override ``message`` / ``pre_aggregate`` / ``aggregate`` /
    ``update`` / ``post_update``; call the instance with ``[x, edge_index(,
    edge_attr)]``. The instance carries only the aggregator's name. New
    code should prefer :func:`propagate` with closures.
    """

    def __init__(self, aggregator: str = "mean") -> None:
        self.aggregator = aggregator

    # -- overridable hooks --------------------------------------------------
    def message(self, x_i, x_j, edge_attr=None):
        return x_j

    def pre_aggregate(self, messages):
        return messages

    def aggregate(self, messages, receivers, num_nodes):
        return _aggregate(self.aggregator, messages, receivers, num_nodes)

    def update(self, aggregated, x=None):
        return aggregated

    def post_update(self, x, updated):
        return updated

    def propagate(self, x, edge_index, edge_attr=None, **kwargs):
        return propagate(
            x,
            edge_index,
            aggregator=self.aggregator,
            message_fn=lambda x_i, x_j, ea: self.message(x_i, x_j, ea),
            pre_aggregate_fn=self.pre_aggregate,
            aggregate_fn=lambda m, r, n: self.aggregate(m, r, n),
            update_fn=lambda agg, x_t: self.update(agg, x_t),
            post_update_fn=self.post_update,
            edge_attr=edge_attr,
            **kwargs,
        )

    def __call__(self, inputs, edge_attr=None, **kwargs):
        """Call convention ``[x, edge_index(, edge_attr)]``."""
        if not isinstance(inputs, (list, tuple)) or len(inputs) < 2:
            raise ValueError(
                "Inputs must be a list or tuple containing [x, edge_index]"
            )
        x, edge_index = inputs[0], inputs[1]
        if len(inputs) >= 3 and inputs[2] is not None:
            edge_attr = inputs[2]
        device = (x[0] if isinstance(x, (tuple, list)) else x).device
        edge_index = torch.as_tensor(edge_index, device=device).to(
            torch.int32)
        return self.propagate(x, edge_index, edge_attr=edge_attr, **kwargs)

    def get_config(self) -> dict:
        return {"aggregator": self.aggregator}

    @classmethod
    def from_config(cls, config: dict) -> "MessagePassing":
        return cls(**config)
