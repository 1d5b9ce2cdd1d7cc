"""Graph-level readout: single-graph and batched-segment global pooling.

Counterpart of the JAX package's ``nn/pooling/global_pooling.py``:

- ``global_pool`` / ``GlobalPooling``: mean, max or sum over the node axis
  -> ``[1, F]``; under a ``node_mask`` the masked nodes are neutral, the mean
  divides by the unmasked count clamped at 1, and a max column with no
  unmasked node gives 0.
- ``batch_pool`` / ``BatchGlobalPooling``: one reduction per graph of a
  ``batch`` assignment vector -> ``[num_graphs, F]``; the mean divides by
  counts clamped at 1 (not the aggregators' ``1e-8``).

The max's gradient splits a tied column's cotangent evenly among its tied
nodes, as the reference's ``jnp.max`` and XLA's segment max do
(``torch.amax`` and ``ops/segment.py`` split it; ``torch.max(x, 0)`` would
hand it all to one node). The batched readout runs the library segment ops
of ``ops/segment.py``, as the reference runs XLA's: a padded batch's padded
nodes carry the dummy graph id ``len(graphs)`` and are never routed to a
sorted-CSR kernel.
"""

from __future__ import annotations

import torch

from ...ops.segment import segment_count, segment_max, segment_sum
from ..module import Module

__all__ = ["GlobalPooling", "BatchGlobalPooling", "global_pool", "batch_pool"]

_POOLING = ("mean", "max", "sum")


def _check_pooling(pooling: str) -> None:
    if pooling not in _POOLING:
        raise ValueError(
            f"pooling must be one of {list(_POOLING)}, got {pooling}")


def global_pool(
    x: torch.Tensor,
    pooling: str = "mean",
    *,
    node_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Reduce ``[N, F]`` node features to a ``[1, F]`` graph representation."""
    _check_pooling(pooling)
    if node_mask is None:
        if pooling == "mean":
            return x.mean(0, keepdim=True)
        if pooling == "max":
            return x.amax(0, keepdim=True)
        return x.sum(0, keepdim=True)
    m = node_mask[:, None]
    if pooling == "sum":
        return torch.where(m, x, 0).sum(0, keepdim=True)
    if pooling == "mean":
        count = node_mask.sum().clamp_min(1).to(x.dtype)
        return torch.where(m, x, 0).sum(0, keepdim=True) / count
    out = x.masked_fill(~m, float("-inf")).amax(0, keepdim=True)
    return torch.where(torch.isinf(out), torch.zeros_like(out), out)


def batch_pool(
    x: torch.Tensor,
    batch: torch.Tensor,
    num_graphs: int,
    pooling: str = "mean",
    *,
    node_mask: torch.Tensor | None = None,
    indices_are_sorted: bool = True,
) -> torch.Tensor:
    """Reduce ``[N_total, F]`` stacked node features to ``[num_graphs, F]``.

    ``batch[i]`` is the graph id of node ``i``. ``indices_are_sorted`` is the
    reference's hint; the library ops take any order and ignore it.
    """
    _check_pooling(pooling)
    kw = dict(mask=node_mask, indices_are_sorted=indices_are_sorted)
    if pooling == "sum":
        return segment_sum(x, batch, num_graphs, **kw)
    if pooling == "max":
        return segment_max(x, batch, num_graphs, **kw)
    total = segment_sum(x, batch, num_graphs, **kw)
    counts = segment_count(batch, num_graphs, dtype=x.dtype, **kw)
    return total / counts.clamp_min(1.0)[:, None]


class GlobalPooling(Module):
    """Parameter-free single-graph readout."""

    def __init__(self, pooling: str = "mean"):
        super().__init__()
        self._keep_config(locals())
        _check_pooling(pooling)
        self.pooling = pooling

    def forward(self, x: torch.Tensor, *,
                node_mask: torch.Tensor | None = None) -> torch.Tensor:
        return global_pool(x, self.pooling, node_mask=node_mask)


class BatchGlobalPooling(Module):
    """Parameter-free batched readout over a ``batch`` assignment vector."""

    def __init__(self, pooling: str = "mean"):
        super().__init__()
        self._keep_config(locals())
        _check_pooling(pooling)
        self.pooling = pooling

    def forward(
        self,
        x: torch.Tensor,
        batch: torch.Tensor,
        num_graphs: int,
        *,
        node_mask: torch.Tensor | None = None,
    ) -> torch.Tensor:
        return batch_pool(x, batch, num_graphs, self.pooling,
                          node_mask=node_mask)
