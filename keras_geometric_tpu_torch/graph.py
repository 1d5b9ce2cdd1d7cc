"""Static-shape graph container of tensors on one device.

Counterpart of the JAX package's ``graph.py``: a (possibly padded, possibly
batched) graph as padded arrays plus validity masks and true counts, so that
every padded slot is exactly neutral in every aggregation. Where the
reference registers a pytree, this is a frozen dataclass of ``torch.Tensor``s
that all lie on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

__all__ = ["Graph"]


def as_tensor(value: Any, device, dtype: torch.dtype | None = None):
    """``value`` as a tensor on ``device`` (``None`` stays ``None``).

    A read-only numpy array (a memory map) is copied first, so the tensor
    never shares memory that cannot be written.
    """
    if value is None:
        return None
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=dtype)
    arr = np.asarray(value)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.as_tensor(arr, dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class Graph:
    """A (possibly padded, possibly batched) graph on one device.

    Attributes:
        x: ``[N_pad, F]`` node features.
        senders: ``[E_pad]`` int32 source node ids.
        receivers: ``[E_pad]`` int32 target node ids.
        edge_attr: optional ``[E_pad, D]`` edge features.
        y: optional labels (node-level ``[N_pad, ...]`` or graph-level).
        node_mask: optional ``[N_pad]`` bool; None means all valid.
        edge_mask: optional ``[E_pad]`` bool; None means all valid.
        batch: optional ``[N_pad]`` int32 graph-id per node (disjoint-union
            batches); None for single graphs.
        n_node: 0-dim int32 true node count (or per-graph counts).
        n_edge: 0-dim int32 true edge count.
    """

    x: torch.Tensor
    senders: torch.Tensor
    receivers: torch.Tensor
    edge_attr: torch.Tensor | None = None
    y: torch.Tensor | None = None
    node_mask: torch.Tensor | None = None
    edge_mask: torch.Tensor | None = None
    batch: torch.Tensor | None = None
    n_node: torch.Tensor | None = None
    n_edge: torch.Tensor | None = None

    @property
    def num_nodes(self) -> int:
        """Padded node count."""
        return self.x.shape[0]

    @property
    def num_edges(self) -> int:
        """Padded edge count."""
        return self.senders.shape[0]

    @property
    def num_node_features(self) -> int:
        return self.x.shape[1] if self.x.ndim > 1 else 0

    @property
    def edge_index(self) -> torch.Tensor:
        """``[2, E]`` COO view."""
        return torch.stack([self.senders, self.receivers], dim=0)

    @classmethod
    def from_edge_index(
        cls,
        x: Any,
        edge_index: Any,
        *,
        edge_attr: Any = None,
        y: Any = None,
        device: torch.device | str = "cuda",
        **kwargs,
    ) -> "Graph":
        """Build from reference-style ``(x, edge_index[2,E] or [E,2])``.

        Every array (numpy or tensor; ``kwargs`` are the other fields) is
        moved to ``device``; the edge ids become int32.
        """
        if isinstance(edge_index, torch.Tensor):
            edge_index = edge_index.cpu()
        edge_index = np.asarray(edge_index)
        if edge_index.ndim != 2:
            raise ValueError(f"edge_index must be rank-2, got {edge_index.shape}")
        if edge_index.shape[0] != 2:
            if edge_index.shape[1] == 2:
                edge_index = edge_index.T
            else:
                raise ValueError(
                    f"edge_index must be [2, E] or [E, 2], got {edge_index.shape}"
                )
        return cls(
            x=as_tensor(x, device),
            senders=as_tensor(edge_index[0], device, torch.int32),
            receivers=as_tensor(edge_index[1], device, torch.int32),
            edge_attr=as_tensor(edge_attr, device),
            y=as_tensor(y, device),
            **{k: as_tensor(v, device) for k, v in kwargs.items()},
        )
