"""Host-side graph data container and disjoint-union batching.

Counterpart of the JAX package's ``utils/data_utils.py``, with the same
contracts:

- :class:`GraphData`: holds ``x, edge_index, edge_attr, y, num_nodes`` as
  numpy arrays plus arbitrary extras reachable as attributes, with
  ``num_edges`` / ``num_node_features`` / ``num_edge_features`` properties
  and ``to_inputs()`` for model calls;
- :func:`batch_graphs`: disjoint-union batching: concatenated features,
  node-offset-shifted edge indices, an int32 per-node ``batch`` vector,
  graph-level ``y`` stacked to ``[num_graphs, ...]`` and node-level ``y``
  concatenated;
- :func:`batch_graphs_padded`: the union padded to fixed ``(num_nodes,
  num_edges)`` bucket sizes with masks, as a :class:`Graph` of tensors.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from ..graph import Graph, as_tensor
from ..ops.graph_ops import round_up

__all__ = ["GraphData", "batch_graphs", "batch_graphs_padded"]

ArrayLike = Union[np.ndarray, Any]


class GraphData:
    """Host-side (numpy) graph container with attribute-style extras."""

    def __init__(
        self,
        x: ArrayLike,
        edge_index: ArrayLike,
        edge_attr: Optional[ArrayLike] = None,
        y: Optional[ArrayLike] = None,
        num_nodes: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        self.x = np.asarray(x)
        edge_index = np.asarray(edge_index)
        if edge_index.ndim != 2:
            raise ValueError(
                f"edge_index must be rank-2, got shape {edge_index.shape}"
            )
        if edge_index.shape[0] != 2:
            if edge_index.shape[1] == 2:
                edge_index = edge_index.T
            else:
                raise ValueError(
                    f"edge_index must be [2, E] or [E, 2], got {edge_index.shape}"
                )
        self.edge_index = edge_index.astype(np.int32)
        self.edge_attr = None if edge_attr is None else np.asarray(edge_attr)
        self.y = None if y is None else np.asarray(y)
        self._num_nodes = (
            int(self.x.shape[0]) if num_nodes is None else int(num_nodes)
        )
        self._additional_data = {k: np.asarray(v) for k, v in kwargs.items()}

    @property
    def num_nodes(self) -> int:
        return self._num_nodes

    @property
    def num_edges(self) -> int:
        return int(self.edge_index.shape[1])

    @property
    def num_node_features(self) -> int:
        return int(self.x.shape[1]) if self.x.ndim > 1 else 0

    @property
    def num_edge_features(self) -> int:
        if self.edge_attr is None:
            return 0
        return int(self.edge_attr.shape[1]) if self.edge_attr.ndim > 1 else 0

    def to_dict(self) -> dict[str, Any]:
        out = {"x": self.x, "edge_index": self.edge_index}
        if self.edge_attr is not None:
            out["edge_attr"] = self.edge_attr
        if self.y is not None:
            out["y"] = self.y
        out.update(self._additional_data)
        return out

    def to_inputs(self) -> list:
        """Model-call inputs ``[x, edge_index(, edge_attr)]``."""
        inputs = [self.x, self.edge_index]
        if self.edge_attr is not None:
            inputs.append(self.edge_attr)
        return inputs

    def to_graph(self, device: torch.device | str = "cuda") -> Graph:
        """:class:`~keras_geometric_tpu_torch.graph.Graph` on ``device``."""
        batch = self._additional_data.get("batch")
        return Graph.from_edge_index(
            self.x,
            self.edge_index,
            edge_attr=self.edge_attr,
            y=self.y,
            device=device,
            **({"batch": batch} if batch is not None else {}),
        )

    def __getattr__(self, name: str) -> Any:
        data = self.__dict__.get("_additional_data", {})
        if name in data:
            return data[name]
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute '{name}'"
        )

    def __repr__(self) -> str:
        parts = [f"x={list(self.x.shape)}", f"edge_index={list(self.edge_index.shape)}"]
        if self.edge_attr is not None:
            parts.append(f"edge_attr={list(self.edge_attr.shape)}")
        if self.y is not None:
            parts.append(f"y={list(self.y.shape)}")
        return f"GraphData({', '.join(parts)})"


def batch_graphs(graphs: list[GraphData]) -> GraphData:
    """Disjoint-union batch of graphs (the reference's semantics)."""
    if not graphs:
        raise ValueError("Cannot batch empty list of graphs")

    xs, eis, batch_ids = [], [], []
    node_offset = 0
    for i, g in enumerate(graphs):
        xs.append(g.x)
        eis.append(g.edge_index + node_offset)
        batch_ids.append(np.full(g.num_nodes, i, np.int32))
        node_offset += g.num_nodes

    batch_x = np.concatenate(xs, axis=0)
    batch_edge_index = np.concatenate(eis, axis=1)
    batch_vec = np.concatenate(batch_ids, axis=0)

    has_edge_attr = all(g.edge_attr is not None for g in graphs)
    batch_edge_attr = (
        np.concatenate([g.edge_attr for g in graphs], axis=0)
        if has_edge_attr
        else None
    )

    has_y = all(g.y is not None for g in graphs)
    batch_y = None
    if has_y:
        if graphs[0].y.ndim == 1:  # graph-level target -> [num_graphs, C]
            batch_y = np.stack([g.y for g in graphs], axis=0)
        else:  # node-level targets -> [total_nodes, C]
            batch_y = np.concatenate([g.y for g in graphs], axis=0)

    return GraphData(
        x=batch_x,
        edge_index=batch_edge_index,
        edge_attr=batch_edge_attr,
        y=batch_y,
        num_nodes=int(node_offset),
        batch=batch_vec,
    )


def batch_graphs_padded(
    graphs: list[GraphData],
    *,
    node_bucket: int | None = None,
    edge_bucket: int | None = None,
    bucket_multiple: int = 128,
    device: torch.device | str = "cuda",
) -> Graph:
    """Disjoint-union batch padded to fixed bucket sizes, on ``device``.

    Nodes / edges are padded up to ``node_bucket`` / ``edge_bucket``
    (default: the true totals rounded up to ``bucket_multiple``). The
    default of 128 is the reference's, kept so that a call without buckets
    gives the same shapes in both packages; the value means nothing to the
    card's kernels, which take any size. Padded nodes carry zero features,
    belong to a dummy extra graph id (``len(graphs)``), and are masked;
    padded edges are self-loops on the last padded node and masked.
    """
    base = batch_graphs(graphs)
    n, e = base.num_nodes, base.num_edges
    n_pad = node_bucket if node_bucket is not None else round_up(max(n, 1), bucket_multiple)
    e_pad = edge_bucket if edge_bucket is not None else round_up(max(e, 1), bucket_multiple)
    if n_pad < n or e_pad < e:
        raise ValueError(
            f"bucket sizes ({n_pad}, {e_pad}) smaller than batch ({n}, {e})"
        )

    x = np.zeros((n_pad,) + base.x.shape[1:], dtype=base.x.dtype)
    x[:n] = base.x
    node_mask = np.arange(n_pad) < n
    batch_vec = np.full(n_pad, len(graphs), np.int32)
    batch_vec[:n] = base.batch

    dummy = n_pad - 1
    ei = np.full((2, e_pad), dummy, np.int32)
    ei[:, :e] = base.edge_index
    edge_mask = np.arange(e_pad) < e

    edge_attr = None
    if base.edge_attr is not None:
        edge_attr = np.zeros((e_pad,) + base.edge_attr.shape[1:], base.edge_attr.dtype)
        edge_attr[:e] = base.edge_attr

    y = base.y
    if y is not None and y.ndim > 1 and y.shape[0] == n:  # node-level: pad
        y_pad = np.zeros((n_pad,) + y.shape[1:], y.dtype)
        y_pad[:n] = y
        y = y_pad

    return Graph(
        x=as_tensor(x, device),
        senders=as_tensor(ei[0], device),
        receivers=as_tensor(ei[1], device),
        edge_attr=as_tensor(edge_attr, device),
        y=as_tensor(y, device),
        node_mask=as_tensor(node_mask, device),
        edge_mask=as_tensor(edge_mask, device),
        batch=as_tensor(batch_vec, device),
        n_node=torch.tensor(n, dtype=torch.int32, device=device),
        n_edge=torch.tensor(e, dtype=torch.int32, device=device),
    )
