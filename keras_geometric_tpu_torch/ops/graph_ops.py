"""Graph-structure operations: self-loops, GCN normalization, CSR build.

Counterpart of the JAX package's ``ops/graph_ops.py`` for what the GCN layer
needs. Semantics pinned by the reference:

- ``add_self_loops`` appends one ``(i, i)`` edge per node *after* the user
  edges, preserving order;
- ``gcn_norm``: ``w_e = (d[recv]+1e-12)^-1/2 * (d[send]+1e-12)^-1/2`` with
  ``d`` the receiver in-degree (self-loops already present count), inf -> 0.

The tensor functions run on whatever device their inputs lie on; the CSR
and padding helpers are host numpy and run once per graph (``pad_edges``:
masked dummy edges on node ``N - 1``; ``pad_nodes``: zero rows).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .segment import segment_count

__all__ = [
    "ensure_edge_index",
    "add_self_loops",
    "gcn_norm",
    "sort_edges_by_receiver",
    "coo_to_csr",
    "round_up",
    "CSRGraph",
    "pad_edges",
    "pad_nodes",
]


def ensure_edge_index(edge_index, device=None) -> torch.Tensor:
    """Canonicalize edge_index to an int32 ``[2, E]`` tensor.

    Accepts ``[2, E]`` or ``[E, 2]`` (transposed); the ambiguous 2x2 case is
    taken as ``[2, E]``.
    """
    edge_index = torch.as_tensor(edge_index, device=device)
    if edge_index.ndim != 2:
        raise ValueError(
            f"edge_index must be rank-2, got shape {tuple(edge_index.shape)}"
        )
    if edge_index.shape[0] != 2:
        if edge_index.shape[1] == 2:
            edge_index = edge_index.T
        else:
            raise ValueError(
                f"edge_index must be [2, E] or [E, 2], got "
                f"{tuple(edge_index.shape)}"
            )
    return edge_index.to(torch.int32)


def add_self_loops(
    edge_index: torch.Tensor,
    num_nodes: int,
    *,
    edge_mask: torch.Tensor | None = None,
    node_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Append one self-loop per node after the existing edges.

    Returns ``(edge_index_with_loops, edge_mask_with_loops)``. With masks,
    loops on masked-out nodes are masked, so a padded graph keeps the
    numerics of the unpadded one.
    """
    edge_index = ensure_edge_index(edge_index)
    device = edge_index.device
    loops = torch.arange(num_nodes, dtype=edge_index.dtype, device=device)
    out = torch.cat([edge_index, torch.stack([loops, loops])], dim=1)
    if edge_mask is None and node_mask is None:
        return out, None
    e = edge_index.shape[1]
    em = (
        edge_mask if edge_mask is not None
        else torch.ones(e, dtype=torch.bool, device=device)
    )
    nm = (
        node_mask if node_mask is not None
        else torch.ones(num_nodes, dtype=torch.bool, device=device)
    )
    return out, torch.cat([em, nm])


def gcn_norm(
    edge_index: torch.Tensor,
    num_nodes: int,
    *,
    edge_mask: torch.Tensor | None = None,
    indices_are_sorted: bool = False,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Symmetric GCN edge weights from receiver in-degree (inf -> 0).

    ``indices_are_sorted`` (receivers non-decreasing) is passed on to
    :func:`segment_count`, as the reference does.
    """
    edge_index = ensure_edge_index(edge_index)
    senders, receivers = edge_index[0], edge_index[1]
    deg = segment_count(receivers, num_nodes, mask=edge_mask, dtype=dtype,
                        indices_are_sorted=indices_are_sorted)
    inv_sqrt = torch.pow(deg + 1e-12, -0.5)
    inv_sqrt = torch.where(
        torch.isinf(inv_sqrt), torch.zeros_like(inv_sqrt), inv_sqrt
    )
    return inv_sqrt[receivers.long()] * inv_sqrt[senders.long()]


class CSRGraph(NamedTuple):
    """Receiver-sorted (CSR) graph structure, host side.

    ``row_ptr[i]:row_ptr[i+1]`` spans the incoming edges of node ``i``;
    ``perm`` maps sorted-edge position back to the original edge id. Padded
    edge slots point at node ``num_nodes - 1`` with ``edge_mask`` False.
    """

    senders: np.ndarray  # [E_pad] int32, receiver-sorted
    receivers: np.ndarray  # [E_pad] int32, non-decreasing
    row_ptr: np.ndarray  # [N+1] int32
    perm: np.ndarray  # [E_pad] int32 (original edge ids; pad slots = E)
    edge_mask: np.ndarray  # [E_pad] bool
    num_nodes: int
    num_edges: int  # true (unpadded) edge count


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def sort_edges_by_receiver(
    senders: np.ndarray, receivers: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stable-sort edges by receiver; returns (senders, receivers, perm)."""
    perm = np.argsort(receivers, kind="stable").astype(np.int32)
    return (
        np.asarray(senders, np.int32)[perm],
        np.asarray(receivers, np.int32)[perm],
        perm,
    )


def coo_to_csr(
    senders: np.ndarray,
    receivers: np.ndarray,
    num_nodes: int,
    *,
    pad_to: int | None = None,
) -> CSRGraph:
    """Build a receiver-sorted CSR structure, optionally padded to ``pad_to``."""
    senders = np.asarray(senders, np.int32)
    receivers = np.asarray(receivers, np.int32)
    num_edges = int(senders.shape[0])
    s, r, perm = sort_edges_by_receiver(senders, receivers)
    row_counts = np.bincount(r, minlength=num_nodes).astype(np.int32)
    row_ptr = np.zeros(num_nodes + 1, dtype=np.int32)
    np.cumsum(row_counts, out=row_ptr[1:])
    if pad_to is not None:
        if pad_to < num_edges:
            raise ValueError(f"pad_to={pad_to} < num_edges={num_edges}")
        pad = pad_to - num_edges
        dummy = max(num_nodes - 1, 0)
        s = np.concatenate([s, np.full(pad, dummy, np.int32)])
        r = np.concatenate([r, np.full(pad, dummy, np.int32)])
        perm = np.concatenate([perm, np.full(pad, num_edges, np.int32)])
    mask = np.arange(s.shape[0]) < num_edges
    return CSRGraph(
        senders=s,
        receivers=r,
        row_ptr=row_ptr,
        perm=perm,
        edge_mask=mask,
        num_nodes=num_nodes,
        num_edges=num_edges,
    )


def pad_edges(
    edge_index: np.ndarray, target_e: int, num_nodes: int
) -> tuple[np.ndarray, np.ndarray]:
    """Pad a ``[2, E]`` COO edge list to ``[2, target_e]`` with masked dummies."""
    edge_index = np.asarray(edge_index, np.int32)
    if edge_index.shape[0] != 2:
        edge_index = edge_index.T
    e = edge_index.shape[1]
    if target_e < e:
        raise ValueError(f"target_e={target_e} < E={e}")
    dummy = max(num_nodes - 1, 0)
    pad = np.full((2, target_e - e), dummy, np.int32)
    mask = np.arange(target_e) < e
    return np.concatenate([edge_index, pad], axis=1), mask


def pad_nodes(
    x: np.ndarray, target_n: int
) -> tuple[np.ndarray, np.ndarray]:
    """Zero-pad node features ``[N, F]`` to ``[target_n, F]`` with a mask."""
    x = np.asarray(x)
    n = x.shape[0]
    if target_n < n:
        raise ValueError(f"target_n={target_n} < N={n}")
    pad = np.zeros((target_n - n,) + x.shape[1:], dtype=x.dtype)
    mask = np.arange(target_n) < n
    return np.concatenate([x, pad], axis=0), mask
