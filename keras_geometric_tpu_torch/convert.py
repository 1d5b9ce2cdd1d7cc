"""Carry parameters between the reference's trees and the port's modules.

The reference keeps parameters as nested dicts of arrays, e.g. a
``GNNEncoder``'s ``{"layer_0": {"kernel": [in, out], "bias": [out]}, ...}``.
The port's modules name their sub-modules and parameters the same way and
keep the ``[in, out]`` kernel layout, so a tree maps onto a ``state_dict`` by
joining the keys with dots; nothing is transposed.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

__all__ = ["params_from_jax", "params_to_numpy"]


def params_from_jax(
    tree: Mapping[str, Any], *, device=None, dtype: torch.dtype | None = None
) -> dict[str, torch.Tensor]:
    """Nested dict of arrays (anything ``np.asarray`` takes) -> ``state_dict``.

    ``model.load_state_dict(params_from_jax(tree))`` loads a ``GCNConv``
    (``{"kernel", "bias"}``), a ``GATv2Conv`` (``{"kernel", "att", "bias"}``,
    ``att`` kept ``[1, H, F]``), a ``GINConv`` (``{"mlp": {"dense_i":
    {"kernel", "bias"}}, "eps"}``, ``eps`` only when trainable), a
    ``SAGEConv`` (``{"pool_mlp": {"kernel", "bias"}, "lin_neigh": {"kernel"},
    "lin_self": {"kernel"}, "bias"}``, as far as its options give them), a
    ``PoolingAggregator`` (``{"mlp": {"kernel", "bias"}}``), a
    ``GNNEncoder`` / ``GCN`` / ``GIN`` / ``GAT`` / ``GraphSAGE``
    (``{"layer_i": {...}}``), a ``GraphClassifier`` (``{"encoder": {...},
    "head_i": {"kernel", "bias"}}``), an ``AttentionPooling``
    (``{"attention_transform": {...}, "attention_score": {...}}``) or a
    ``Set2Set`` (``{"lstm": {"kernel" [F, 4u], "recurrent_kernel" [u, 4u],
    "bias" [4u]}, "attention_dense": {...}}``).
    """
    out: dict[str, torch.Tensor] = {}

    def walk(prefix: str, node):
        if isinstance(node, Mapping):
            for key, value in node.items():
                walk(f"{prefix}.{key}" if prefix else str(key), value)
        else:
            t = torch.from_numpy(np.array(node, copy=True))
            out[prefix] = t.to(device=device, dtype=dtype)

    walk("", tree)
    return out


def params_to_numpy(state_dict: Mapping[str, torch.Tensor]) -> dict[str, Any]:
    """``state_dict`` (or ``named_parameters()`` pairs) -> nested dict of numpy
    arrays: the inverse of :func:`params_from_jax`."""
    tree: dict[str, Any] = {}
    for name, tensor in dict(state_dict).items():
        node = tree
        *parents, leaf = name.split(".")
        for key in parents:
            node = node.setdefault(key, {})
        tensor = tensor.detach().cpu()
        if tensor.dtype == torch.bfloat16:  # numpy has no bfloat16
            tensor = tensor.float()
        node[leaf] = tensor.numpy()
    return tree
