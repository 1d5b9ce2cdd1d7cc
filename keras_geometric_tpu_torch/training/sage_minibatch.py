"""SAGE minibatch training over sampled subgraphs.

Counterpart of the JAX package's ``training/sage_minibatch.py``: one
optimizer step over the fixed-shape buckets that
``data.sampling.NeighborSampler`` produces. Layer ``k`` of the model consumes
the sampled edge set ``layers[k]`` (output-side first). With fixed bucket
shapes every conv runs over the full node bucket with that layer's edge mask;
masked nodes and edges are neutral, so the result equals the layered
computation on the sampled subgraph.

The aggregations run on the library-op tier (``ops/segment.py``), as the
reference's run XLA segment ops: no hand-written kernel lies on this path.
Each layer's real edges are receiver-sorted but the masked padding slots
(senders = receivers = 0) trail them, so a layer's receivers as a whole are
not sorted. ``indices_are_sorted=True`` is passed as the reference passes
it; the segment ops ignore it, and it must never route these edges to a
sorted-CSR kernel (the messages-form scatter, the segment max kernels).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..data.sampling import SampledSubgraph
from ..nn.sage_conv import SAGEConv
from .train import masked_softmax_cross_entropy

__all__ = ["make_sage_minibatch_step", "subgraph_to_arrays"]


def _on(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def subgraph_to_arrays(
    sub: SampledSubgraph, x_global, y_global, *, device=None
) -> dict:
    """The bucket's features, labels and layers in its local id space.

    ``x_global`` / ``y_global`` are numpy arrays (memory maps too), sliced on
    the host and copied to ``device`` (default the card); or tensors, already
    on the device, gathered there (``index_select`` of the clamped
    ``node_map``, times ``node_mask``). The results are equal either way.
    """
    if isinstance(x_global, torch.Tensor):
        device = x_global.device if device is None else torch.device(device)
        node_map = _on(np.maximum(sub.node_map, 0), device)
        node_mask = _on(sub.node_mask, device)
        x = x_global.index_select(0, node_map) * node_mask[:, None]
        y_seed = y_global.index_select(0, _on(sub.seed_ids, device))
    else:
        device = "cuda" if device is None else device
        safe = np.maximum(sub.node_map, 0)
        x = _on(np.asarray(x_global)[safe] * sub.node_mask[:, None], device)
        y_seed = _on(np.asarray(y_global)[sub.seed_ids], device)
    return {
        "x": x,
        "y_seed": y_seed,
        "seed_mask": _on(sub.seed_mask, device),
        "layers": tuple(
            (_on(s, device), _on(r, device), _on(m, device))
            for s, r, m in sub.layers
        ),
    }


def make_sage_minibatch_step(
    layers: tuple[SAGEConv, ...],
    head_dim: int,
    optimizer: torch.optim.Optimizer,
    *,
    activation: Callable = torch.relu,
    generator: torch.Generator | None = None,
) -> tuple[Callable, Callable]:
    """``(step, infer)`` for a stack of SAGEConv layers.

    The conv stack runs deepest-first: model layer ``i`` (0-based from the
    input side) uses sampled edge set ``data["layers"][n-1-i]``, with
    ``activation`` between layers. ``step(data) -> loss`` is one optimizer
    step in ``train()`` mode (dropout drawn from ``generator``) over the
    loss of the first ``B`` bucket rows, the seed nodes; it returns a
    detached 0-dim loss and does not synchronise with the host.
    ``infer(data) -> logits`` runs every bucket row in ``eval()`` mode under
    ``no_grad``. ``head_dim`` (the output width) is the reference's argument
    and is not needed here.
    """
    layers = tuple(layers)
    n = len(layers)

    def forward(data):
        h = data["x"]
        for i, layer in enumerate(layers):
            senders, receivers, emask = data["layers"][n - 1 - i]
            h = layer(h, torch.stack([senders, receivers]), edge_mask=emask,
                      indices_are_sorted=True, generator=generator)
            if i < n - 1:
                h = activation(h)
        return h

    def step(data):
        for layer in layers:
            layer.train()
        optimizer.zero_grad(set_to_none=True)
        b = data["y_seed"].shape[0]
        logits = forward(data)[:b]
        loss = masked_softmax_cross_entropy(logits, data["y_seed"],
                                            data["seed_mask"])
        loss.backward()
        optimizer.step()
        return loss.detach()

    @torch.no_grad()
    def infer(data):
        for layer in layers:
            layer.eval()
        return forward(data)

    return step, infer
