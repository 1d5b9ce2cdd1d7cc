"""Graph-minibatch data parallelism, on ``torch.distributed``.

Counterpart of the JAX package's ``parallel/data_parallel.py``: a batch of
padded graph buckets is split over a ``data`` mesh axis; each rank holds its
buckets and runs the whole model on them; parameters are replicated, kept
equal by summing every gradient over the data group once per step (the
all-reduce that the reference's jit inserts for replicated parameters).

Works with :func:`keras_geometric_tpu_torch.utils.batch_graphs_padded`
buckets, stacked along a leading axis.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from ..training.train import label_nll
from .distributed import _sum_gradients, _SumOverRanks
from .mesh import DeviceMesh, local_device

__all__ = ["stack_padded_batches", "make_dp_graph_classifier_step"]

_FIELDS = ("x", "senders", "receivers", "edge_mask", "node_mask", "batch",
           "y")


def stack_padded_batches(graphs: list, mesh: DeviceMesh, *,
                         axis: str = "data") -> dict:
    """This rank's share of ``k`` equal-shape padded Graph buckets (from
    ``batch_graphs_padded``), stacked into ``[m, ...]`` tensors on its
    device, ``m = k / P`` for the ``P`` ranks of ``axis``.

    Rank ``r`` (its coordinate on ``axis``) keeps buckets ``r*m .. (r+1)*m
    - 1``, the rows of the reference's sharded ``[k, ...]`` arrays that its
    device holds. Returns a dict of ``x``, ``senders``, ``receivers``,
    ``edge_mask``, ``node_mask``, ``batch`` and ``y``; a field that is
    ``None`` in any bucket is left out. Raises on an empty list, on a ``k``
    that the ranks do not divide, and on buckets whose shapes differ.
    """
    if not graphs:
        raise ValueError("need at least one padded graph bucket")
    group = mesh.get_group(axis)
    size, rank = dist.get_world_size(group), mesh.get_local_rank(axis)
    if len(graphs) % size:
        raise ValueError(f"{len(graphs)} buckets do not divide over the "
                         f"{size} ranks of axis {axis!r}")
    m = len(graphs) // size
    device = local_device(mesh)

    out = {}
    for field in _FIELDS:
        vals = [getattr(g, field) for g in graphs]
        if any(v is None for v in vals):
            continue
        vals = [torch.as_tensor(v) for v in vals]
        if len({tuple(v.shape) for v in vals}) > 1:
            raise ValueError(f"buckets differ in the shape of {field!r}")
        out[field] = torch.stack(
            [v.to(device) for v in vals[rank * m:(rank + 1) * m]])
    return out


def make_dp_graph_classifier_step(
    model: Any,
    optimizer: torch.optim.Optimizer,
    mesh: DeviceMesh,
    num_graphs_per_shard: int,
    *,
    axis: str = "data",
) -> Callable:
    """Build ``step(data) -> loss``: one optimizer step of a
    ``GraphClassifier`` over every rank's buckets.

    ``data`` is this rank's :func:`stack_padded_batches` dict with ``y``
    ``[m, G]`` added (``-1`` on padded graph slots; ``G =
    num_graphs_per_shard``). The loss is the global mean over every rank's
    labelled slots: each rank's masked NLL sum and count, summed over the
    data group (identity backward), then ``sum / max(count, 1)``; after
    ``backward()`` the gradients are summed over the group once, and the
    optimizer steps. Every rank must call the step; it returns the loss, a
    detached 0-dim tensor (no host synchronisation).

    The reference applies the model with ``training=False`` and no random
    key, so the step runs it in ``eval()`` mode: no dropout is drawn. The
    reference's ``donate`` (buffer donation to jit) has no PyTorch meaning
    and is left out.
    """
    group = mesh.get_group(axis)

    def step(data):
        model.eval()
        optimizer.zero_grad(set_to_none=True)
        sums, counts = [], []
        for i in range(data["x"].shape[0]):
            edge_index = torch.stack([data["senders"][i],
                                      data["receivers"][i]])
            logits = model(data["x"][i], edge_index, data["batch"][i],
                           num_graphs_per_shard,
                           edge_mask=data["edge_mask"][i],
                           node_mask=data["node_mask"][i])
            y = data["y"][i]
            valid = (y >= 0).to(logits.dtype)
            nll = label_nll(torch.log_softmax(logits, dim=-1),
                            y.clamp_min(0))
            sums.append((nll * valid).sum())
            counts.append(valid.sum())
        total = _SumOverRanks.apply(
            torch.stack([torch.stack(sums).sum(), torch.stack(counts).sum()]),
            group)
        loss = total[0] / total[1].clamp_min(1.0)
        loss.backward()
        _sum_gradients(model.parameters(), group)
        optimizer.step()
        return loss.detach()

    return step
