"""Distributed full-graph training: step and evaluation factories.

Counterpart of the JAX package's ``parallel/distributed.py``, in
``torch.distributed``'s idiom. Every rank runs the same program on its own
partition (the reference's ``shard_map`` over the ``graph`` axis):

- node features, labels and masks: each rank keeps its ``[L, ...]`` shard,
  the slice of the reference's ``[P, L, ...]`` arrays that its coordinate on
  the graph axis picks; so do the edge shards and the plans;
- parameters and optimizer state: replicated, one copy per rank, kept equal
  by summing every gradient over the graph group once per step (the
  ``psum`` that ``shard_map`` autodiff inserts for replicated parameters);
- the masked loss: each rank's NLL sum and count, summed over the group
  (an ``all_reduce`` whose backward is the identity), so every rank holds
  the global mean.

Gradients are summed exactly once: the loss's sum has an identity backward
and the parameters' gradients are ``all_reduce``-summed after
``backward()``. (``torch.distributed.nn.functional.all_reduce`` would sum
the loss's cotangent over the ranks again: P times the gradient.)

This is the "sequence-parallel" layout for GNNs: the node set is the
sequence, the adjacency the attention pattern, and the all-gather (or halo
exchange) of transformed features the analog of ring attention's k/v
exchange.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call

from ..models.gnn import GNNEncoder
from ..training.train import label_nll
from .mesh import DeviceMesh, local_device
from .partition import PartitionedGraph, partition_graph
from .spmd import encoder_apply_local, encoder_apply_local_kernelized

__all__ = [
    "shard_partitioned_graph",
    "make_distributed_train_step",
    "make_distributed_eval_fn",
    "distributed_gcn_encoder",
    "partition_graph",
]


def _node_shards(arr, pg: PartitionedGraph):
    """Reshape a global ``[N, ...]`` array into ``[P, L, ...]`` shards."""
    arr = np.asarray(arr)
    n_pad = pg.padded_num_nodes
    pad_width = [(0, n_pad - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    padded = np.pad(arr, pad_width)
    return padded.reshape((pg.num_parts, pg.nodes_per_part) + arr.shape[1:])


def shard_partitioned_graph(
    pg: PartitionedGraph,
    mesh: DeviceMesh,
    *,
    x,
    y=None,
    masks: dict[str, Any] | None = None,
    axis: str = "graph",
    halo_plan=None,
    kernel_plan=None,
    attend_plan=None,
) -> dict[str, Any]:
    """This rank's shard of the node data, edges and plans, on its device.

    The rank's part is its coordinate on ``axis``. Returns a dict: ``x``,
    ``senders``, ``receivers``, ``edge_weight``, ``edge_mask``,
    ``node_mask`` (all ``[L, ...]`` or ``[E]``), plus ``y`` and each of
    ``masks`` when given (mask values are combined with the partition's
    node validity, so padded nodes never enter the loss or the metrics).
    With ``halo_plan`` the senders are the plan's table-local ids and
    ``send_idx`` is added; with ``kernel_plan`` the rank's
    ``KernelShard`` under ``kp``; with ``attend_plan`` its ``AttendShard``
    under ``ap``.
    """
    part = mesh.get_local_rank(axis)
    device = local_device(mesh)

    def put(arr):
        return torch.from_numpy(np.ascontiguousarray(arr[part])).to(device)

    edge_weight = (
        pg.edge_weight
        if pg.edge_weight is not None
        else np.ones_like(pg.edge_mask, dtype=np.float32)
    )
    senders = (
        halo_plan.senders_local if halo_plan is not None else pg.senders_global
    )
    out: dict[str, Any] = {
        "x": put(_node_shards(x, pg)),
        "senders": put(senders),
        "receivers": put(pg.receivers_local),
        "edge_mask": put(pg.edge_mask),
        "edge_weight": put(edge_weight),
        "node_mask": put(pg.node_mask),
    }
    if halo_plan is not None:
        out["send_idx"] = put(halo_plan.send_idx)
    if kernel_plan is not None:
        from .kernel_plan import plan_device_data

        out["kp"] = plan_device_data(kernel_plan, part, device)
    if attend_plan is not None:
        from .attend_plan import plan_device_data as attend_device_data

        out["ap"] = attend_device_data(attend_plan, part, device)
    if y is not None:
        out["y"] = put(_node_shards(y, pg))
    for name, m in (masks or {}).items():
        out[name] = put(_node_shards(np.asarray(m), pg) & pg.node_mask)
    return out


def distributed_gcn_encoder(hidden_dims, **kwargs) -> GNNEncoder:
    """A ``GNNEncoder`` configured for distributed execution (self-loops and
    GCN normalization folded into the partition)."""
    conv_kwargs = (("add_self_loops", False), ("normalize", False))
    return GNNEncoder("gcn", tuple(hidden_dims), conv_kwargs=conv_kwargs,
                      **kwargs)


class _SumOverRanks(torch.autograd.Function):
    """``all_reduce``-sum of a tensor over ``group`` with an identity
    backward: each rank's backward then gives the gradient of its own terms,
    and the one sum of the parameters' gradients adds them up."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def _sum_gradients(params, group) -> None:
    """Sum every parameter's gradient over ``group`` in one flat
    ``all_reduce`` (a parameter without a gradient contributes zeros, so
    every rank sends the same layout)."""
    params = list(params)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    offset = 0
    for p, g in zip(params, grads):
        n = g.numel()
        p.grad = flat[offset:offset + n].view_as(g)
        offset += n


class _LocalForward(nn.Module):
    """The per-rank encoder body as a module, so that ``functional_call``
    can hand the bodies per-step parameter copies in the compute type.

    The data dict picks the body: the kernelized one where it holds a
    kernel shard (``kp``, and ``ap`` for GATv2 layers), else the library
    one, over the halo exchange where it holds ``send_idx`` (its senders are
    then table-local ids), over the all-gather otherwise."""

    def __init__(self, encoder):
        super().__init__()
        self.encoder = encoder

    def forward(self, data, x, weight_dtype, group, generator):
        if "kp" in data:
            return encoder_apply_local_kernelized(
                self.encoder, x, data["kp"], data.get("ap"), group=group,
                generator=generator)
        w = data["edge_weight"]
        if weight_dtype is not None:
            w = w.to(weight_dtype)
        return encoder_apply_local(
            self.encoder, x, data["senders"], data["receivers"], w,
            data["edge_mask"], group=group, generator=generator,
            halo_send_idx=data.get("send_idx"))


def _local_logits(body, data, group, compute_dtype, generator):
    x = data["x"]
    if compute_dtype is None:
        return body(data, x, None, group, generator)
    # bf16 IO / f32 master parameters: the cast is part of the graph, so the
    # gradients arrive at (and the optimizer updates) the f32 masters.
    params = {name: p.to(compute_dtype) if p.is_floating_point() else p
              for name, p in body.named_parameters()}
    logits = functional_call(
        body, params, (data, x.to(compute_dtype), compute_dtype, group,
                       generator))
    return logits.float()


def make_distributed_train_step(
    encoder: nn.Module,
    optimizer: torch.optim.Optimizer,
    mesh: DeviceMesh,
    *,
    axis: str = "graph",
    compute_dtype: torch.dtype | None = None,
    generator: torch.Generator | None = None,
) -> Callable:
    """Build ``step(data) -> loss``: one optimizer step of every rank.

    ``data`` is this rank's :func:`shard_partitioned_graph` dict, with ``y``
    and a ``train_mask``; what it was sharded with picks the body. With a
    kernel plan (and an attend plan for GATv2 layers) the rank runs the
    kernelized bodies, the halo all-to-all overlapped against local
    aggregation; with a halo plan, the library bodies over the halo
    exchange; with neither, the library bodies over the all-gather. (The
    reference's ``halo``, ``kernel_plan`` and ``attend_plan`` options say
    the same thing a second time; here the data says it once.)
    ``compute_dtype=torch.bfloat16``: activations, edge weights and the
    per-step parameter copies in bf16, master parameters, loss and gradients
    in f32 (``training.make_node_classification_step``'s policy).
    ``generator``: the rank's random stream (seed it per rank). Every rank
    must call the step; it returns the global mean loss, a detached 0-dim
    tensor on the rank's device (no host synchronisation).
    """
    group = mesh.get_group(axis)
    body = _LocalForward(encoder)

    def step(data):
        encoder.train()
        optimizer.zero_grad(set_to_none=True)
        logits = _local_logits(body, data, group, compute_dtype, generator)
        nll = label_nll(torch.log_softmax(logits, dim=-1), data["y"])
        m = data["train_mask"].to(nll.dtype)
        total = _SumOverRanks.apply(torch.stack([(nll * m).sum(), m.sum()]),
                                    group)
        loss = total[0] / total[1].clamp_min(1.0)
        loss.backward()
        _sum_gradients(encoder.parameters(), group)
        optimizer.step()
        return loss.detach()

    return step


def make_distributed_eval_fn(
    encoder: nn.Module,
    mesh: DeviceMesh,
    *,
    axis: str = "graph",
    compute_dtype: torch.dtype | None = None,
) -> Callable:
    """Build ``evaluate(data, mask) -> accuracy``: the masked accuracy over
    every rank's nodes (``mask``: this rank's ``[L]`` shard), in ``eval()``
    mode, on the body that ``data`` picks (as for
    :func:`make_distributed_train_step`); ``compute_dtype`` as there."""
    group = mesh.get_group(axis)
    body = _LocalForward(encoder)

    @torch.no_grad()
    def evaluate(data, mask):
        encoder.eval()
        logits = _local_logits(body, data, group, compute_dtype, None)
        m = mask.to(torch.float32)
        hit = (logits.argmax(dim=-1) == data["y"]).to(torch.float32) * m
        total = torch.stack([hit.sum(), m.sum()])
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return total[0] / total[1].clamp_min(1.0)

    return evaluate
