"""Tensor (feature-dim and head) model parallelism for wide GNN layers, on
``torch.distributed``.

Counterpart of the JAX package's ``parallel/tensor_parallel.py``: the weights
of a layer pair are sharded over a ``model`` mesh axis in the Megatron
column / row pattern. Graph aggregation is feature-wise independent, so a
feature-sharded activation passes through gather, scatter and segment ops
with no communication; a collective appears only where the math contracts
over the feature dimension (a row-parallel product's sum) or merges heads.

Layout (per layer pair):

1. column-parallel: ``h_shard = x @ W1[:, shard]``, output features sharded,
   no communication;
2. graph aggregation on the shard (``ops/segment``), no communication;
3. row-parallel: ``out = sum_model(h_shard @ W2[shard, :]) + b``, one
   ``all_reduce`` over the model group re-materialises the whole output.

Each function is what one rank runs (the reference runs the same body inside
``shard_map``); a body takes ``group=`` where the reference takes ``axis=``,
and the 2-D bodies ``graph_group=`` / ``model_group=`` for ``graph_axis=`` /
``model_axis=`` (a mesh ``(graph, model)`` from ``make_mesh``: nodes
partitioned over ``graph`` by ``partition_graph``, features or heads over
``model``).

Gradients (explicit ``torch.autograd.Function``s, where ``shard_map``
transposes the collectives). Every rank of a model group holds the same
replicated output, so its cotangent is already whole on each of them:

- the row-parallel sum and the head mean's sum take an identity backward
  (``distributed._SumOverRanks``); ``torch.distributed.nn``'s ``all_reduce``
  would sum the cotangent again, T times the gradient;
- the head merge's all-gather takes the rank's own block of the cotangent;
  a reduce-scatter (the graph axis's transpose, ``halo.all_gather_rows``)
  would also give T times the gradient;
- the input of a column-parallel product is replicated over the model
  group, each rank contributing the part of its gradient that flows through
  its shard: the parts are summed over the group (an identity forward and an
  ``all_reduce`` backward, Megatron's "f"), where a caller passes ``group=``
  to :func:`column_parallel_dense` (the blocks do).

A replicated parameter (the row-parallel bias, a head-mean bias) thus gets
its whole gradient on every rank, as each rank's optimizer needs to keep the
copies equal; the reference's stacked copies each get ``1/T`` of it
(ROADMAP D18). On a 2-D mesh each rank's loss covers its own rows: sum the
parameters' gradients over the graph group only.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..ops.segment import segment_softmax, segment_sum
from .distributed import _SumOverRanks
from .halo import _quiet, all_gather_rows

__all__ = [
    "column_parallel_dense",
    "row_parallel_dense",
    "shard_params_tp",
    "shard_params_gatv2_tp",
    "tp_gcn_block_local",
    "tp_graph_gcn_block_local",
    "tp_gatv2_block_local",
    "tp_graph_gatv2_block_local",
]


class _SumGradOverRanks(torch.autograd.Function):
    """Identity forward; backward: the cotangent summed over ``group``
    (Megatron's "f", for an input replicated over the group)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


class _GatherBlocks(torch.autograd.Function):
    """Tiled all-gather along ``dim`` over ``group`` in group-rank order
    (shard-major); backward: the rank's own block of the cotangent."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.block = dim, x.shape[dim]
        ctx.rank = dist.get_rank(group)
        moved = x.movedim(dim, 0).contiguous()
        size = dist.get_world_size(group)
        out = moved.new_empty((size * moved.shape[0],) + moved.shape[1:])
        _quiet(dist.all_gather_into_tensor, out, moved, group=group)
        return out.movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        block = g.narrow(ctx.dim, ctx.rank * ctx.block, ctx.block)
        return block.contiguous(), None, None


def column_parallel_dense(
    x: torch.Tensor, kernel_shard: torch.Tensor,
    bias_shard: torch.Tensor | None = None, *, group=None,
) -> torch.Tensor:
    """``[.., F_in] @ [F_in, F_out/T] -> [.., F_out/T]``: no collective in
    the forward; outputs stay feature-sharded over the model axis.

    ``group``: the model group over which ``x`` is replicated; ``x``'s
    gradient is then summed over it (needed wherever ``x`` requires one).
    """
    if group is not None:
        x = _SumGradOverRanks.apply(x, group)
    out = x @ kernel_shard
    if bias_shard is not None:
        out = out + bias_shard
    return out


def row_parallel_dense(
    x_shard: torch.Tensor, kernel_shard: torch.Tensor,
    bias: torch.Tensor | None = None, *, group,
) -> torch.Tensor:
    """``[.., F_in/T] @ [F_in/T, F_out] -> sum over the model group ->
    [.., F_out]``.

    One ``all_reduce`` over ``group`` (identity backward) completes the
    contraction over the sharded input dim; ``bias`` is replicated and added
    after it.
    """
    out = _SumOverRanks.apply(x_shard @ kernel_shard, group)
    if bias is not None:
        out = out + bias
    return out


def _divides(total: int, num_shards: int, what: str) -> None:
    if total % num_shards:
        raise ValueError(f"{what} must divide the model axis: {total} over "
                         f"{num_shards} shards")


def shard_params_tp(params: dict, num_shards: int) -> list[dict]:
    """Host-side: split a 2-layer dense param dict into per-shard pieces.

    ``layer_0.kernel [F_in, H]`` splits column-wise, ``layer_1.kernel
    [H, F_out]`` row-wise; ``layer_0.bias`` splits with its columns,
    ``layer_1.bias`` is replicated. numpy in, numpy out (the reference's
    arrays bit for bit); shard ``t`` is what model rank ``t`` holds.
    """
    k0 = np.asarray(params["layer_0"]["kernel"])
    k1 = np.asarray(params["layer_1"]["kernel"])
    h = k0.shape[1]
    _divides(h, num_shards, "hidden dim")
    s = h // num_shards
    shards = []
    for t in range(num_shards):
        p = {
            "layer_0": {"kernel": k0[:, t * s: (t + 1) * s]},
            "layer_1": {"kernel": k1[t * s: (t + 1) * s, :]},
        }
        if "bias" in params["layer_0"]:
            p["layer_0"]["bias"] = np.asarray(
                params["layer_0"]["bias"])[t * s: (t + 1) * s]
        if "bias" in params["layer_1"]:
            p["layer_1"]["bias"] = np.asarray(params["layer_1"]["bias"])
        shards.append(p)
    return shards


def shard_params_gatv2_tp(params: dict, num_shards: int) -> list[dict]:
    """Host-side: split GATv2Conv params head-wise for the model axis.

    Attention heads are independent through score, softmax and aggregate,
    so the ``[H]`` axis shards: ``kernel [F_in, H*F]`` by head group
    (contiguous heads per shard, the concat order), ``att`` (``[H, F]`` or
    the layer's ``[1, H, F]``) by rows; a concat ``bias [H*F]`` splits with
    its heads, a mean-mode ``bias [F]`` is replicated. numpy in, numpy out
    (the reference's arrays bit for bit).
    """
    k = np.asarray(params["kernel"])
    att = np.asarray(params["att"])
    att = att.reshape(-1, att.shape[-1])  # the layer stores (1, H, F)
    heads, f = att.shape
    _divides(heads, num_shards, "heads")
    hs = heads // num_shards
    k3 = k.reshape(k.shape[0], heads, f)
    shards = []
    for t in range(num_shards):
        p = {
            "kernel": k3[:, t * hs: (t + 1) * hs, :].reshape(
                k.shape[0], hs * f),
            "att": att[t * hs: (t + 1) * hs],
        }
        if "bias" in params:
            b = np.asarray(params["bias"])
            if b.shape[0] == heads * f:  # concat mode
                p["bias"] = b.reshape(heads, f)[
                    t * hs: (t + 1) * hs].reshape(hs * f)
            else:  # mean mode: replicated, added after the sum
                p["bias"] = b
        shards.append(p)
    return shards


def tp_gcn_block_local(
    p_shard: dict,
    x: torch.Tensor,
    senders: torch.Tensor,
    receivers: torch.Tensor,
    edge_weight: torch.Tensor,
    edge_mask: torch.Tensor,
    *,
    group,
    activation=torch.relu,
) -> torch.Tensor:
    """Per-rank body of a 2-layer tensor-parallel GCN block (model axis
    only; ``x`` and the edges replicated).

    ``W1`` column-parallel -> per-shard GCN propagate (feature-wise
    independent: no communication) -> ``b0`` -> activation -> per-shard
    propagate of layer 2's input -> ``W2`` row-parallel (one sum over
    ``group``). Equal to the unsharded 2-layer GCN block with the same
    weights, up to the order of the f32 sums.
    """
    n = x.shape[0]
    senders = senders.long()

    def propagate(h):
        msgs = h.index_select(0, senders) * edge_weight[:, None]
        return segment_sum(msgs, receivers, n, mask=edge_mask)

    return _gcn_pair(p_shard, x, propagate, group, activation)


def tp_graph_gcn_block_local(
    p_shard: dict,
    x_local: torch.Tensor,
    senders_global: torch.Tensor,
    receivers_local: torch.Tensor,
    edge_weight: torch.Tensor,
    edge_mask: torch.Tensor,
    *,
    graph_group,
    model_group,
    activation=torch.relu,
) -> torch.Tensor:
    """Per-rank body of a 2-layer GCN block on a 2-D ``(graph, model)``
    mesh: nodes partitioned over ``graph`` (receiver ranges,
    ``partition_graph``; the rank's ``[L]`` rows and ``[E]`` edges),
    features over ``model``.

    The sender table is the all-gather over ``graph_group`` of the
    FEATURE-SHARDED activations, ``N * F/T`` values a rank where the
    unsharded exchange moves ``N * F``: tensor parallelism divides the graph
    axis's collective. The aggregation needs nothing of ``model``; the one
    model-axis collective is the row-parallel sum.
    """
    num_local = x_local.shape[0]
    senders_global = senders_global.long()

    def propagate(h_local):
        h_full = all_gather_rows(h_local, graph_group)  # [N, F/T]
        msgs = h_full.index_select(0, senders_global) * edge_weight[:, None]
        return segment_sum(msgs, receivers_local, num_local, mask=edge_mask,
                           indices_are_sorted=True)

    return _gcn_pair(p_shard, x_local, propagate, model_group, activation)


def _gcn_pair(p_shard, x, propagate, model_group, activation):
    h = column_parallel_dense(x, p_shard["layer_0"]["kernel"],
                              group=model_group)
    h = propagate(h)  # feature-sharded: no model-axis collective
    b0 = p_shard["layer_0"].get("bias")
    if b0 is not None:
        h = h + b0  # GCN adds its bias after aggregation
    h = activation(h)
    h = propagate(h)  # layer 2 propagates its input shard
    return row_parallel_dense(
        h, p_shard["layer_1"]["kernel"], p_shard["layer_1"].get("bias"),
        group=model_group)


def _gatv2_head_shard(ht, att_shard, senders, receivers, edge_mask, n,
                      negative_slope, eps, ht_recv=None):
    """GATv2 attention over this shard's heads only (score -> max-shifted
    segment softmax -> weighted aggregate), with no model-axis collective.
    ``ht_recv`` (default ``ht``) is the receiver-side table: under graph
    partitioning the senders index the gathered table, the receivers the
    rank's own rows."""
    if ht_recv is None:
        ht_recv = ht
    hs, f = att_shard.shape
    hj = ht.index_select(0, senders.long()).reshape(-1, hs, f)
    hi = ht_recv.index_select(0, receivers.long()).reshape(-1, hs, f)
    pre = hi + hj
    z = torch.where(pre > 0, pre, negative_slope * pre)
    scores = torch.einsum("ehf,hf->eh", z, att_shard)
    alpha = segment_softmax(scores, receivers, n, mask=edge_mask, eps=eps)
    msgs = (alpha[:, :, None] * hj).reshape(-1, hs * f)
    return segment_sum(msgs, receivers, n, mask=edge_mask)


def _merge_heads(p_shard, agg, model_group, concat, heads_total):
    """The one model-axis collective of a head-sharded layer: the heads'
    all-gather (concat; the head-sharded bias gathered the same way) or
    their sum over the group over ``heads_total`` (mean; the bias
    replicated)."""
    hs, f = p_shard["att"].shape
    n = agg.shape[0]
    bias = p_shard.get("bias")
    if concat:
        out = _GatherBlocks.apply(agg.reshape(n, hs, f), 1, model_group)
        out = out.reshape(n, -1)  # shard-major == the unsharded head order
        if bias is not None:
            out = out + _GatherBlocks.apply(bias.reshape(hs, f), 0,
                                            model_group).reshape(-1)
        return out
    if heads_total is None:
        raise ValueError("heads_total required for mean (concat=False)")
    out = _SumOverRanks.apply(agg.reshape(n, hs, f).sum(dim=1),
                              model_group) / heads_total
    if bias is not None:
        out = out + bias
    return out


def tp_gatv2_block_local(
    p_shard: dict,
    x: torch.Tensor,
    senders: torch.Tensor,
    receivers: torch.Tensor,
    edge_mask: torch.Tensor,
    *,
    group,
    concat: bool = True,
    heads_total: int | None = None,
    negative_slope: float = 0.2,
    eps: float = 1e-10,
) -> torch.Tensor:
    """Per-rank body of a head-sharded GATv2 layer (model axis only).

    ``W`` column-parallel by head group -> per-shard score, softmax and
    aggregate (no communication: the softmax is per (receiver, head)) ->
    ONE model-axis collective at the head merge: an all-gather for the
    concat output (heads re-assembled shard-major, the unsharded order) or a
    sum over ``heads_total`` in head-mean mode. ``p_shard``: one shard of
    :func:`shard_params_gatv2_tp` (``kernel``, ``att`` ``[H/T, F]``,
    ``bias``) as tensors.
    """
    ht = column_parallel_dense(x, p_shard["kernel"], group=group)
    agg = _gatv2_head_shard(ht, p_shard["att"], senders, receivers,
                            edge_mask, x.shape[0], negative_slope, eps)
    return _merge_heads(p_shard, agg, group, concat, heads_total)


def tp_graph_gatv2_block_local(
    p_shard: dict,
    x_local: torch.Tensor,
    senders_global: torch.Tensor,
    receivers_local: torch.Tensor,
    edge_mask: torch.Tensor,
    *,
    graph_group,
    model_group,
    concat: bool = True,
    heads_total: int | None = None,
    negative_slope: float = 0.2,
    eps: float = 1e-10,
) -> torch.Tensor:
    """2-D ``(graph x model)`` head-sharded GATv2: nodes over ``graph``
    (receiver-range partitioning keeps every softmax rank-local), heads over
    ``model``.

    The axes compose as in :func:`tp_graph_gcn_block_local`: the sender
    table's all-gather over ``graph_group`` moves the HEAD-SHARDED ``ht``
    (``N * H*F/T`` values), the attention needs no collective, and the one
    model-axis merge runs on the rank's own rows.
    """
    ht_local = column_parallel_dense(x_local, p_shard["kernel"],
                                     group=model_group)  # [L, hs*F]
    ht_full = all_gather_rows(ht_local, graph_group)  # [N, hs*F]
    agg = _gatv2_head_shard(ht_full, p_shard["att"], senders_global,
                            receivers_local, edge_mask, x_local.shape[0],
                            negative_slope, eps, ht_recv=ht_local)
    return _merge_heads(p_shard, agg, model_group, concat, heads_total)
