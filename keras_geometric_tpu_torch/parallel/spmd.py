"""Per-rank layer bodies for edge-partitioned full-graph execution.

Counterpart of the JAX package's ``parallel/spmd.py``. Each function here is
what one rank runs on its shard of a 1-D ``graph`` mesh (where the reference
runs the same body inside ``shard_map``). The pattern for every conv family:

1. transform the rank's node shard (dense matmul, no communication);
2. gather the transformed shard from every rank (an all-gather, tiled) or
   exchange the halo rows (``halo_send_idx``) into the rank's feature table;
   gathering *after* the transform moves ``N * F_out`` values instead of
   ``N * F_in`` whenever the layer shrinks features;
3. gather sender rows from the table, compute per-edge messages;
4. reduce into the rank's receiver range, purely locally, because edges are
   partitioned by receiver (``partition.py``): even GATv2's per-receiver
   softmax needs no cross-rank pass.

Gradients flow back through the collectives (the all-gather's transpose is a
reduce-scatter; ``halo.py``).

Two tiers, as in the reference: the *library* bodies (``*_apply_local``) run
``ops/segment``'s library ops; the *kernelized* ones
(``*_apply_local_kernelized``) run the hand-written kernels over a kernel
plan's overlapped streams (``kernel_plan.py``) and an attend plan's table
(``attend_plan.py``). Where a layer has no kernelized path (the GraphSAGE
``std`` aggregator; GATv2 without an attend plan) the kernelized body falls
back to the library reduction over the same plan's streams and halo
exchange, with a warning the first time, as the reference does;
:data:`FALLBACK_COUNTS` counts every such call.

Graph-structure preprocessing (self-loops, GCN normalization) happens once
at partition time (``partition_graph(gcn_normalize=True,
add_self_loops=True)``): the layers must be built with those flags off, and
raise otherwise. Layers read their own training mode (``train()`` /
``eval()``) and parameters; randomness comes from the ``generator`` passed
in (each rank its own).
"""

from __future__ import annotations

import warnings

import torch

from ..nn.aggregators import aggregate
from ..nn.gatv2_conv import GATv2Conv
from ..nn.gcn_conv import GCNConv
from ..nn.gin_conv import GINConv
from ..nn.module import dropout, get_activation
from ..nn.sage_conv import SAGEConv
from ..ops.edge_dropout import keep_mask_at
from ..ops.segment import segment_max, segment_softmax, segment_sum
from .halo import all_gather_rows, exchange

__all__ = [
    "gcn_apply_local",
    "gin_apply_local",
    "gatv2_apply_local",
    "sage_apply_local",
    "encoder_apply_local",
    "gcn_apply_local_kernelized",
    "gin_apply_local_kernelized",
    "sage_apply_local_kernelized",
    "gatv2_apply_local_kernelized",
    "gatv2_apply_local_kp_fallback",
    "encoder_apply_local_kernelized",
    "FALLBACK_COUNTS",
]

# Calls of the kernelized bodies' library fallbacks, by kind.
FALLBACK_COUNTS = {"kp_xla_edges": 0, "gatv2_kp_fallback": 0}


def _gather_full(h_local, group, halo_send_idx=None):
    """The rank's sender feature table: the tiled all-gather of the shards
    (``[P*L, F]``; senders are global ids), or with ``halo_send_idx`` (a
    ``[P, H]`` send table) the halo exchange's ``[L + P*H, F]`` table
    (senders must be the plan-remapped local ids)."""
    if halo_send_idx is not None:
        return exchange(h_local, halo_send_idx, group=group)
    return all_gather_rows(h_local, group)


def _check_gcn_flags(layer):
    if layer.add_self_loops or layer.normalize:
        raise ValueError(
            "Distributed GCNConv expects add_self_loops/normalize handled at "
            "partition time; construct the layer with both flags False.")


def _check_gatv2_flags(layer):
    if layer.add_self_loops:
        raise ValueError(
            "Distributed GATv2Conv expects self-loops added at partition "
            "time; construct the layer with add_self_loops=False.")


def gcn_apply_local(layer: GCNConv, x_local, senders, receivers, edge_weight,
                    edge_mask, *, group, generator=None, halo_send_idx=None):
    """GCN forward on one rank's node/edge shard (normalization and
    self-loops folded into the partition)."""
    _check_gcn_flags(layer)
    h_local = x_local @ layer.kernel
    h_full = _gather_full(h_local, group, halo_send_idx)
    messages = h_full.index_select(0, senders.long())
    if edge_weight is not None:
        messages = messages * edge_weight[:, None].to(messages.dtype)
    messages = dropout(messages, layer.dropout_rate, layer.training,
                       generator)
    out = segment_sum(messages, receivers, x_local.shape[0], mask=edge_mask)
    if layer.bias is not None:
        out = out + layer.bias
    return out


def _gin_combine(layer, x_local, agg, generator):
    eps = layer.eps if layer.train_eps else layer.eps_init
    return layer.mlp((1 + eps) * x_local + agg, generator=generator)


def gin_apply_local(layer: GINConv, x_local, senders, receivers, edge_mask,
                    *, group, generator=None, halo_send_idx=None):
    x_full = _gather_full(x_local, group, halo_send_idx)
    messages = x_full.index_select(0, senders.long())
    agg = aggregate(layer.aggregator, messages, receivers, x_local.shape[0],
                    mask=edge_mask, indices_are_sorted=True)
    return _gin_combine(layer, x_local, agg, generator)


def _attention_dropout(layer, alpha, generator):
    if not (layer.training and layer.dropout > 0):
        return alpha
    return alpha * keep_mask_at(
        generator, None, layer.heads, layer.dropout, alpha.dtype,
        num_edges=alpha.shape[0], device=alpha.device)


def _gatv2_edges(layer, ht_local, h_j, receivers, mask, generator):
    """Scores, softmax, attention dropout and aggregation of GATv2 over one
    rank's edges (``h_j``: gathered sender rows)."""
    n = ht_local.shape[0]
    h, f = layer.heads, layer.output_dim
    h_j = h_j.reshape(-1, h, f)
    h_i = ht_local.index_select(0, receivers.long()).reshape(-1, h, f)
    z = torch.nn.functional.leaky_relu(h_i + h_j, layer.negative_slope)
    scores = (z * layer.att).sum(dim=-1)  # [E, H]
    alpha = segment_softmax(scores, receivers, n, mask=mask, eps=1e-10)
    alpha = _attention_dropout(layer, alpha, generator)
    messages = (alpha[:, :, None] * h_j).reshape(-1, h * f)
    agg = segment_sum(messages, receivers, n, mask=mask).reshape(n, h, f)
    return layer._merge_heads(agg)


def gatv2_apply_local(layer: GATv2Conv, x_local, senders, receivers,
                      edge_mask, *, group, generator=None,
                      halo_send_idx=None):
    """GATv2 forward on one rank. The per-receiver softmax is local because
    edges are partitioned by receiver."""
    _check_gatv2_flags(layer)
    ht_local = x_local @ layer.kernel
    ht_full = _gather_full(ht_local, group, halo_send_idx)
    h_j = ht_full.index_select(0, senders.long())
    return _gatv2_edges(layer, ht_local, h_j, receivers, edge_mask, generator)


def _sage_finish(layer, x_local, agg, generator):
    out = layer.lin_neigh(agg)
    if layer.root_weight:
        out = out + layer.lin_self(dropout(
            x_local, layer.dropout_rate, layer.training, generator))
    if layer.bias is not None:
        out = out + layer.bias
    out = get_activation(layer.activation)(out)
    if layer.normalize:
        norm = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
        out = out / norm.clamp_min(1e-12)
    return out


def sage_apply_local(layer: SAGEConv, x_local, senders, receivers, edge_mask,
                     *, group, generator=None, halo_send_idx=None):
    num_local = x_local.shape[0]
    x_full = _gather_full(x_local, group, halo_send_idx)
    messages = dropout(x_full.index_select(0, senders.long()),
                       layer.dropout_rate, layer.training, generator)
    if layer.aggregator == "pooling":
        agg = segment_max(layer.pool_mlp(messages), receivers, num_local,
                          mask=edge_mask, indices_are_sorted=True)
    else:
        agg = aggregate(layer.aggregator, messages, receivers, num_local,
                        mask=edge_mask, indices_are_sorted=True)
    return _sage_finish(layer, x_local, agg, generator)


def _between_layers(encoder, i, h, generator):
    if i < encoder.num_layers - 1:
        h = get_activation(encoder.activation)(h)
        h = dropout(h, encoder.dropout_rate, encoder.training, generator)
    return h


def encoder_apply_local(encoder, x_local, senders, receivers, edge_weight,
                        edge_mask, *, group, generator=None,
                        halo_send_idx=None):
    """Per-rank forward of a ``GNNEncoder`` stack on the library bodies.
    With ``halo_send_idx``, ``senders`` must be the plan-remapped local
    sender ids (``HaloPlan.senders_local``)."""
    h = x_local
    common = dict(group=group, generator=generator,
                  halo_send_idx=halo_send_idx)
    for i, layer in enumerate(encoder.layers()):
        if isinstance(layer, GCNConv):
            h = gcn_apply_local(layer, h, senders, receivers, edge_weight,
                                edge_mask, **common)
        elif isinstance(layer, GINConv):
            h = gin_apply_local(layer, h, senders, receivers, edge_mask,
                                **common)
        elif isinstance(layer, GATv2Conv):
            h = gatv2_apply_local(layer, h, senders, receivers, edge_mask,
                                  **common)
        elif isinstance(layer, SAGEConv):
            h = sage_apply_local(layer, h, senders, receivers, edge_mask,
                                 **common)
        else:
            raise TypeError(f"Unsupported layer type: {type(layer)}")
        h = _between_layers(encoder, i, h, generator)
    if encoder.final_activation is not None:
        h = get_activation(encoder.final_activation)(h)
    return h


# ---------------------------------------------------------------------------
# The kernelized bodies.
# ---------------------------------------------------------------------------

_warned: set = set()


def _warn_once(key: str, msg: str) -> None:
    if key not in _warned:
        _warned.add(key)
        warnings.warn(msg, stacklevel=3)


def _kp_xla_edges(x_local, kp, group):
    """The library view of a kernel plan's edges (the fallback): the halo
    exchange rides the plan's send table, and the two streams' messages,
    receivers and validity are concatenated for one segment reduction."""
    FALLBACK_COUNTS["kp_xla_edges"] += 1
    n = x_local.shape[0]
    table = exchange(x_local, kp.send_idx, group=group)
    msgs = torch.cat([x_local.index_select(0, kp.loc.senders),
                      table[n:].index_select(0, kp.rem.senders)])
    receivers = torch.cat([kp.loc.receivers, kp.rem.receivers])
    mask = torch.cat([kp.loc.valid, kp.rem.valid])
    return msgs, receivers, mask


def _edge_keep_scales(kp, rate, dtype, generator):
    """Per-edge (not per-element) pre-scaled keep masks of both streams:
    dropout commutes with the fused elementwise weights, and padded slots
    have weight 0 anyway."""
    keep = 1.0 - rate
    out = {}
    for prefix, st in (("loc", kp.loc), ("rem", kp.rem)):
        u = torch.rand(st.senders.shape[0], generator=generator,
                       device=st.senders.device)
        out[prefix] = torch.where(u < keep, 1.0 / keep, 0.0).to(dtype)
    return out


def _mean_of(agg, kp):
    return agg / kp.in_degree.clamp_min(1e-8).to(agg.dtype)[:, None]


def gcn_apply_local_kernelized(layer: GCNConv, x_local, kp, *, group,
                               generator=None):
    """GCN forward on one rank through the overlapped fused-gather scatter
    (``kernel_plan.spmm_local_overlapped``); normalization weights ride the
    plan. Message dropout in ``train()`` mode: per-edge keep masks (the
    messages-form path)."""
    from .kernel_plan import spmm_local_overlapped

    _check_gcn_flags(layer)
    h = x_local @ layer.kernel
    scale = None
    if layer.training and layer.dropout_rate > 0:
        scale = _edge_keep_scales(kp, layer.dropout_rate, h.dtype, generator)
    out = spmm_local_overlapped(h, kp, group=group, message_scale=scale)
    if layer.bias is not None:
        out = out + layer.bias
    return out


def gin_apply_local_kernelized(layer: GINConv, x_local, kp, *, group,
                               generator=None):
    """GIN forward on one rank: sum and mean through the overlapped spmm
    (unit weights), max through the overlapped segment max
    (``kernel_plan.pooled_max_local``)."""
    from .kernel_plan import pooled_max_local, spmm_local_overlapped

    if layer.aggregator in ("sum", "mean"):
        agg = spmm_local_overlapped(x_local, kp, group=group,
                                    unit_weights=True)
        if layer.aggregator == "mean":
            agg = _mean_of(agg, kp)
    elif layer.aggregator == "max":
        agg = pooled_max_local(x_local, kp, lambda m: m, group=group)
    else:
        _warn_once(
            f"gin-{layer.aggregator}",
            f"GINConv(aggregator={layer.aggregator!r}) has no kernelized "
            "distributed path; falling back to the library segment "
            "reduction (same halo plan, slower).")
        msgs, receivers, mask = _kp_xla_edges(x_local, kp, group)
        agg = aggregate(layer.aggregator, msgs, receivers, kp.nodes_per_part,
                        mask=mask)
    return _gin_combine(layer, x_local, agg, generator)


def sage_apply_local_kernelized(layer: SAGEConv, x_local, kp, *, group,
                                generator=None):
    """GraphSAGE forward on one rank: sum and mean through the overlapped
    spmm (unit weights), max / min / pooling through the overlapped segment
    max; message dropout per edge on those paths. ``std`` falls back to the
    library reduction (per-element message dropout, as the library body)."""
    from .kernel_plan import pooled_max_local, spmm_local_overlapped

    drop = layer.training and layer.dropout_rate > 0
    if layer.aggregator in ("sum", "mean", "max", "min", "pooling"):
        scale = None
        if drop:
            scale = _edge_keep_scales(kp, layer.dropout_rate, x_local.dtype,
                                      generator)
        if layer.aggregator in ("sum", "mean"):
            agg = spmm_local_overlapped(x_local, kp, group=group,
                                        unit_weights=True,
                                        message_scale=scale)
            if layer.aggregator == "mean":
                agg = _mean_of(agg, kp)
        else:
            if layer.aggregator == "pooling":
                apply_mlp = layer.pool_mlp
            elif layer.aggregator == "max":
                apply_mlp = lambda m: m  # noqa: E731
            else:
                apply_mlp = torch.neg
            agg = pooled_max_local(x_local, kp, apply_mlp, group=group,
                                   message_scale=scale)
            if layer.aggregator == "min":  # min = -max(-x), empty rows 0
                agg = -agg
    else:
        _warn_once(
            f"sage-{layer.aggregator}",
            f"SAGEConv(aggregator={layer.aggregator!r}) has no kernelized "
            "distributed path; falling back to the library segment "
            "reduction (same halo plan, slower).")
        msgs, receivers, mask = _kp_xla_edges(x_local, kp, group)
        msgs = dropout(msgs, layer.dropout_rate, layer.training, generator)
        agg = aggregate(layer.aggregator, msgs, receivers, kp.nodes_per_part,
                        mask=mask)
    return _sage_finish(layer, x_local, agg, generator)


def gatv2_apply_local_kernelized(layer: GATv2Conv, x_local, ap, *, group,
                                 generator=None):
    """GATv2 forward on one rank through the fused attention kernels over
    the attend plan's table (``attend_plan.attend_local``)."""
    from .attend_plan import attend_local

    _check_gatv2_flags(layer)
    n = x_local.shape[0]
    h, f = layer.heads, layer.output_dim
    agg = attend_local(
        x_local @ layer.kernel, layer.att.reshape(h, f), ap, group=group,
        negative_slope=layer.negative_slope,
        dropout=layer.dropout if layer.training else 0.0,
        generator=generator)
    return layer._merge_heads(agg.reshape(n, h, f))


def gatv2_apply_local_kp_fallback(layer: GATv2Conv, x_local, kp, *, group,
                                  generator=None):
    """GATv2 on kernel-plan data without an attend plan: the library
    segment-softmax body over the plan's two streams."""
    FALLBACK_COUNTS["gatv2_kp_fallback"] += 1
    _check_gatv2_flags(layer)
    ht_local = x_local @ layer.kernel
    h_j, receivers, mask = _kp_xla_edges(ht_local, kp, group)
    return _gatv2_edges(layer, ht_local, h_j, receivers, mask, generator)


def encoder_apply_local_kernelized(encoder, x_local, kp, ap=None, *, group,
                                   generator=None):
    """Per-rank forward of a ``GNNEncoder`` stack on the kernelized path
    (GCN, GIN, GraphSAGE, GATv2). ``kp``: the rank's ``KernelShard``;
    GATv2 layers also need ``ap``, its ``AttendShard``
    (``shard_partitioned_graph(attend_plan=...)``), or take the library
    fallback with a warning."""
    h = x_local
    common = dict(group=group, generator=generator)
    for i, layer in enumerate(encoder.layers()):
        if isinstance(layer, GCNConv):
            h = gcn_apply_local_kernelized(layer, h, kp, **common)
        elif isinstance(layer, GINConv):
            h = gin_apply_local_kernelized(layer, h, kp, **common)
        elif isinstance(layer, SAGEConv):
            h = sage_apply_local_kernelized(layer, h, kp, **common)
        elif isinstance(layer, GATv2Conv):
            if ap is None:
                _warn_once(
                    "gatv2-no-ap",
                    "GATv2Conv on the kernelized distributed path without "
                    "an attend plan (build_attend_plan, passed to "
                    "shard_partitioned_graph); falling back to the library segment-softmax "
                    "body over the kernel plan's halo exchange (slower).")
                h = gatv2_apply_local_kp_fallback(layer, h, kp, **common)
            else:
                h = gatv2_apply_local_kernelized(layer, h, ap, **common)
        else:
            raise TypeError(f"Unsupported layer type: {type(layer)}")
        h = _between_layers(encoder, i, h, generator)
    if encoder.final_activation is not None:
        h = get_activation(encoder.final_activation)(h)
    return h
