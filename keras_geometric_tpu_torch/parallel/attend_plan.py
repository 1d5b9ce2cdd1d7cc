"""Kernelized distributed GATv2 attention: per-rank attend tables.

Counterpart of the JAX package's ``parallel/attend_plan.py``. Receiver-range
partitioning (``partition.py``) keeps every receiver's softmax on its rank,
so the single-device fused attention runs per rank; the only distributed
part is the sender feature table, extended with the halo rows by
``halo.exchange`` (differentiable: its backward returns the halo rows'
cotangents to their owners).

The port's attention kernels take one ``ht`` for sender and receiver rows
(``kernels/attend_cuda.py``), where the reference's take a sender table and
a receiver table apart. So the kernels here run over the exchanged table
``[h_local | halo]`` (``L + P*H`` rows) with row pointers over all of its
rows: the halo rows receive no edge, and the result is sliced to its first
``L`` rows. No kernel's signature changes. Each rank's tables are a
:class:`~..ops.csr.GraphContext` that ``prepare_graph`` builds over the
table's rows from the partition's receiver-sorted edges (its stable sort
keeps their order; :func:`plan_device_data` checks it).

The attention runs in the reference's no-score-cache mode: the forward
kernel (K9) keeps no ``[E, H]`` scores, rho (K10b) and the receiver backward
(K10c) recompute them, and the per-edge sender cotangent is summed by sender
with the fused-gather scatter (K1) over the transposed orientation.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..kernels import attend_cuda, spmm_cuda
from ..ops.csr import GraphContext, prepare_graph
from ..ops.edge_dropout import keep_mask_at
from .halo import HaloPlan, build_halo_plan, exchange
from .partition import PartitionedGraph

__all__ = [
    "AttendPlan",
    "AttendShard",
    "build_attend_plan",
    "plan_device_data",
    "attend_local",
]


class AttendPlan(NamedTuple):
    """Host-side stacked attend arrays (leading axis = partition)."""

    senders: np.ndarray  # [P, E] table-local ids in [0, L + P*H)
    receivers: np.ndarray  # [P, E] local receiver rows, non-decreasing
    edge_valid: np.ndarray  # [P, E] f32 1/0 (receiver order)
    num_real: np.ndarray  # [P] int64 real slots per part
    send_idx: np.ndarray  # [P, P, H]
    halo_size: int
    nodes_per_part: int
    num_source_rows: int  # L + P*H
    edge_chunk: int  # each rank's context pads its stream to this multiple


def build_attend_plan(
    pg: PartitionedGraph,
    *,
    halo_plan: HaloPlan | None = None,
    edge_chunk: int = 512,
    halo_multiple: int = 8,
) -> AttendPlan:
    """Host-side, once: the halo remap of each partition's edges."""
    if halo_plan is None:
        halo_plan = build_halo_plan(pg, halo_multiple=halo_multiple)
    P, L = pg.num_parts, pg.nodes_per_part
    h = halo_plan.halo_size
    e_real = np.array([int(m.sum()) for m in pg.edge_mask], np.int64)
    e_pad = max(int(e_real.max(initial=0)), 1)
    s_out = np.zeros((P, e_pad), np.int32)
    r_out = np.full((P, e_pad), L - 1, np.int32)
    v_out = np.zeros((P, e_pad), np.float32)
    for p in range(P):
        mask = pg.edge_mask[p]
        k = int(e_real[p])
        # Boolean selection preserves the partition's receiver sort.
        s_out[p, :k] = halo_plan.senders_local[p][mask]
        r_out[p, :k] = pg.receivers_local[p][mask]
        v_out[p, :k] = 1.0
    return AttendPlan(
        senders=s_out, receivers=r_out, edge_valid=v_out, num_real=e_real,
        send_idx=halo_plan.send_idx, halo_size=h, nodes_per_part=L,
        num_source_rows=L + P * h, edge_chunk=edge_chunk,
    )


@dataclasses.dataclass
class AttendShard:
    """One rank's attend tables on its device: the context over its table's
    ``L + P*H`` rows, and its ``[P, H]`` send table."""

    context: GraphContext
    send_idx: torch.Tensor
    nodes_per_part: int


def plan_device_data(ap: AttendPlan, part: int, device) -> AttendShard:
    """Partition ``part``'s tables on ``device``."""
    k = int(ap.num_real[part])
    s = ap.senders[part, :k]
    r = ap.receivers[part, :k]
    ctx = prepare_graph(np.stack([s, r]), ap.num_source_rows,
                        edge_chunk=ap.edge_chunk, device=device)
    if not (np.array_equal(ctx.senders[:k].cpu().numpy(), s)
            and np.array_equal(ctx.receivers[:k].cpu().numpy(), r)):
        raise RuntimeError(
            "prepare_graph reordered the partition's receiver-sorted edges")
    return AttendShard(
        context=ctx,
        send_idx=torch.from_numpy(
            np.ascontiguousarray(ap.send_idx[part])).to(device),
        nodes_per_part=ap.nodes_per_part,
    )


class _AttendTable(torch.autograd.Function):
    """The fused attention over the table's stream, without the score cache;
    output rows ``[:L]``. Backward: rho and the receiver backward recomputing
    the scores, then the sender finish (fused-gather scatter) into the whole
    table (the halo rows' part returns through the exchange)."""

    @staticmethod
    def forward(ctx, table, att, graph, num_local, negative_slope, eps,
                drop_mask):
        table, att = table.contiguous(), att.contiguous()
        out, m, l = attend_cuda.sddmm_stats_agg_sorted(
            table, graph.senders, graph.receivers, graph.row_ptr, att,
            edge_valid=graph.edge_mask, drop_mask=drop_mask,
            negative_slope=negative_slope, eps=eps, emit_scores=False)
        ctx.save_for_backward(table, att, m, l)
        ctx.graph, ctx.num_local, ctx.drop_mask = graph, num_local, drop_mask
        ctx.negative_slope, ctx.eps = negative_slope, eps
        return out[:num_local]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_local):
        table, att, m, l = ctx.saved_tensors
        graph, drop_mask = ctx.graph, ctx.drop_mask
        slope, eps = ctx.negative_slope, ctx.eps
        g = torch.zeros_like(table)
        g[: ctx.num_local] = g_local
        rho = attend_cuda.attend_rho_sorted(
            g, None, m, l, table, graph.senders, graph.receivers,
            graph.row_ptr, eps=eps, drop_mask=drop_mask, att=att,
            negative_slope=slope, edge_valid=graph.edge_mask)
        dtable, datt, v = attend_cuda.attend_recv_bwd_full_sorted(
            table, g, graph.senders, graph.receivers, graph.row_ptr, att,
            None, m, l, rho, eps=eps, negative_slope=slope,
            drop_mask=drop_mask, edge_valid=graph.edge_mask)
        dtable = dtable + spmm_cuda.gather_scatter_sum_sorted(
            v, graph.bwd_perm, graph.senders_sorted, graph.row_ptr_bwd,
            graph.num_nodes)
        return dtable, datt, None, None, None, None, None


def attend_local(
    ht_local: torch.Tensor,
    att: torch.Tensor,
    shard: AttendShard,
    *,
    group,
    negative_slope: float = 0.2,
    eps: float = 1e-10,
    dropout: float = 0.0,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Per rank: the fused GATv2 attention propagate, ``[L, H*F]``.

    ``ht_local`` ``[L, H*F]``, ``att`` ``[H, F]``; ``shard``: this rank's
    :func:`plan_device_data`; ``group``: the graph axis's process group.
    ``dropout > 0`` draws the pre-scaled ``[slots, H]`` keep mask from
    ``generator`` (each rank its own stream).
    """
    graph = shard.context
    table = exchange(ht_local, shard.send_idx, group=group)
    drop_mask = None
    if dropout > 0.0:
        drop_mask = keep_mask_at(
            generator, None, att.shape[0], dropout, table.dtype,
            num_edges=int(graph.senders.shape[0]), device=table.device)
    return _AttendTable.apply(table, att, graph, shard.nodes_per_part,
                              float(negative_slope), float(eps), drop_mask)
