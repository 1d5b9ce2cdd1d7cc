"""Halo (boundary-node) feature exchange for edge-partitioned execution.

Counterpart of the JAX package's ``parallel/halo.py``. The library path of
``parallel.spmd`` all-gathers the full transformed feature table, ``N * F``
values per rank and layer. For partitioned graphs with locality each rank
only *needs* the features of its boundary senders. This module implements
the indexed exchange:

- :func:`build_halo_plan` (host, once; the reference's arrays bit for bit):
  for every rank pair ``(p, q)``, the local row ids ``p`` must send to
  ``q``, padded to the max halo size ``H``; plus each rank's edge senders
  remapped into a local table layout ``[own rows | halo slot (q, j)]``.
- :func:`exchange` (device): gather the send rows ``[P, H, F]``, one
  ``all_to_all_single`` over the graph group, and the received rows after
  the local shard: the rank's ``[L + P*H, F]`` feature table. Comm volume
  ``P*H*F`` instead of ``N*F``.

Autodiff (explicit ``torch.autograd.Function``s, where ``shard_map`` inserts
the transposes): an all-to-all's transpose is the reverse all-to-all, the
gather's an ``index_add_`` of the cotangents into the owner's rows, an
all-gather's a reduce-scatter. :func:`exchange_start` issues the collective
without waiting (``async_op=True``), so that a caller runs local work while
it is in flight and waits on the returned handle before it reads the halo.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops.graph_ops import round_up
from .partition import PartitionedGraph

__all__ = [
    "HaloPlan",
    "build_halo_plan",
    "exchange",
    "exchange_start",
    "HierHaloPlan",
    "build_hier_halo_plan",
    "exchange_hier",
    "all_gather_rows",
]


class HaloPlan(NamedTuple):
    """Static halo-exchange tables; leading axis = partition (rank) id."""

    send_idx: np.ndarray  # [P, P, H] int32: rows part p sends to part q
    senders_local: np.ndarray  # [P, E] int32 into [L + P*H] local table
    halo_size: int  # H
    comm_fraction: float  # halo volume / full-gather volume (diagnostic)


def build_halo_plan(pg: PartitionedGraph, *, halo_multiple: int = 8) -> HaloPlan:
    """Derive the per-pair send tables and sender remap from a partition.

    Vectorized (np.unique + searchsorted remap): no per-edge Python loop.
    """
    P = pg.num_parts
    L = pg.nodes_per_part

    # uniq[p]: sorted unique REMOTE sender ids part p needs; bounds[p]
    # split uniq[p] by owner part (owners are non-decreasing in a sorted
    # id list, so searchsorted on the L-grid segments it).
    uniq: list[np.ndarray] = []
    bounds: list[np.ndarray] = []
    owner_grid = (np.arange(P + 1, dtype=np.int64) * L).astype(np.int32)
    for p in range(P):
        senders = pg.senders_global[p][pg.edge_mask[p]]  # int32
        remote = senders[(senders // L) != p]
        u = np.unique(remote)
        uniq.append(u)
        bounds.append(np.searchsorted(u, owner_grid))

    per_pair = np.array(
        [[bounds[p][q + 1] - bounds[p][q] for q in range(P)] for p in range(P)],
        dtype=np.int64,
    )
    h = int(per_pair.max()) if P > 1 else 0
    h = max(round_up(max(h, 1), halo_multiple), halo_multiple)

    send_idx = np.zeros((P, P, h), np.int32)
    for p in range(P):
        for q in range(P):
            if p == q:
                continue
            # Part p sends to part q the rows q needs from p.
            ids = uniq[q][bounds[q][p]: bounds[q][p + 1]]
            send_idx[p, q, : len(ids)] = (ids - p * L).astype(np.int32)

    # Remap each part's edge senders into its local table layout
    # [own rows | halo slot (owner q, rank within need[p][q])].
    senders_local = np.zeros_like(pg.senders_global)
    for p in range(P):
        s = pg.senders_global[p]  # int32; halo slot ids fit int32 too
        owners = s // L
        local = owners == p
        out = np.where(local, s - p * L, 0)
        rem = ~local & pg.edge_mask[p]
        if rem.any():
            pos = np.searchsorted(uniq[p], s[rem])  # rank in uniq[p]
            seg_start = bounds[p][owners[rem]]  # owner segment offset
            out[rem] = L + owners[rem] * h + (pos - seg_start)
        senders_local[p] = out.astype(pg.senders_global.dtype)

    full = (P - 1) * L  # rows a full all-gather moves per device (others' shards)
    comm_fraction = (P * h) / max(full, 1)
    return HaloPlan(
        send_idx=send_idx,
        senders_local=senders_local,
        halo_size=h,
        comm_fraction=comm_fraction,
    )




# ---------------------------------------------------------------------------
# Collectives with their transposes.
# ---------------------------------------------------------------------------


def _quiet(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` without the FutureWarning some PyTorch builds
    give for ``all_gather_into_tensor`` / ``reduce_scatter_tensor`` (the
    names every supported build has)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return fn(*args, **kwargs)


def _all_to_all(x: torch.Tensor, group, async_op: bool = False):
    """Equal-split all-to-all of ``x``'s rows: block ``q`` goes to rank
    ``q`` of ``group``, and block ``q`` of the result came from it."""
    x = x.contiguous()
    out = torch.empty_like(x)
    work = dist.all_to_all_single(out, x, group=group, async_op=async_op)
    return (out, work) if async_op else out


def _scatter_add_rows(num_rows, idx, rows, base=None):
    """``base`` (or zeros) ``[num_rows, F]`` with ``rows`` added at ``idx``,
    summed in f32 and rounded once to ``rows``' type."""
    acc = (torch.zeros(num_rows, rows.shape[1], dtype=torch.float32,
                       device=rows.device)
           if base is None else base.float())
    acc.index_add_(0, idx, rows.float())
    return acc.to(rows.dtype)


class _AllGather(torch.autograd.Function):
    """Rows of every rank of ``group``, in rank order; the transpose sums
    the cotangent over the ranks and keeps each rank's block
    (``reduce_scatter_tensor``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        size = dist.get_world_size(group)
        out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
        _quiet(dist.all_gather_into_tensor, out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        size = dist.get_world_size(ctx.group)
        out = g.new_empty((g.shape[0] // size,) + tuple(g.shape[1:]))
        _quiet(dist.reduce_scatter_tensor, out, g, op=dist.ReduceOp.SUM,
               group=ctx.group)
        return out, None


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable tiled all-gather: ``[L, F]`` per rank -> ``[P*L, F]``
    (the reference's ``lax.all_gather(..., tiled=True)``)."""
    return _AllGather.apply(x, group)


class _HaloStart(torch.autograd.Function):
    """Send rows gathered and one all-to-all left in flight: the forward
    returns the receive buffer at once and puts the handle in ``box``; the
    caller waits on it before the buffer is read. Backward: the reverse
    all-to-all, then the cotangents added into the owners' rows."""

    @staticmethod
    def forward(ctx, h_local, send_idx, group, box):
        idx = send_idx.reshape(-1)
        ctx.save_for_backward(idx)
        ctx.group, ctx.num_local = group, h_local.shape[0]
        recv, box["work"] = _all_to_all(h_local.index_select(0, idx), group,
                                        async_op=True)
        return recv

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        g_send = _all_to_all(g, ctx.group)
        return _scatter_add_rows(ctx.num_local, idx, g_send), None, None, None


def exchange(h_local: torch.Tensor, send_idx: torch.Tensor, *,
             group) -> torch.Tensor:
    """Per rank: the ``[L + P*H, F]`` feature table ``[h_local | halo]``.

    ``send_idx``: this rank's ``[P, H]`` send-row table (a slice of
    :attr:`HaloPlan.send_idx`, on ``h_local``'s device); ``group``: the
    graph axis's process group. Differentiable."""
    halo, work = exchange_start(h_local, send_idx, group=group)
    work.wait()
    return torch.cat([h_local, halo])


def exchange_start(h_local: torch.Tensor, send_idx: torch.Tensor, *,
                   group) -> tuple[torch.Tensor, object]:
    """The halo block ``[P*H, F]`` of :func:`exchange`, its all-to-all
    issued and not waited on: returns ``(halo, work)``; call
    ``work.wait()`` before reading ``halo`` (on the card the wait orders the
    current stream after the collective; the host does not block).
    Differentiable (its backward is not overlapped)."""
    box = {}
    halo = _HaloStart.apply(h_local, send_idx, group, box)
    return halo, box["work"]


# ---------------------------------------------------------------------------
# Hierarchical (intra-host / inter-host) exchange.
#
# The flat plan above runs ONE all-to-all over the whole mesh: on a
# multi-host deployment every rank-pair link is priced the same, but a row
# needed by k ranks of one remote HOST crosses the slow inter-host network
# k times. The hierarchical plan prices links by tier:
#
#   1. intra-host all-to-all over the "chip" mesh axis (NVLink on the card's
#      hosts): rows exchanged between ranks of the same host, exactly the
#      flat plan restricted to a host;
#   2. inter-host all-to-all over the "host" mesh axis: each owning rank
#      sends, per DESTINATION HOST, the deduplicated union of rows any rank
#      of that host needs (a row crosses hosts once per needing host, not
#      once per needing rank);
#   3. intra-host all-gather over the "chip" axis: the inter-host buffers
#      land lane-wise (chip c receives only rows owned by remote chip-c's),
#      so one fast gather replicates them host-wide and every rank indexes
#      what it needs locally.
#
# Per-rank table layout: [L own | CP*Hi intra | CP*HP*He inter], with the
# inter region ordered (source chip-lane c, source host a, rank). The
# plan's field names are the reference's: ``dcn`` is the inter-host tier,
# ``ici`` the intra-host one.
# ---------------------------------------------------------------------------


class HierHaloPlan(NamedTuple):
    """Static two-tier halo-exchange tables; leading axis = chip id
    ``p = host * chips_per_host + chip``."""

    send_idx_intra: np.ndarray  # [P, CP, Hi]: rows p sends chip q (same host)
    send_idx_inter: np.ndarray  # [P, HP, He]: rows p sends host b (deduped)
    senders_local: np.ndarray  # [P, E] into [L + CP*Hi + CP*HP*He]
    intra_halo_size: int  # Hi
    inter_halo_size: int  # He
    hosts: int
    chips_per_host: int
    comm_fraction_dcn: float  # DCN rows moved / flat-plan cross-host rows
    comm_fraction: float  # total exchanged rows / full-gather rows
    dcn_rows_per_chip: int  # HP * He
    ici_a2a_rows_per_chip: int  # CP * Hi
    ici_ag_rows_per_chip: int  # (CP-1) * HP * He  (fan-out stage)


def build_hier_halo_plan(
    pg: PartitionedGraph,
    hosts: int,
    *,
    halo_multiple: int = 8,
) -> HierHaloPlan:
    """Host-side, once: two-tier send tables + sender remap.

    ``pg.num_parts`` must factor as ``hosts * chips_per_host``; partition
    ``p`` lives on host ``p // chips_per_host``. Use a host-contiguous
    partition order (community_partition_order already produces one) so
    the cheap intra-host tier absorbs the densest cuts.
    """
    P = pg.num_parts
    if P % hosts:
        raise ValueError(f"num_parts={P} not divisible by hosts={hosts}")
    CP = P // hosts
    L = pg.nodes_per_part

    # Per chip: sorted unique remote senders, segmented by owner chip.
    owner_grid = (np.arange(P + 1, dtype=np.int64) * L).astype(np.int64)
    uniq: list[np.ndarray] = []
    bounds: list[np.ndarray] = []
    for p in range(P):
        senders = pg.senders_global[p][pg.edge_mask[p]]
        remote = np.unique(senders[(senders // L) != p])
        uniq.append(remote)
        bounds.append(np.searchsorted(remote, owner_grid))

    # --- intra-host tier (flat plan restricted to each host) ---
    hi = 0
    for p in range(P):
        a = p // CP
        for q in range(a * CP, (a + 1) * CP):
            if q != p:
                hi = max(hi, bounds[p][q + 1] - bounds[p][q])
    hi = max(round_up(max(int(hi), 1), halo_multiple), halo_multiple)
    send_idx_intra = np.zeros((P, CP, hi), np.int32)
    for p in range(P):
        a = p // CP
        for cq in range(CP):
            q = a * CP + cq
            if q == p:
                continue
            ids = uniq[q][bounds[q][p]: bounds[q][p + 1]]
            send_idx_intra[p, cq, : len(ids)] = (ids - p * L).astype(
                np.int32
            )

    # --- inter-host tier: dedup per (owning chip, destination host) ---
    # union_need[b][p] = sorted unique rows of owning chip p needed by ANY
    # chip of host b (the host-level dedup that the flat plan lacks).
    union_need: list[list[np.ndarray]] = []
    he = 0
    flat_cross_rows = 0  # what the flat plan would push across hosts
    for b in range(hosts):
        per_owner: list[np.ndarray] = []
        for p in range(P):
            if p // CP == b:
                per_owner.append(np.zeros(0, np.int64))
                continue
            needs = [
                uniq[q][bounds[q][p]: bounds[q][p + 1]]
                for q in range(b * CP, (b + 1) * CP)
            ]
            flat_cross_rows += sum(len(x) for x in needs)
            u = np.unique(np.concatenate(needs)) if needs else \
                np.zeros(0, np.int64)
            per_owner.append(u)
            he = max(he, len(u))
        union_need.append(per_owner)
    he = max(round_up(max(int(he), 1), halo_multiple), halo_multiple)
    send_idx_inter = np.zeros((P, hosts, he), np.int32)
    dcn_rows = 0
    for p in range(P):
        for b in range(hosts):
            ids = union_need[b][p]
            send_idx_inter[p, b, : len(ids)] = (ids - p * L).astype(
                np.int32
            )
            dcn_rows += len(ids)

    # --- sender remap into [L | CP*Hi intra | CP*HP*He inter] ---
    # Inter region order after the chip-axis all_gather of the host
    # all_to_all result: (source chip-lane c, source host a, rank in
    # union_need[self_host][a*CP+c]).
    senders_local = np.zeros_like(pg.senders_global)
    for p in range(P):
        b, cb = p // CP, p % CP
        s = pg.senders_global[p].astype(np.int64)
        owners = s // L
        local = owners == p
        out = np.where(local, s - p * L, 0)
        rem = ~local & pg.edge_mask[p]
        if rem.any():
            sr = s[rem]
            osr = owners[rem]
            same_host = (osr // CP) == b
            dest = np.zeros(len(sr), np.int64)
            if same_host.any():
                oc = osr[same_host] % CP  # source chip index on our host
                # rank of the row within uniq[p]'s owner segment — the
                # intra a2a delivers exactly that segment's order.
                pos = np.searchsorted(uniq[p], sr[same_host])
                seg = bounds[p][osr[same_host]]
                dest[same_host] = L + oc * hi + (pos - seg)
            cross = ~same_host
            if cross.any():
                o = osr[cross]
                ranks = np.empty(int(cross.sum()), np.int64)
                # vectorized per owning chip (few distinct owners)
                for oc_chip in np.unique(o):
                    u = union_need[b][oc_chip]
                    sel = o == oc_chip
                    ranks[sel] = np.searchsorted(u, sr[cross][sel])
                src_host = o // CP
                src_lane = o % CP
                dest[cross] = (
                    L + CP * hi
                    + (src_lane * hosts + src_host) * he + ranks
                )
            out[rem] = dest
        senders_local[p] = out.astype(pg.senders_global.dtype)

    full = (P - 1) * L
    total_rows = CP * hi + hosts * he  # a2a rows entering each chip's table
    return HierHaloPlan(
        send_idx_intra=send_idx_intra,
        send_idx_inter=send_idx_inter,
        senders_local=senders_local,
        intra_halo_size=hi,
        inter_halo_size=he,
        hosts=hosts,
        chips_per_host=CP,
        comm_fraction_dcn=(dcn_rows / max(flat_cross_rows, 1)),
        comm_fraction=total_rows / max(full, 1),
        dcn_rows_per_chip=hosts * he,
        ici_a2a_rows_per_chip=CP * hi,
        ici_ag_rows_per_chip=(CP - 1) * hosts * he,
    )




def exchange_hier(
    h_local: torch.Tensor,
    send_idx_intra: torch.Tensor,  # this rank's [CP, Hi]
    send_idx_inter: torch.Tensor,  # this rank's [HP, He]
    *,
    host_group,
    chip_group,
) -> torch.Tensor:
    """Per rank of a ``(host, chip)`` mesh: the ``[L + CP*Hi + CP*HP*He,
    F]`` feature table by the three-stage pipeline (module comment): an
    all-to-all over ``chip_group`` and one over ``host_group`` (both in
    flight together), then an all-gather over ``chip_group``.
    Differentiable: the all-to-alls' transposes are the reverse all-to-alls
    with the rows added into their owners, the all-gather's a
    reduce-scatter."""
    intra, intra_work = exchange_start(h_local, send_idx_intra,
                                       group=chip_group)
    inter, inter_work = exchange_start(h_local, send_idx_inter,
                                       group=host_group)
    inter_work.wait()
    inter_all = _AllGather.apply(inter, chip_group)  # [CP * HP * He, F]
    intra_work.wait()
    return torch.cat([h_local, intra, inter_all])
