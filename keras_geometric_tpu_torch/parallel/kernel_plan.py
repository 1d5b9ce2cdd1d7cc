"""Kernelized distributed execution plan: the sorted SpMM kernels on each
rank, with the halo exchange overlapped against local aggregation.

Counterpart of the JAX package's ``parallel/kernel_plan.py``:

- **Per-rank edge streams.** Each partition's receiver-sorted edges are split
  into a *local* stream (senders on the receiving rank, ids into its own
  rows) and a *remote* stream (senders elsewhere, ids into the halo block
  ``[P*H, F]``), in receiver order. Each stream carries the port's table
  vocabulary, as a :class:`~..ops.csr.GraphContext` does: row pointers for
  both orientations, the sender-sorted permutation and companions
  (``receivers_ss``, ``weight_ss``), and the validity mask; the pieces of
  the kernels that walk them (``spmm_cuda.recv_bwd_work``) are built at
  first use and kept on the row pointers. The TPU's work lists
  (``build_row_tables``) have no counterpart.
- **The overlap.** :func:`spmm_local_overlapped` issues the halo all-to-all
  without waiting (``async_op=True``), runs the local stream's fused-gather
  scatter (K1) while it is in flight, waits, then runs the remote stream. On
  the card one CUDA stream orders the launches and the wait orders it after
  the collective, so the reference's ``chain_after`` barrier has no
  counterpart. Its backward overlaps the same way: the remote stream's
  transpose, the reverse all-to-all in flight during the local one's.

The remote stream is rectangular: ``P*H`` source rows, ``L`` output rows.
Its linear VJP, like ``_SpmmGeneral``'s (``ops/csr.py``), forms no
permutation: the node cotangent is gathered by receivers-in-sender-order and
summed over the transposed orientation, whose output rows are the source's.

Padded slots (each stream padded to a common length across the
partitions, a multiple of ``STREAM_MULTIPLE``) point at the last local
receiver row and source row 0 with weight 0 and validity False. The
reference's ``edge_chunk`` and ``row_block`` sized the TPU's work-list
tables; no kernel here needs a multiple, so the streams' padding is one
constant and not an option.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..kernels import spmm_cuda
from ..ops.csr import _GatherRows
from ..ops.graph_ops import round_up
from .halo import _all_to_all, _scatter_add_rows, build_halo_plan, exchange_start
from .partition import PartitionedGraph

__all__ = [
    "EdgeStream",
    "KernelPlan",
    "build_kernel_plan",
    "StreamShard",
    "KernelShard",
    "plan_device_data",
    "spmm_local_overlapped",
    "pooled_max_local",
]


# Each stream's slots per partition are padded to a multiple of this.
STREAM_MULTIPLE = 8


class EdgeStream(NamedTuple):
    """One receiver-sorted edge subset, stacked per partition (host)."""

    senders: np.ndarray  # [P, E] int32 (local rows, or halo-slot ids)
    receivers: np.ndarray  # [P, E] int32 local receiver rows, non-decreasing
    weight: np.ndarray  # [P, E] f32, 0 on padded slots
    row_ptr: np.ndarray  # [P, L+1] int32 over receivers
    bwd_perm: np.ndarray  # [P, E] int32 sender-sorted pos -> receiver-order
    senders_sorted: np.ndarray  # [P, E] int32
    row_ptr_bwd: np.ndarray  # [P, S+1] int32 over senders_sorted
    receivers_ss: np.ndarray  # [P, E] receivers in sender-sorted order
    weight_ss: np.ndarray  # [P, E] weights in sender-sorted order
    num_real: np.ndarray  # [P] int64 real (unpadded) slots per part
    num_source_rows: int  # S: gather-source row count (L, or P*H)


class KernelPlan(NamedTuple):
    """Everything the kernelized overlapped body needs, host-side."""

    loc: EdgeStream  # senders are local row ids in [0, L)
    rem: EdgeStream  # senders are halo-table slots in [0, P*H)
    send_idx: np.ndarray  # [P, P, H] rows each part sends to each peer
    halo_size: int
    nodes_per_part: int
    comm_fraction: float
    in_degree: np.ndarray  # [P, L] f32 real-edge receiver degree


def _row_ptr(sorted_ids: np.ndarray, num_rows: int) -> np.ndarray:
    return np.searchsorted(sorted_ids, np.arange(num_rows + 1),
                           side="left").astype(np.int32)


def _build_stream(senders_list, receivers_list, weight_list, num_local, *,
                  num_source_rows) -> EdgeStream:
    """Pad per-part edge subsets to a common length and build both
    orientations' tables."""
    P = len(senders_list)
    e_max = max((len(s) for s in senders_list), default=0)
    e_pad = round_up(max(e_max, 1), STREAM_MULTIPLE)
    last = num_local - 1
    s_out = np.zeros((P, e_pad), np.int32)
    r_out = np.full((P, e_pad), last, np.int32)
    w_out = np.zeros((P, e_pad), np.float32)
    perm_out = np.zeros((P, e_pad), np.int32)
    for p in range(P):
        k = len(senders_list[p])
        s_out[p, :k] = senders_list[p]
        r_out[p, :k] = receivers_list[p]
        w_out[p, :k] = weight_list[p]
        perm_out[p] = np.argsort(s_out[p], kind="stable")
    ss = np.take_along_axis(s_out, perm_out, axis=1)
    return EdgeStream(
        senders=s_out, receivers=r_out, weight=w_out,
        row_ptr=np.stack([_row_ptr(r, num_local) for r in r_out]),
        bwd_perm=perm_out, senders_sorted=ss,
        row_ptr_bwd=np.stack([_row_ptr(s, num_source_rows) for s in ss]),
        receivers_ss=np.take_along_axis(r_out, perm_out, axis=1),
        weight_ss=np.take_along_axis(w_out, perm_out, axis=1),
        num_real=np.array([len(s) for s in senders_list], np.int64),
        num_source_rows=num_source_rows,
    )


def build_kernel_plan(
    pg: PartitionedGraph,
    *,
    halo_multiple: int = 8,
) -> KernelPlan:
    """Host-side, once: halo plan + local/remote edge split + both
    orientations' tables per stream."""
    plan = build_halo_plan(pg, halo_multiple=halo_multiple)
    P, L = pg.num_parts, pg.nodes_per_part
    h = plan.halo_size

    loc_s, loc_r, loc_w = [], [], []
    rem_s, rem_r, rem_w = [], [], []
    weight = (
        pg.edge_weight
        if pg.edge_weight is not None
        else pg.edge_mask.astype(np.float32)
    )
    for p in range(P):
        mask = pg.edge_mask[p]
        owners = pg.senders_global[p] // L  # int32
        local = mask & (owners == p)
        remote = mask & (owners != p)
        # Boolean selection preserves the receiver-sorted order.
        loc_s.append(plan.senders_local[p][local])
        loc_r.append(pg.receivers_local[p][local])
        loc_w.append(weight[p][local])
        rem_s.append(plan.senders_local[p][remote] - L)  # halo slot ids
        rem_r.append(pg.receivers_local[p][remote])
        rem_w.append(weight[p][remote])

    loc = _build_stream(loc_s, loc_r, loc_w, L, num_source_rows=L)
    rem = _build_stream(rem_s, rem_r, rem_w, L, num_source_rows=P * h)
    in_degree = np.stack([
        np.bincount(
            pg.receivers_local[p][pg.edge_mask[p]], minlength=L
        ).astype(np.float32)
        for p in range(P)
    ])
    return KernelPlan(
        loc=loc, rem=rem, send_idx=plan.send_idx, halo_size=h,
        nodes_per_part=L, comm_fraction=plan.comm_fraction,
        in_degree=in_degree,
    )


# ---------------------------------------------------------------------------
# One rank's slice on its device.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StreamShard:
    """One rank's slice of an :class:`EdgeStream`, on its device."""

    senders: torch.Tensor
    receivers: torch.Tensor
    weight: torch.Tensor  # f32
    row_ptr: torch.Tensor
    bwd_perm: torch.Tensor
    senders_sorted: torch.Tensor
    row_ptr_bwd: torch.Tensor
    receivers_ss: torch.Tensor
    weight_ss: torch.Tensor
    valid: torch.Tensor  # [E] bool, weight != 0 (the reference's validity)
    num_local: int
    num_source_rows: int
    num_real: int
    _weights: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def num_nodes(self) -> int:
        """The gather's source rows, under the name ``GraphContext`` gives
        them: the rows its VJP (``ops.csr._GatherRows``) sums into."""
        return self.num_source_rows

    def weights(self, dtype: torch.dtype, unit: bool = False):
        """``(weight, weight_ss)`` in ``dtype``; ``unit=True``: the validity
        indicator (1 real / 0 padded) instead. Cast once per type, kept."""
        key = (dtype, unit)
        if key not in self._weights:
            pair = (self.weight, self.weight_ss)
            if unit:
                pair = tuple((w != 0) for w in pair)
            self._weights[key] = tuple(w.to(dtype) for w in pair)
        return self._weights[key]


@dataclasses.dataclass
class KernelShard:
    """One rank's slice of a :class:`KernelPlan`, on its device."""

    loc: StreamShard
    rem: StreamShard
    send_idx: torch.Tensor  # [P, H] int32 rows this rank sends each peer
    in_degree: torch.Tensor  # [L] f32
    nodes_per_part: int
    halo_size: int


def _stream_shard(es: EdgeStream, p: int, num_local: int, dev) -> StreamShard:
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a[p])).to(dev)
    return StreamShard(
        senders=t(es.senders), receivers=t(es.receivers),
        weight=t(es.weight), row_ptr=t(es.row_ptr), bwd_perm=t(es.bwd_perm),
        senders_sorted=t(es.senders_sorted), row_ptr_bwd=t(es.row_ptr_bwd),
        receivers_ss=t(es.receivers_ss), weight_ss=t(es.weight_ss),
        valid=t(es.weight != 0), num_local=num_local,
        num_source_rows=es.num_source_rows, num_real=int(es.num_real[p]),
    )


def plan_device_data(kp: KernelPlan, part: int, device) -> KernelShard:
    """Partition ``part``'s slice of every ``[P, ...]`` array of the plan on
    ``device`` (the reference flattens the whole stack for ``shard_map``;
    a rank here keeps only its own)."""
    L = kp.nodes_per_part
    return KernelShard(
        loc=_stream_shard(kp.loc, part, L, device),
        rem=_stream_shard(kp.rem, part, L, device),
        send_idx=torch.from_numpy(
            np.ascontiguousarray(kp.send_idx[part])).to(device),
        in_degree=torch.from_numpy(
            np.ascontiguousarray(kp.in_degree[part])).to(device),
        nodes_per_part=L, halo_size=kp.halo_size,
    )


# ---------------------------------------------------------------------------
# The overlapped aggregations.
# ---------------------------------------------------------------------------


def _spmm_stream(source, st: StreamShard, w):
    """``A_stream @ source`` (fused-gather scatter, K1: the row walk, as the
    single-device GCN operator takes it)."""
    return spmm_cuda.gather_scatter_sum_sorted(
        source, st.senders, st.receivers, st.row_ptr, st.num_local,
        weights=w, pieces=False)


def _spmm_stream_t(g, st: StreamShard, w_ss):
    """``A_stream^T @ g``: output rows are the stream's source rows."""
    return spmm_cuda.gather_scatter_sum_sorted(
        g, st.receivers_ss, st.senders_sorted, st.row_ptr_bwd,
        st.num_source_rows, weights=w_ss, pieces=False)


class _OverlappedSpmm(torch.autograd.Function):
    """``out = A_loc h + A_rem halo(h)`` with the all-to-all in flight
    during the local stream, forward and backward. Linear in ``h``."""

    @staticmethod
    def forward(ctx, h_local, shard, group, unit):
        h_local = h_local.contiguous()
        idx = shard.send_idx.reshape(-1)
        ctx.shard, ctx.group, ctx.unit = shard, group, unit
        w_loc, _ = shard.loc.weights(h_local.dtype, unit)
        w_rem, _ = shard.rem.weights(h_local.dtype, unit)
        halo, work = _all_to_all(h_local.index_select(0, idx), group,
                                 async_op=True)
        out = _spmm_stream(h_local, shard.loc, w_loc)
        work.wait()
        return out + _spmm_stream(halo, shard.rem, w_rem)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        shard, group = ctx.shard, ctx.group
        g = g.contiguous()
        _, w_loc_ss = shard.loc.weights(g.dtype, ctx.unit)
        _, w_rem_ss = shard.rem.weights(g.dtype, ctx.unit)
        d_halo = _spmm_stream_t(g, shard.rem, w_rem_ss)
        d_send, work = _all_to_all(d_halo, group, async_op=True)
        d_h = _spmm_stream_t(g, shard.loc, w_loc_ss)
        work.wait()
        d_h = _scatter_add_rows(d_h.shape[0], shard.send_idx.reshape(-1),
                                d_send, base=d_h)
        return d_h, None, None, None


def spmm_local_overlapped(
    h_local: torch.Tensor,
    shard: KernelShard,
    *,
    group,
    message_scale: dict | None = None,
    unit_weights: bool = False,
) -> torch.Tensor:
    """Per rank: ``out = A_local h + A_remote halo(h)`` (``[L, F]``).

    ``shard``: this rank's :func:`plan_device_data`; ``group``: the graph
    axis's process group. The local stream has no data dependence on the
    all-to-all, so it runs while the collective is in flight.
    ``message_scale``: optional per-edge multipliers ``{"loc": [E_loc],
    "rem": [E_rem]}`` (dropout keep masks): the messages are then gathered
    (the gather's VJP is the fused-gather scatter over ``bwd_perm``),
    scaled and summed by the messages-form scatter (K1; its VJP is the
    expand kernel, K2), as the reference does; normalization weights are
    already in the plan. ``unit_weights=True`` replaces the plan's weights
    by their validity indicator (1 real / 0 padded): the GIN / GraphSAGE sum
    on a plan that may carry GCN norm weights.
    """
    if message_scale is None:
        return _OverlappedSpmm.apply(h_local, shard, group, unit_weights)
    halo, work = exchange_start(h_local, shard.send_idx, group=group)

    def stream(source, st, scale):
        msgs = _GatherRows.apply(source, st) * scale[:, None]
        w, _ = st.weights(source.dtype, unit_weights)
        return spmm_cuda.scatter_sum_sorted(
            msgs, st.receivers, st.num_local, row_ptr=st.row_ptr, weights=w)

    out = stream(h_local, shard.loc, message_scale["loc"])
    work.wait()
    return out + stream(halo, shard.rem, message_scale["rem"])


def pooled_max_local(
    h_local: torch.Tensor,
    shard: KernelShard,
    apply_mlp,
    *,
    group,
    message_scale: dict | None = None,
) -> torch.Tensor:
    """Per rank: the receiver max of ``apply_mlp`` of the gathered messages
    over the local and remote streams (the GraphSAGE pooling / max / min and
    GIN max aggregation), by the wide segment max kernel (K4).

    Each stream's max keeps an empty row at the ``-1e30`` sentinel
    (``empty_to_zero=False``), so the two combine with one ``torch.maximum``
    before the empty -> 0 fixup (combining after it would let the zeros beat
    genuine negative maxes). Tie rule, the reference's distributed one:
    within a stream the kernel's (every tied element gets the row's whole
    cotangent), across the two streams ``torch.maximum``'s (split evenly);
    not the split rule of ``GraphContext.scatter_max``. ``message_scale``
    follows :func:`spmm_local_overlapped`'s per-edge convention.
    """
    halo, work = exchange_start(h_local, shard.send_idx, group=group)
    scale = message_scale or {}
    max_local = _stream_max(h_local, shard.loc, apply_mlp, scale.get("loc"))
    work.wait()
    max_remote = _stream_max(halo, shard.rem, apply_mlp, scale.get("rem"))
    return _combine_maxes(max_local, max_remote, h_local.dtype)


def _stream_max(source, st: StreamShard, apply_mlp, scale=None):
    """One stream's receiver max of ``apply_mlp`` of its gathered (and
    scaled) messages, f32, empty rows at the sentinel (K4)."""
    msgs = _GatherRows.apply(source, st)
    if scale is not None:
        msgs = msgs * scale[:, None]
    return spmm_cuda.segment_max_wide_sorted(
        apply_mlp(msgs), st.receivers, st.num_local, row_ptr=st.row_ptr,
        mask=st.valid, empty_to_zero=False)


def _combine_maxes(max_local, max_remote, dtype):
    """The two streams' maxes combined, empty rows (both at the sentinel)
    set to 0, in ``dtype``."""
    out = torch.maximum(max_local, max_remote)
    return torch.where(out <= spmm_cuda.NEG_SENTINEL / 2,
                       torch.zeros_like(out), out).to(dtype)
