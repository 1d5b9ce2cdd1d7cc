"""Preprocessed CSR graph context: everything the hot path needs, computed once.

Counterpart of the JAX package's ``ops/csr.py``. The backward pass of the
edge gather (dL/dx_j) is an SpMM over the *transposed* graph, so preparation
builds **both CSR orientations** up front:

- receiver-sorted edges + ``row_ptr``: the forward scatter runs the sorted
  scatter kernel;
- sender-sorted permutation + ``row_ptr_bwd``: the gather's backward is the
  same kernel over the transposed orientation, never an unsorted scatter-add.

``prepare_graph`` is host numpy and produces arrays equal, element for
element, to the reference context's; the kernel tables reduce to one
``row_ptr`` per orientation. ``GraphContext.spmm`` runs the fused-gather
kernel with a custom gradient of the same structure as the reference's,
``GraphContext.attend`` the fused GATv2 attention (forward, rho and receiver
backward kernels, then the sender finish: the fused-gather scatter, or the
sender backward kernel, as ``ATTEND_BWD_MODE`` selects; ``ATTEND_SCORE_CACHE``
selects whether the forward keeps its scores), and
``GraphContext.sddmm_scores`` / ``GraphContext.edge_softmax`` the composed
attention path (score and softmax kernels, each with the reference's
backward), and ``GraphContext.scatter_max`` the receiver max of GIN's and
GraphSAGE's max and pooling paths (the wide segment max kernel, which the
reference leaves to XLA's ``segment_max``; the same tie rule in the
backward).

The locality tier (``kernels/band_cuda.py``, after a reordering from
``ops/reorder.py``): ``prepare_graph(band_window=W)`` moves the edges that fit
a ``W``-row window into a dense band, and ``spmm`` sums the band kernel's
product and the residual stream's; ``prepare_graph(attend_window=W)`` lets
``attend``'s backward sum most sender cotangents window by window (the window
scatter kernel) and only the rest through the fused-gather scatter.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from .. import native
from ..kernels import (
    attend_cuda,
    band_cuda,
    sddmm_cuda,
    softmax_cuda,
    spmm_cuda,
)

__all__ = ["GraphContext", "prepare_graph"]

# How GraphContext.attend's backward sums the sender cotangents (read at each
# backward, so that a caller or a test may set it; the reference's names,
# values and meaning):
#
# - "permute" (default): the receiver backward writes the per-edge sender
#   cotangent v [E, H*F] and the fused-gather scatter sums it by sender,
#   reading it through bwd_perm (on an attend_window context: the window
#   scatter and the residual's fused-gather scatter).
# - "send": the receiver backward writes no v; the sender backward kernel
#   recomputes alpha, ds and d_pre in sender-sorted order, gathering each
#   slot's receiver rows, and sums them per sender. It needs the dropout
#   mask in sender order too: with a drop_mask and no drop_mask_ss, the
#   backward takes the permute finish, as the reference does. It is tested
#   before the window tables, which it does not use.
#
# The reference chose "permute" from measurements on its own machine; what
# the two cost on this one is recorded in PERF.md. Any other value raises.
ATTEND_BWD_MODE = "permute"

# Whether GraphContext.attend's forward writes its [E, H] f32 scores for the
# backward (True, default) or the backward recomputes them from ht and att
# (False); read at each forward. Either way the same function computes every
# score, so the results agree bit for bit.
ATTEND_SCORE_CACHE = True

_ATTEND_BWD_MODES = ("permute", "send")


@contextlib.contextmanager
def attend_modes(bwd_mode: str = "permute", score_cache: bool = True):
    """``ATTEND_BWD_MODE`` and ``ATTEND_SCORE_CACHE`` set for the block and
    restored after it, whatever happens inside."""
    global ATTEND_BWD_MODE, ATTEND_SCORE_CACHE
    saved = ATTEND_BWD_MODE, ATTEND_SCORE_CACHE
    ATTEND_BWD_MODE, ATTEND_SCORE_CACHE = bwd_mode, score_cache
    try:
        yield
    finally:
        ATTEND_BWD_MODE, ATTEND_SCORE_CACHE = saved


@dataclasses.dataclass(frozen=True)
class GraphContext:
    """Static per-graph state for the sorted SpMM path."""

    senders: torch.Tensor  # [E] int32, receiver-sorted order
    receivers: torch.Tensor  # [E] int32, non-decreasing
    edge_weight: torch.Tensor | None  # [E] (e.g. GCN norm), 0 on padded slots
    num_nodes: int
    row_ptr: torch.Tensor  # [N+1] int32 over `receivers`
    bwd_perm: torch.Tensor  # [E] int32: sender-sorted pos -> receiver-order edge
    senders_sorted: torch.Tensor  # [E] int32, sender-sorted (for bwd scatter)
    row_ptr_bwd: torch.Tensor  # [N+1] int32 over `senders_sorted`
    num_real_edges: int = -1  # unpadded edge count
    edge_mask: torch.Tensor | None = None  # [E] bool, False on padded slots
    in_degree: torch.Tensor | None = None  # [N] f32 receiver in-degree (real)
    is_symmetric: bool = False  # weighted adjacency equals its transpose
    # Densified diagonal (prepare_graph(densify_self_loops=True)): appended
    # self-loops stay out of the edge stream and are applied as the dense
    # term ``self_weight[:, None] * h`` inside spmm().
    self_weight: torch.Tensor | None = None  # [N] or None
    num_diag: int = 0  # densified self-loop count (for edge accounting)
    # pad_nodes=True rounds num_nodes up; num_real_nodes keeps the true count
    # for reporting and loss masking.
    num_real_nodes: int = -1
    # Sender-sorted companions for the general spmm's backward: the backward
    # of a linear spmm is A^T @ g with g a NODE array, gathered by
    # receivers-in-sender-order.
    receivers_ss: torch.Tensor | None = None  # [E] int32
    edge_weight_ss: torch.Tensor | None = None  # [E]
    # True when edge_weight is all ones (zero on pads): layers that ignore
    # edge weights may route sum/mean aggregation through spmm()/spmm_mean().
    has_unit_weights: bool = False
    # Edge validity in SENDER-sorted order (1.0 real / 0.0 padded); None when
    # no padded slots exist.
    edge_mask_ss: torch.Tensor | None = None
    # Banded tier (prepare_graph(band_window=...)): the edges that fit the
    # window live in a dense [n_pad, W] band and are ABSENT from the CSR
    # stream above, which holds only the residual. band_bwd is the transposed
    # orientation's plan (None when is_symmetric: the band is then its own
    # transpose). spmm()/spmm_mean() sum both tiers; per-edge ops route to
    # the full-stream companion below.
    band: band_cuda.BandPlan | None = None
    band_bwd: band_cuda.BandPlan | None = None
    num_band_edges: int = 0
    # Full-stream companion: a banded or densified context's stream lacks the
    # band edges or the self-loops, so per-edge ops route through a second
    # context that holds every edge (prepare_graph(attend_full_stream=True),
    # the default for band contexts).
    full: "GraphContext | None" = None
    # Banded attention backward (prepare_graph(attend_window=W)): the sender
    # cotangents of the slots whose sender lies in their edge chunk's window
    # are summed by the window scatter kernel; the residual slots, listed in
    # sender-sorted order, by the fused-gather scatter.
    attw_plan: band_cuda.WindowScatterPlan | None = None
    attw_sender: torch.Tensor | None = None  # [E_pad] int32, -1 off-window
    attw_perm_res: torch.Tensor | None = None  # [Er_pad] int32 slot of v
    attw_res_weight: torch.Tensor | None = None  # [Er_pad] f32 1 / 0 (pad)
    attw_senders_res: torch.Tensor | None = None  # [Er_pad] int32, sorted
    attw_res_row_ptr: torch.Tensor | None = None  # [N+1] over the above

    # -- placement ---------------------------------------------------------
    def _replace(self, **changes) -> "GraphContext":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "GraphContext":
        """The same context with every array on ``device`` (the band and
        window plans and the companion included)."""
        return _map_tensors(self, lambda _name, t: t.to(device))

    def with_weight_dtype(self, dtype: torch.dtype) -> "GraphContext":
        """Edge, sender-sorted edge and self weights, and the band, cast to
        ``dtype``: the bf16-IO training setup keeps them in the data's type,
        so the band is stored once in bf16 and not cast on every call."""
        names = ("edge_weight", "edge_weight_ss", "self_weight", "band")
        return _map_tensors(
            self, lambda name, t: t.to(dtype) if name in names else t
        )

    @property
    def device(self) -> torch.device:
        return self.receivers.device

    # -- structure ---------------------------------------------------------
    @property
    def num_edges(self) -> int:
        base = (
            self.num_real_edges
            if self.num_real_edges >= 0
            else int(self.senders.shape[0])
        )
        return base + self.num_diag + self.num_band_edges

    def full_stream(self) -> "GraphContext":
        """The context to use for per-edge ops: ``self`` when the CSR stream
        already holds every edge; the attached ``full`` companion when band
        or densify moved edges out of the stream."""
        if self.band is None and self.num_diag == 0:
            return self
        if self.full is not None:
            return self.full
        raise ValueError(
            "This context's CSR stream is incomplete for per-edge ops "
            "(band_window= moves band edges out of the stream; "
            "densify_self_loops=True moves self-loops out). Prepare "
            "with attend_full_stream=True (the default with band_window=) "
            "to attach a full-stream companion, or prepare without "
            "band/densify."
        )

    @property
    def edge_index(self) -> torch.Tensor:
        return torch.stack([self.senders, self.receivers])

    # -- per-edge ops ------------------------------------------------------
    def gather(self, h: torch.Tensor) -> torch.Tensor:
        """``[N, F] -> [E, F]`` sender-row gather whose gradient is a sorted
        scatter. Routes to the full-stream companion on densified contexts
        (per-edge semantics need every edge)."""
        ctx = self.full_stream()
        return _GatherRows.apply(h, ctx)

    def _check_message_stream(self, messages: torch.Tensor) -> None:
        """Densified contexts route gather() to the full-stream companion but
        scatter over THIS context's residual stream: mixing the two must fail
        loudly, not through a shape mismatch further down."""
        if messages.shape[0] != self.receivers.shape[0]:
            hint = ""
            if self.band is not None or self.num_diag:
                hint = (
                    " This context is banded/densified: its CSR stream "
                    "holds only residual edges, while per-edge ops "
                    "(gather) route through the full-stream companion; "
                    "scatter through ctx.full_stream() for messages "
                    "produced there."
                )
            raise ValueError(
                f"scatter got {messages.shape[0]} messages but this "
                f"context's edge stream has {self.receivers.shape[0]} "
                f"slots.{hint}"
            )

    def scatter(self, messages: torch.Tensor, *, masked: bool = False):
        """``[E, F] -> [N, F]`` receiver scatter-sum (sorted kernel).

        ``masked=True`` zeroes padded edge slots first: needed whenever the
        messages were not already nulled by a zero edge weight. Unmasked,
        padded slots are summed into the last node's row like any edge.
        """
        self._check_message_stream(messages)
        return spmm_cuda.scatter_sum_sorted(
            messages,
            self.receivers,
            self.num_nodes,
            row_ptr=self.row_ptr,
            mask=self.edge_mask if masked else None,
        )

    def scatter_mean(self, messages: torch.Tensor, *, masked: bool = True):
        """Mean aggregation with the reference 1e-8 degree clamp."""
        total = self.scatter(messages, masked=masked)
        deg = self.in_degree.clamp_min(1e-8).to(total.dtype)
        return total / deg[:, None]

    def scatter_max(self, messages: torch.Tensor) -> torch.Tensor:
        """``[E, F] -> [N, F]`` receiver max of the stream's unmasked slots
        (the wide segment max kernel), in the messages' type; a row without
        one is 0. In the backward a row's cotangent is split evenly among
        the slots tied at its max in each column, as XLA's ``segment_max``
        splits it on the reference's layer paths."""
        self._check_message_stream(messages)
        return spmm_cuda._segment_max_sorted_split(
            messages,
            self.receivers,
            self.num_nodes,
            row_ptr=self.row_ptr,
            mask=self.edge_mask,
        ).to(messages.dtype)

    def gather_receivers(self, h: torch.Tensor) -> torch.Tensor:
        """``[N, F] -> [E, F]`` receiver-row gather (x_i) through the sorted
        expand kernel; its backward is the sorted scatter."""
        return spmm_cuda.expand_sorted(
            h, self.receivers, row_ptr=self.row_ptr
        )

    def scatter_weighted(self, messages: torch.Tensor) -> torch.Tensor:
        """Scatter with the per-edge weights applied inside the kernel (no
        separate [E, F] weighting pass; padded slots carry zero weight)."""
        self._check_message_stream(messages)
        return spmm_cuda.scatter_sum_sorted(
            messages,
            self.receivers,
            self.num_nodes,
            row_ptr=self.row_ptr,
            weights=self.edge_weight,
        )

    def attend(
        self,
        ht: torch.Tensor,
        att: torch.Tensor,
        *,
        negative_slope: float = 0.2,
        eps: float = 1e-10,
        drop_mask: torch.Tensor | None = None,
        drop_mask_ss: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """Fused GATv2 attention propagate with a hand-written backward.

        One op for the whole pipeline: ``score = sum_f att*leaky_relu(h_i +
        h_j)`` per head, max-shifted per-receiver softmax with ``+eps``,
        optional attention dropout (``drop_mask``: pre-scaled keep mask,
        ``[E, H]``, applied after normalisation), then the alpha-weighted
        aggregation. ``ht`` is ``[N, H*F]``, ``att`` is ``[H, F]``, the
        output ``[N, H*F]``. Padded edge slots take no part. Routes through
        the full-stream companion on densified contexts.

        The backward runs the rho kernel, then the receiver-backward kernel
        (receiver part of ``d ht``, ``d att``, per-edge sender cotangent
        ``v``), then sums ``v`` by sender with the fused-gather scatter over
        the transposed orientation, which reads ``v`` through ``bwd_perm``:
        neither the gathered sender rows nor a permuted copy of ``v`` is
        ever written. On an ``attend_window`` context the window scatter
        kernel sums the window-eligible slots and the fused-gather scatter
        only the residual ones (through ``attw_perm_res``). With
        ``ATTEND_BWD_MODE = "send"`` no ``v`` is written: the sender backward
        kernel recomputes it in sender-sorted order; ``drop_mask_ss`` (the
        same mask in sender-sorted order, ``drop_mask[bwd_perm]``) is what
        that mode reads under dropout, and nothing else reads it. With
        ``ATTEND_SCORE_CACHE = False`` the forward keeps no scores and the
        backward kernels recompute them.
        """
        ctx = self.full_stream()
        if att.ndim != 2:
            raise ValueError(f"att must be [H, F], got {tuple(att.shape)}")
        if ht.shape[0] != ctx.num_nodes:
            raise ValueError(
                f"ht has {ht.shape[0]} rows, the context {ctx.num_nodes} nodes"
            )
        return _Gatv2Attend.apply(
            ht, att, ctx, float(negative_slope), float(eps), drop_mask,
            drop_mask_ss,
        )

    def edge_softmax(self, scores: torch.Tensor, *, eps: float = 1e-10):
        """Per-receiver softmax of ``[E, K]`` edge scores, max-shifted with
        ``+eps`` in the denominator (the reference's ``_softmax_by_target``).

        Two kernels: the online max / sum-exp statistics per receiver row and
        the edge-parallel normalisation. Padded slots are set to ``-inf``
        first, so they get weight 0 and gradient 0. The result is in the
        scores' type. The backward applies the exact softmax Jacobian
        ``ds = alpha * (dalpha - sum_row(alpha * dalpha))`` with one sorted
        scatter and one sorted expand; the subgradient through the max shift
        (relative size ~eps) is dropped, as in the reference. Routes through
        the full-stream companion on densified contexts.
        """
        ctx = self.full_stream()
        if scores.ndim != 2 or scores.shape[0] != ctx.receivers.shape[0]:
            raise ValueError(
                f"scores must be [{ctx.receivers.shape[0]}, K], got "
                f"{tuple(scores.shape)}"
            )
        return _EdgeSoftmax.apply(scores, ctx, float(eps))

    def sddmm_scores(
        self,
        ht: torch.Tensor,
        hj: torch.Tensor,
        att: torch.Tensor,
        *,
        negative_slope: float = 0.2,
    ) -> torch.Tensor:
        """GATv2 attention scores ``[E, H]`` (f32) with a kernel forward and
        backward: ``s[e, h] = sum_f att[h, f] * leaky_relu(ht[recv e] +
        hj[e])[h*F + f]``.

        ``hj`` must be the receiver-sorted gathered sender rows
        (``self.gather(ht)``); its cotangent flows back through the caller's
        gather. The backward kernel gives ``d_pre`` (``d hj``, in ``hj``'s
        type) and ``d att``; ``d ht`` is ``d_pre`` summed by receiver with the
        sorted scatter. Padded slots return scores computed like any other:
        mask downstream (``edge_softmax`` does). Routes through the
        full-stream companion on densified contexts.
        """
        ctx = self.full_stream()
        if att.ndim != 2:
            raise ValueError(f"att must be [H, F], got {tuple(att.shape)}")
        if ht.shape[0] != ctx.num_nodes:
            raise ValueError(
                f"ht has {ht.shape[0]} rows, the context {ctx.num_nodes} nodes"
            )
        if hj.shape[0] != ctx.receivers.shape[0]:
            raise ValueError(
                f"hj has {hj.shape[0]} rows, the context's stream "
                f"{ctx.receivers.shape[0]} slots"
            )
        return _Sddmm.apply(ht, hj, att, ctx, float(negative_slope))

    # -- spmm --------------------------------------------------------------
    def spmm(self, h: torch.Tensor) -> torch.Tensor:
        """Full ``A @ h``: sender rows gathered and weighted-summed into the
        receivers in one kernel.

        When the weighted adjacency is symmetric (``is_symmetric``, e.g. GCN
        normalization on an undirected graph) the gradient is the same
        operator; otherwise it is the same kernel over the transposed
        orientation. Neither forms an ``[E, F]`` array.

        With a banded tier (``band_window=``), ``A = B + R``: the band part
        runs the band kernel and the residual the path above; both splits
        are transpose-stable, so the gradients add.
        """
        if self.band is not None:
            out = band_cuda.band_spmm(
                h, self.band, None if self.is_symmetric else self.band_bwd)
            if self.num_real_edges > 0:
                out = out + self._csr_spmm(h)
            elif self.self_weight is not None:
                out = out + h * self.self_weight[:, None].to(h.dtype)
            return out
        return self._csr_spmm(h)

    def _csr_spmm(self, h: torch.Tensor) -> torch.Tensor:
        if self.is_symmetric:
            return _SpmmSymmetric.apply(h, self)
        if self.receivers_ss is not None and self.edge_weight is not None:
            return _SpmmGeneral.apply(h, self)
        out = self.scatter_weighted(_GatherRows.apply(h, self))
        if self.self_weight is not None:
            out = out + h * self.self_weight[:, None].to(h.dtype)
        return out

    def spmm_mean(self, h: torch.Tensor) -> torch.Tensor:
        """Mean-aggregated spmm: ``(A @ h) / max(in_degree, 1e-8)``; valid for
        unit edge weights (``has_unit_weights``)."""
        deg = self.in_degree.clamp_min(1e-8).to(h.dtype)
        return self.spmm(h) / deg[:, None]


class _GatherRows(torch.autograd.Function):
    """``h[senders]``; backward: cotangents permuted into sender-sorted order
    (``bwd_perm``) and summed by the sorted scatter over ``senders_sorted``.
    The permutation is read inside the scatter kernel."""

    @staticmethod
    def forward(ctx, h, graph):
        ctx.graph = graph
        return h.index_select(0, graph.senders)

    @staticmethod
    def backward(ctx, g):
        graph = ctx.graph
        dh = spmm_cuda.gather_scatter_sum_sorted(
            g.contiguous(), graph.bwd_perm, graph.senders_sorted,
            graph.row_ptr_bwd, graph.num_nodes,
        )
        return dh, None


class _Gatv2Attend(torch.autograd.Function):
    """Fused attention forward (one kernel; ``m``, ``l`` and, with the score
    cache, the scores kept) with the rho and receiver-backward kernels and
    the sender finish that ``ATTEND_BWD_MODE`` selects as its backward."""

    @staticmethod
    def forward(ctx, ht, att, graph, negative_slope, eps, drop_mask,
                drop_mask_ss):
        ht = ht.contiguous()
        att = att.contiguous()
        cache = ATTEND_SCORE_CACHE
        res = attend_cuda.sddmm_stats_agg_sorted(
            ht, graph.senders, graph.receivers, graph.row_ptr, att,
            edge_valid=graph.edge_mask, drop_mask=drop_mask,
            negative_slope=negative_slope, eps=eps, emit_scores=cache,
        )
        if cache:
            out, scores, m, l = res
        else:
            (out, m, l), scores = res, None
        ctx.save_for_backward(ht, att, scores, m, l)
        ctx.graph = graph
        ctx.drop_mask, ctx.drop_mask_ss = drop_mask, drop_mask_ss
        ctx.negative_slope, ctx.eps = negative_slope, eps
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        ht, att, scores, m, l = ctx.saved_tensors
        graph, drop_mask = ctx.graph, ctx.drop_mask
        mode = ATTEND_BWD_MODE
        if mode not in _ATTEND_BWD_MODES:
            raise ValueError(
                f"ATTEND_BWD_MODE must be one of {_ATTEND_BWD_MODES}, got "
                f"{mode!r}")
        g = g.contiguous()
        slope, eps = ctx.negative_slope, ctx.eps
        rho = attend_cuda.attend_rho_sorted(
            g, scores, m, l, ht, graph.senders, graph.receivers,
            graph.row_ptr, eps=eps, drop_mask=drop_mask, att=att,
            negative_slope=slope, edge_valid=graph.edge_mask,
        )
        recv_args = (ht, g, graph.senders, graph.receivers, graph.row_ptr,
                     att, scores, m, l, rho)
        recv_kw = dict(eps=eps, negative_slope=slope, drop_mask=drop_mask,
                       edge_valid=graph.edge_mask)
        # Dropout without the sender-order mask takes the permute finish.
        if mode == "send" and (drop_mask is None
                               or ctx.drop_mask_ss is not None):
            dht, datt = attend_cuda.attend_recv_bwd_full_sorted(
                *recv_args, emit_v=False, **recv_kw)
            dht_send = attend_cuda.attend_send_bwd_sorted(
                ht, g, graph.receivers_ss, graph.senders_sorted,
                graph.row_ptr_bwd, att, m, l, rho, eps=eps,
                negative_slope=slope, valid_ss=graph.edge_mask_ss,
                drop_ss=ctx.drop_mask_ss,
            )
            return dht + dht_send, datt, None, None, None, None, None
        dht, datt, v = attend_cuda.attend_recv_bwd_full_sorted(
            *recv_args, **recv_kw)
        if graph.attw_plan is not None:
            # Banded finish: the window-eligible slots straight from the
            # receiver-sorted v, the residual ones read through their
            # sender-sorted list (weight 0 on its padded entries).
            dht_band = band_cuda.window_scatter_sum(
                v, graph.attw_sender, graph.attw_plan)
            dht_res = spmm_cuda.gather_scatter_sum_sorted(
                v, graph.attw_perm_res, graph.attw_senders_res,
                graph.attw_res_row_ptr, graph.num_nodes,
                weights=graph.attw_res_weight,
            )
            return (dht + dht_band[: graph.num_nodes] + dht_res, datt, None,
                    None, None, None, None)
        dht_send = spmm_cuda.gather_scatter_sum_sorted(
            v, graph.bwd_perm, graph.senders_sorted, graph.row_ptr_bwd,
            graph.num_nodes,
        )
        return dht + dht_send, datt, None, None, None, None, None


class _EdgeSoftmax(torch.autograd.Function):
    """Masked slots to ``-inf``, then the statistics and normalisation
    kernels; backward ``prod - alpha * expand(scatter(prod))`` with
    ``prod = alpha * dalpha`` (padded slots: alpha is 0, so is their
    gradient)."""

    @staticmethod
    def forward(ctx, scores, graph, eps):
        s = scores.float()
        if graph.edge_mask is not None:
            s = s.masked_fill(~graph.edge_mask[:, None], float("-inf"))
        s = s.contiguous()
        m, l = softmax_cuda.softmax_stats_sorted(
            s, graph.receivers, graph.row_ptr, graph.num_nodes)
        alpha = softmax_cuda.softmax_apply_sorted(
            s, m, l, graph.receivers, eps=eps, out_dtype=scores.dtype)
        ctx.save_for_backward(alpha)
        ctx.graph = graph
        return alpha

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dalpha):
        (alpha,) = ctx.saved_tensors
        graph = ctx.graph
        prod = (alpha * dalpha).contiguous()
        rho = spmm_cuda.scatter_sum_sorted(
            prod, graph.receivers, graph.num_nodes, row_ptr=graph.row_ptr)
        rho_e = spmm_cuda.expand_sorted(
            rho, graph.receivers, row_ptr=graph.row_ptr)
        return prod - alpha * rho_e, None, None


class _Sddmm(torch.autograd.Function):
    """Score kernel forward; backward: the score-backward kernel (``d_pre``,
    ``d att``), both over the pieces of ``graph.row_ptr``, then ``d ht`` as
    ``d_pre`` summed by receiver with the sorted scatter. ``d hj = d_pre``
    returns to the caller's gather."""

    @staticmethod
    def forward(ctx, ht, hj, att, graph, negative_slope):
        ht, hj, att = ht.contiguous(), hj.contiguous(), att.contiguous()
        scores = sddmm_cuda.sddmm_scores_sorted(
            ht, hj, att, graph.receivers, negative_slope=negative_slope,
            row_ptr=graph.row_ptr)
        ctx.save_for_backward(ht, hj, att)
        ctx.graph = graph
        ctx.negative_slope = negative_slope
        return scores

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        ht, hj, att = ctx.saved_tensors
        graph = ctx.graph
        d_pre, datt = sddmm_cuda.sddmm_bwd_sorted(
            ht, hj, att, g.float().contiguous(), graph.receivers,
            negative_slope=ctx.negative_slope, row_ptr=graph.row_ptr)
        dht = spmm_cuda.scatter_sum_sorted(
            d_pre, graph.receivers, graph.num_nodes, row_ptr=graph.row_ptr)
        return dht.to(ht.dtype), d_pre, datt, None, None


# The GCN's operator (the three Functions below) takes the fused-gather
# scatter's row walk (pieces=False): on the H100 its piece walk, which the
# attention's finishes and the gather's VJP take, was 9% faster at the
# arxiv-shaped GCN's first layer (F = 128) but 7% slower at its second (F =
# 40), with and without the padded tail (PERF.md, section 6).


class _SpmmSymmetric(torch.autograd.Function):
    """Weighted spmm over a symmetric adjacency: ``A^T = A``, so the
    cotangent flows through the same operator (re-entering the Function keeps
    higher-order gradients valid; nothing is saved)."""

    @staticmethod
    def forward(ctx, h, graph):
        ctx.graph = graph
        return spmm_cuda.gather_scatter_sum_sorted(
            h.contiguous(), graph.senders, graph.receivers, graph.row_ptr,
            graph.num_nodes, weights=graph.edge_weight,
            self_weight=graph.self_weight, pieces=False,
        )

    @staticmethod
    def backward(ctx, g):
        return _SpmmSymmetric.apply(g, ctx.graph), None


class _SpmmGeneral(torch.autograd.Function):
    """Weighted spmm over a (possibly) asymmetric adjacency. Backward:
    ``dh = A^T g`` built directly in sender-sorted order: the node cotangent
    gathered by receivers-in-sender-order, summed over the transposed
    orientation. Valid because the per-edge message is linear in ``h``."""

    @staticmethod
    def forward(ctx, h, graph):
        ctx.graph = graph
        return spmm_cuda.gather_scatter_sum_sorted(
            h.contiguous(), graph.senders, graph.receivers, graph.row_ptr,
            graph.num_nodes, weights=graph.edge_weight,
            self_weight=graph.self_weight, pieces=False,
        )

    @staticmethod
    def backward(ctx, g):
        return _SpmmGeneralTransposed.apply(g, ctx.graph), None


class _SpmmGeneralTransposed(torch.autograd.Function):
    """``A^T @ g`` of :class:`_SpmmGeneral`; its own backward is ``A``."""

    @staticmethod
    def forward(ctx, g, graph):
        ctx.graph = graph
        return spmm_cuda.gather_scatter_sum_sorted(
            g.contiguous(), graph.receivers_ss, graph.senders_sorted,
            graph.row_ptr_bwd, graph.num_nodes, weights=graph.edge_weight_ss,
            self_weight=graph.self_weight, pieces=False,
        )

    @staticmethod
    def backward(ctx, gg):
        return _SpmmGeneral.apply(gg, ctx.graph), None


def _map_tensors(obj, fn):
    """``obj`` (a context or a plan) with ``fn(field name, tensor)`` applied
    to each tensor field, descending into nested contexts and plans."""
    changes = {}
    for field in dataclasses.fields(obj):
        value = getattr(obj, field.name)
        if isinstance(value, torch.Tensor):
            changes[field.name] = fn(field.name, value)
        elif dataclasses.is_dataclass(value):
            changes[field.name] = _map_tensors(value, fn)
    return dataclasses.replace(obj, **changes)


def _row_ptr(sorted_ids: np.ndarray, num_nodes: int) -> np.ndarray:
    return np.searchsorted(
        sorted_ids, np.arange(num_nodes + 1), side="left"
    ).astype(np.int32)


def prepare_graph(
    edge_index: np.ndarray,
    num_nodes: int,
    *,
    add_self_loops: bool = False,
    gcn_normalize: bool = False,
    edge_weight: np.ndarray | None = None,
    edge_chunk: int = 1024,
    symmetric: bool = False,
    densify_self_loops: bool = False,
    scatter_row_block: int = 256,
    expand_row_block: int = 128,
    pad_nodes: bool = False,
    band_window: int | None = None,
    band_row_block: int = 256,
    pad_to: int | None = None,
    attend_full_stream: bool | None = None,
    attend_window: int | None = None,
    attend_window_chunk: int = 2048,
    device: torch.device | str = torch.device("cuda"),
) -> GraphContext:
    """One-time host preprocessing into a :class:`GraphContext` on ``device``.

    Sorts edges by receiver (native counting sort when available), builds
    both orientations' row pointers, optionally folds in self-loops and GCN
    normalization.

    ``densify_self_loops=True`` (requires ``add_self_loops=True``) keeps the
    appended self-loops OUT of the edge stream and stores their weights as a
    dense per-node ``self_weight`` vector; ``spmm()`` applies the diagonal in
    the kernel's epilogue. Only valid for linear per-edge messages.

    ``pad_nodes=True`` rounds ``num_nodes`` up to a multiple of
    ``max(scatter_row_block, expand_row_block)`` (256 by default), and of the
    locality tiers' grains below: node arrays are then supplied and returned
    with that many rows. Padded rows have no edges and zero self-weight. The
    edge axis is padded to a multiple of ``edge_chunk``; padded slots point
    at node ``num_nodes - 1`` in both orientations and carry weight 0, so
    every weighted op ignores them. (These grains keep the prepared arrays
    equal to the reference context's; the kernels themselves take any size.)

    ``band_window=W`` (requires ``pad_nodes=True``; ``W`` a multiple of 256)
    enables the banded tier: the edges that fit a ``W``-row window in both
    orientations are stored as a dense band (``kernels/band_cuda.py``) and
    removed from the CSR stream. It pays only after a locality reordering
    (``ops/reorder.py``); on a random numbering nearly every edge stays in
    the residual. ``band_row_block`` is the band's row block.

    ``attend_full_stream``: banded or densified contexts have an incomplete
    CSR stream, so per-edge ops (gather, attend, edge_softmax, sddmm) need a
    companion context holding every edge (``ctx.full``), built here with the
    same padded node count. Default: True for band contexts, False
    otherwise. ``pad_to`` forces the padded node count (keeps the
    companion's shapes aligned).

    ``attend_window=W`` (requires ``pad_nodes=True``) builds the banded
    attention backward's tables on the context whose stream holds every edge
    (this one, or the companion): each receiver-sorted chunk of
    ``attend_window_chunk`` slots gets the ``W``-aligned node window holding
    most of its senders, and those slots' sender cotangents are summed by
    the window scatter kernel instead of the fused-gather scatter. The
    stream is then padded to ``attend_window_chunk``. Exact either way.
    """
    edge_index = np.asarray(edge_index)
    if edge_index.shape[0] != 2:
        edge_index = edge_index.T
    s = edge_index[0].astype(np.int64)
    r = edge_index[1].astype(np.int64)
    orig_s, orig_r = s.copy(), r.copy()
    orig_edge_weight = (
        None if edge_weight is None else np.asarray(edge_weight).copy()
    )
    if attend_full_stream is None:
        attend_full_stream = band_window is not None
    num_real_nodes = num_nodes
    if band_window is not None and not pad_nodes:
        raise ValueError("band_window requires pad_nodes=True")
    if attend_window is not None and not pad_nodes:
        raise ValueError("attend_window requires pad_nodes=True")
    base_grain = max(scatter_row_block, expand_row_block)
    if pad_nodes:
        grain = base_grain
        if band_window is not None:
            grain = max(grain, band_window // 2, band_row_block)
        if attend_window is not None:
            grain = max(grain, attend_window)
        num_nodes = -(-num_nodes // grain) * grain
        if band_window is not None:
            num_nodes = max(num_nodes, band_window)
    if pad_to is not None:
        if not pad_nodes:
            raise ValueError("pad_to requires pad_nodes=True")
        if pad_to < num_nodes or pad_to % base_grain:
            raise ValueError(
                f"pad_to={pad_to} incompatible with computed padded "
                f"node count {num_nodes}"
            )
        num_nodes = pad_to
    if symmetric:
        # Symmetry of the *weighted* adjacency lets spmm() reuse itself as its
        # own gradient. GCN normalization and self-loops preserve symmetry;
        # arbitrary user edge_weight would not.
        if edge_weight is not None:
            raise ValueError(
                "symmetric=True supports only structural weights "
                "(gcn_normalize); arbitrary edge_weight breaks Aᵀ=A."
            )
        fwd = np.sort(s * num_nodes + r)
        rev = np.sort(r * num_nodes + s)
        if not np.array_equal(fwd, rev):
            raise ValueError(
                "symmetric=True but the edge multiset is not symmetric"
            )
    self_weight = None
    num_diag = 0
    densified_norm = None
    if densify_self_loops:
        if not add_self_loops:
            raise ValueError(
                "densify_self_loops=True requires add_self_loops=True "
                "(it densifies the loops that would have been appended)"
            )
        num_diag = num_real_nodes
        if gcn_normalize:
            # Weights computed over the FULL edge list including the appended
            # loops, then split: real-edge weights stay in the stream, loop
            # weights become the dense diagonal. Loops are added for REAL
            # nodes only; padded rows keep self_weight 0.
            loops = np.arange(num_real_nodes, dtype=np.int64)
            s_full = np.concatenate([s, loops]).astype(np.int32)
            r_full = np.concatenate([r, loops]).astype(np.int32)
            w_full = native.gcn_norm_weights(s_full, r_full, num_nodes)
            densified_norm = np.asarray(w_full[: s.shape[0]], np.float32)
            self_weight = np.asarray(w_full[s.shape[0]:], np.float32)
        else:
            self_weight = np.ones(num_real_nodes, np.float32)
        if num_nodes > num_real_nodes:
            self_weight = np.concatenate(
                [self_weight, np.zeros(num_nodes - num_real_nodes, np.float32)]
            )
    elif add_self_loops:
        loops = np.arange(num_real_nodes, dtype=np.int64)
        s = np.concatenate([s, loops])
        r = np.concatenate([r, loops])
        if edge_weight is not None:
            edge_weight = np.concatenate(
                [np.asarray(edge_weight), np.ones(num_real_nodes, np.float32)]
            )

    # Resolve per-edge weights BEFORE any split or sort: the GCN norm is a
    # per-edge function of endpoint degrees, hence order-independent.
    w_resolved = None
    if gcn_normalize:
        if densified_norm is not None:
            w_resolved = densified_norm
        else:
            w_resolved = native.gcn_norm_weights(
                s.astype(np.int32), r.astype(np.int32), num_nodes
            )
    if edge_weight is not None:
        ew = np.asarray(edge_weight, np.float32)
        w_resolved = ew if w_resolved is None else w_resolved * ew

    # Full-stream in-degree (spmm_mean semantics), before any band split.
    in_degree = np.bincount(r, minlength=num_nodes).astype(np.float32)

    band_plan = band_plan_bwd = None
    if band_window is not None:
        # Keep the CSR stream non-empty: on an all-local graph the first edge
        # (and, for symmetry of the band, its mirror) stays in the residual.
        exclude = None
        band_plan, local = band_cuda.build_band_plan(
            s, r, w_resolved, num_nodes,
            window=band_window, row_block=band_row_block,
        )
        if local.all():
            # All copies of the first edge and of its mirror, so the band
            # stays exactly symmetric under multi-edges.
            exclude = (s == s[0]) & (r == r[0])
            if symmetric:
                exclude |= (s == r[0]) & (r == s[0])
            band_plan, local = band_cuda.build_band_plan(
                s, r, w_resolved, num_nodes,
                window=band_window, row_block=band_row_block,
                exclude=exclude,
            )
        if not symmetric:
            # The fit criterion is endpoint-symmetric, so the transposed
            # orientation bands exactly the same edge subset.
            band_plan_bwd, _ = band_cuda.build_band_plan(
                r, s, w_resolved, num_nodes,
                window=band_window, row_block=band_row_block,
                exclude=exclude,
            )
        keep = ~local
        s, r = s[keep], r[keep]
        if w_resolved is not None:
            w_resolved = w_resolved[keep]

    perm_r, _ = native.coo_to_csr_perm(r.astype(np.int32), num_nodes)
    s_sorted_by_r = s[perm_r].astype(np.int32)
    r_sorted = r[perm_r].astype(np.int32)
    e_real = int(s_sorted_by_r.shape[0])
    if w_resolved is None:
        w = np.ones(e_real, np.float32)
    else:
        w = np.asarray(w_resolved, np.float32)[perm_r]

    # With attend_window tables on this context the stream is padded to the
    # window scatter's (coarser) chunk grain.
    attw_here = attend_window is not None and band_plan is None and num_diag == 0
    e_grain = max(edge_chunk, attend_window_chunk) if attw_here else edge_chunk
    e_pad = ((e_real + e_grain - 1) // e_grain) * e_grain
    pad = e_pad - e_real
    last = max(num_nodes - 1, 0)
    s_p = np.concatenate([s_sorted_by_r, np.full(pad, last, np.int32)])
    r_p = np.concatenate([r_sorted, np.full(pad, last, np.int32)])
    w_p = np.concatenate([w, np.zeros(pad, np.float32)])

    # Transposed orientation: sort (receiver-sorted, padded) edges by sender.
    perm_s, _ = native.coo_to_csr_perm(s_p, num_nodes)
    senders_sorted = s_p[perm_s]
    receivers_ss = r_p[perm_s]
    weight_ss = w_p[perm_s]

    full_ctx = None
    if attend_full_stream and (band_plan is not None or num_diag > 0):
        full_ctx = prepare_graph(
            np.stack([orig_s, orig_r]),
            num_real_nodes,
            add_self_loops=add_self_loops,
            gcn_normalize=gcn_normalize,
            edge_weight=orig_edge_weight,
            edge_chunk=edge_chunk,
            symmetric=symmetric,
            densify_self_loops=False,
            scatter_row_block=scatter_row_block,
            expand_row_block=expand_row_block,
            pad_nodes=pad_nodes,
            band_window=None,
            pad_to=num_nodes if pad_nodes else None,
            attend_window=attend_window,
            attend_window_chunk=attend_window_chunk,
            device=device,
        )

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    # Banded attention backward tables, on the context whose stream holds
    # every edge: this one when no band/densify split happened, otherwise
    # the companion above (through the recursive call).
    attw = {}
    if attw_here:
        eligible = np.arange(e_pad) < e_real
        plan, band_mask, sender_tab = band_cuda.build_window_scatter_plan(
            s_p, num_nodes, eligible,
            window=attend_window, edge_chunk=attend_window_chunk,
        )
        idx_res = np.nonzero(eligible & ~band_mask)[0]
        order_res = np.argsort(s_p[idx_res], kind="stable")
        perm_res = idx_res[order_res].astype(np.int32)
        er = perm_res.shape[0]
        er_pad = max(
            ((er + edge_chunk - 1) // edge_chunk) * edge_chunk, edge_chunk
        )
        padr = er_pad - er
        # Padded residual entries point at slot 0 with weight 0: neutral
        # whatever v holds there.
        perm_res = np.concatenate([perm_res, np.zeros(padr, np.int32)])
        res_weight = np.concatenate(
            [np.ones(er, np.float32), np.zeros(padr, np.float32)]
        )
        senders_res = np.concatenate(
            [s_p[perm_res[:er]], np.full(padr, last, np.int32)]
        )
        attw = dict(
            attw_plan=_map_tensors(plan, lambda _name, t: t.to(device)),
            attw_sender=dev(sender_tab),
            attw_perm_res=dev(perm_res),
            attw_res_weight=dev(res_weight),
            attw_senders_res=dev(senders_res),
            attw_res_row_ptr=dev(_row_ptr(senders_res, num_nodes)),
        )

    def dev_plan(plan):
        if plan is None:
            return None
        return _map_tensors(plan, lambda _name, t: t.to(device))

    return GraphContext(
        senders=dev(s_p),
        receivers=dev(r_p),
        edge_weight=dev(w_p),
        num_nodes=num_nodes,
        row_ptr=dev(_row_ptr(r_p, num_nodes)),
        bwd_perm=dev(perm_s.astype(np.int32)),
        senders_sorted=dev(senders_sorted),
        row_ptr_bwd=dev(_row_ptr(senders_sorted, num_nodes)),
        num_real_edges=e_real,
        edge_mask=dev(np.arange(e_pad) < e_real),
        in_degree=dev(in_degree),
        is_symmetric=symmetric,
        self_weight=None if self_weight is None else dev(self_weight),
        num_diag=num_diag,
        num_real_nodes=num_real_nodes,
        receivers_ss=dev(receivers_ss),
        edge_weight_ss=dev(weight_ss),
        has_unit_weights=(not gcn_normalize) and edge_weight is None,
        edge_mask_ss=(
            None if pad == 0 else dev((perm_s < e_real).astype(np.float32))
        ),
        band=dev_plan(band_plan),
        band_bwd=dev_plan(band_plan_bwd),
        num_band_edges=0 if band_plan is None else band_plan.num_edges,
        full=full_ctx,
        **attw,
    )
