"""Segment (scatter-reduce) operations over unsorted or sorted ids.

Counterpart of the JAX package's ``ops/segment.py``: the reductions every
message-passing layer uses on a plain ``edge_index``, with the reference's
numerics (mean: degree clamped at ``1e-8``; max / min: ``0`` for an empty
segment; std: population variance, ``0`` where a segment holds at most one
entry; softmax: max-shifted, ``+eps`` in the denominator). These are the
library-op tier (``index_add_``, ``scatter_reduce``), as the reference
computes them in XLA outside any hand-written kernel; the sorted-CSR kernels
live in ``kernels/spmm_cuda.py`` and ``kernels/attend_cuda.py``.

Every op takes ``indices_are_sorted=`` as the reference's do. XLA uses it to
pick a segmented reduction; these library ops take any order, so it is
accepted and has no effect. The max's gradient splits a tied segment's
cotangent evenly among its tied entries, as XLA's does. Sums of 16-bit data
(and the std as a whole) are taken in f32 and rounded once: ``index_add_``
of bf16 on the card adds in bf16 with atomics, in an order that changes from
run to run.
"""

from __future__ import annotations

import torch

__all__ = [
    "segment_sum",
    "segment_mean",
    "segment_max",
    "segment_min",
    "segment_std",
    "segment_count",
    "segment_softmax",
]


def _mask_like(data: torch.Tensor, mask: torch.Tensor | None):
    """Broadcast a ``[E]`` bool mask against ``[E, ...]`` data."""
    if mask is None:
        return None
    return mask.reshape(mask.shape + (1,) * (data.ndim - mask.ndim))


def segment_sum(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    *,
    mask: torch.Tensor | None = None,
    indices_are_sorted: bool = False,
) -> torch.Tensor:
    """Sum of ``data`` within each segment; masked entries contribute zero."""
    m = _mask_like(data, mask)
    if m is not None:
        data = torch.where(m, data, torch.zeros_like(data))
    acc = torch.float32 if data.element_size() < 4 else data.dtype
    out = torch.zeros(
        (num_segments,) + tuple(data.shape[1:]), dtype=acc,
        device=data.device,
    )
    return out.index_add(0, segment_ids.long(), data.to(acc)).to(data.dtype)


def segment_count(
    segment_ids: torch.Tensor,
    num_segments: int,
    *,
    mask: torch.Tensor | None = None,
    dtype: torch.dtype = torch.float32,
    indices_are_sorted: bool = False,
) -> torch.Tensor:
    """Number of (unmasked) entries per segment. Returns ``[num_segments]``."""
    ones = torch.ones(segment_ids.shape, dtype=dtype, device=segment_ids.device)
    return segment_sum(ones, segment_ids, num_segments, mask=mask)


def _raw_segment_max(data, segment_ids, num_segments, mask):
    """Max per segment with ``-inf`` for empty (or fully masked) segments."""
    m = _mask_like(data, mask)
    if m is not None:
        data = data.masked_fill(~m, float("-inf"))
    out = torch.full(
        (num_segments,) + tuple(data.shape[1:]), float("-inf"),
        dtype=data.dtype, device=data.device,
    )
    index = segment_ids.long().reshape(
        (-1,) + (1,) * (data.ndim - 1)).expand_as(data)
    return out.scatter_reduce(0, index, data, "amax")


def segment_max(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    *,
    mask: torch.Tensor | None = None,
    indices_are_sorted: bool = False,
) -> torch.Tensor:
    """Max per segment; empty segments produce 0 (the reference's fixup)."""
    out = _raw_segment_max(data, segment_ids, num_segments, mask)
    return torch.where(torch.isinf(out), torch.zeros_like(out), out)


def segment_mean(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    *,
    mask: torch.Tensor | None = None,
    indices_are_sorted: bool = False,
) -> torch.Tensor:
    """Mean with the reference's 1e-8 degree clamp (empty segments -> 0)."""
    total = segment_sum(data, segment_ids, num_segments, mask=mask)
    count = segment_count(segment_ids, num_segments, mask=mask,
                          dtype=total.dtype)
    count = count.clamp_min(1e-8)
    return total / count.reshape(count.shape + (1,) * (total.ndim - 1))


def segment_min(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    *,
    mask: torch.Tensor | None = None,
    indices_are_sorted: bool = False,
) -> torch.Tensor:
    """Min per segment via the negated max; empty segments produce 0."""
    out = -_raw_segment_max(-data, segment_ids, num_segments, mask)
    return torch.where(torch.isinf(out), torch.zeros_like(out), out)


def segment_std(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    *,
    mask: torch.Tensor | None = None,
    indices_are_sorted: bool = False,
) -> torch.Tensor:
    """Population std per segment (N divisor); 0 where count <= 1."""
    if data.element_size() < 4:
        return segment_std(data.float(), segment_ids, num_segments,
                           mask=mask).to(data.dtype)
    count = segment_count(segment_ids, num_segments, mask=mask,
                          dtype=data.dtype)
    safe_count = count.clamp_min(1e-8)
    total = segment_sum(data, segment_ids, num_segments, mask=mask)
    bshape = count.shape + (1,) * (data.ndim - 1)
    mean = total / safe_count.reshape(bshape)
    sq_diff = torch.square(data - mean.index_select(0, segment_ids.long()))
    sum_sq = segment_sum(sq_diff, segment_ids, num_segments, mask=mask)
    var = sum_sq / safe_count.reshape(bshape)
    std = torch.sqrt(var.clamp_min(0.0))
    return torch.where(count.reshape(bshape) <= 1, torch.zeros_like(std), std)


def segment_softmax(
    scores: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    *,
    mask: torch.Tensor | None = None,
    eps: float = 1e-10,
    indices_are_sorted: bool = False,
) -> torch.Tensor:
    """Softmax over entries sharing a segment id (per-target edge softmax).

    Scores are max-shifted per segment and the denominator carries ``+eps``.
    Masked entries get weight 0 and do not contribute to the normalizer; an
    empty or fully masked segment has max 0, so ``exp`` stays finite.
    """
    ids = segment_ids.long()
    seg_max = segment_max(scores, ids, num_segments, mask=mask)
    exp = torch.exp(scores - seg_max.index_select(0, ids))
    m = _mask_like(scores, mask)
    if m is not None:
        exp = torch.where(m, exp, torch.zeros_like(exp))
    denom = segment_sum(exp, ids, num_segments)
    return exp / (denom.index_select(0, ids) + eps)
