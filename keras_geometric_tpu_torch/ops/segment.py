"""Segment (scatter-reduce) operations over unsorted or sorted ids.

Counterpart of the JAX package's ``ops/segment.py`` for the reductions the
GCN and GATv2 layers need on a plain ``edge_index``. These are the library-op
tier (``index_add_``, ``scatter_reduce``), as the reference computes them
outside any hand-written kernel; the sorted-CSR kernels live in
``kernels/spmm_cuda.py`` and ``kernels/attend_cuda.py``.
"""

from __future__ import annotations

import torch

__all__ = ["segment_sum", "segment_count", "segment_max", "segment_softmax"]


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
) -> torch.Tensor:
    """Sum of ``data`` within each segment; masked entries contribute zero."""
    m = _mask_like(data, mask)
    if m is not None:
        data = torch.where(m, data, torch.zeros_like(data))
    out = torch.zeros(
        (num_segments,) + tuple(data.shape[1:]), dtype=data.dtype,
        device=data.device,
    )
    return out.index_add(0, segment_ids.long(), data)


def segment_count(
    segment_ids: torch.Tensor,
    num_segments: int,
    *,
    mask: torch.Tensor | None = None,
    dtype: torch.dtype = torch.float32,
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
) -> torch.Tensor:
    """Max per segment; empty segments produce 0 (the reference's fixup)."""
    out = _raw_segment_max(data, segment_ids, num_segments, mask)
    return torch.where(torch.isinf(out), torch.zeros_like(out), out)


def segment_softmax(
    scores: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    *,
    mask: torch.Tensor | None = None,
    eps: float = 1e-10,
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
