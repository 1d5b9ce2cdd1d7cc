"""Segment (scatter-reduce) operations over unsorted or sorted ids.

Counterpart of the JAX package's ``ops/segment.py`` for the two reductions
the GCN path needs. These are the library-op tier (``index_add_``), as the
reference computes them outside any hand-written kernel; the sorted-CSR
kernels live in ``kernels/spmm_cuda.py``.
"""

from __future__ import annotations

import torch

__all__ = ["segment_sum", "segment_count"]


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
