"""SpMM dispatch tier: scatter-reduce of edge messages into node rows.

Counterpart of the JAX package's ``ops/spmm.py``. Dispatch policy:

- the hand-written CUDA kernel (``kernels.spmm_cuda.scatter_sum_sorted``) when
  the edges are receiver-sorted, ``row_ptr`` from graph preparation is given
  and the data lies on a CUDA device;
- otherwise the library segment sum (``ops.segment``), which takes unsorted
  ids on any device.

Both are differentiable and agree up to the order of summation.
"""

from __future__ import annotations

import torch

from ..kernels import spmm_cuda
from . import segment

__all__ = ["scatter_sum"]


def scatter_sum(
    messages: torch.Tensor,
    receivers: torch.Tensor,
    num_nodes: int,
    *,
    mask: torch.Tensor | None = None,
    indices_are_sorted: bool = False,
    row_ptr: torch.Tensor | None = None,
) -> torch.Tensor:
    """Sum-reduce ``[E, F]`` messages into ``[N, F]`` node rows."""
    if row_ptr is not None and indices_are_sorted and messages.is_cuda:
        return spmm_cuda.scatter_sum_sorted(
            messages, receivers, num_nodes, mask=mask, row_ptr=row_ptr
        )
    return segment.segment_sum(messages, receivers, num_nodes, mask=mask)
