"""Per-edge attention dropout masks in both edge orders.

Counterpart of the JAX package's ``ops/edge_dropout.py``. The contract is the
reference's: a pre-scaled keep mask ``[E, H]`` (``1/keep`` or ``0``:
attention dropout after normalisation with inverted scaling), available in
receiver-sorted order and, entry for entry the same, in sender-sorted order.
The scheme is not: the reference defines the mask counter-mode, as a hash of
the edge's slot, so that the second order needs no permute; here the mask is
one draw from an explicit ``torch.Generator`` and the second order is one
``index_select`` of it. The random stream is PyTorch's, so tests that compare
with the reference pass the mask in explicitly on both sides.
"""

from __future__ import annotations

import torch

__all__ = ["keep_mask_at", "attention_keep_masks"]


def keep_mask_at(
    generator: torch.Generator | None,
    positions: torch.Tensor | None,
    heads: int,
    rate: float,
    dtype: torch.dtype = torch.float32,
    *,
    num_edges: int | None = None,
    device=None,
) -> torch.Tensor:
    """``[len(positions), heads]`` pre-scaled keep mask (``1/keep`` or 0).

    Draws the canonical ``[num_edges, heads]`` mask (one row per
    receiver-sorted slot; ``num_edges`` defaults to ``len(positions)``) from
    ``generator`` and reads it at ``positions``; ``positions=None`` returns
    the canonical mask itself. The same generator state gives the same mask.
    """
    if positions is not None:
        device = positions.device
        if num_edges is None:
            num_edges = int(positions.shape[0])
    if num_edges is None:
        raise ValueError("num_edges is required when positions is None")
    keep = 1.0 - float(rate)
    u = torch.rand((num_edges, heads), generator=generator, device=device)
    mask = torch.where(u < keep, 1.0 / keep, 0.0).to(dtype)
    if positions is None:
        return mask
    return mask.index_select(0, positions.long())


def attention_keep_masks(
    generator: torch.Generator | None,
    num_edges: int,
    perm: torch.Tensor,  # [E] int32: sender-sorted slot -> receiver slot
    heads: int,
    rate: float,
    dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The same random mask in both edge orders.

    Returns ``(mask, mask_ss)``: ``mask`` indexed by receiver-sorted slot
    (the canonical stream order), ``mask_ss[j] == mask[perm[j]]`` exactly.
    """
    mask = keep_mask_at(generator, None, heads, rate, dtype,
                        num_edges=num_edges, device=perm.device)
    return mask, mask.index_select(0, perm.long())
