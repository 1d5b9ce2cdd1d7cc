"""Propagation precompute: hoist loop-invariant SpMMs out of training.

On a static full graph the first GCN layer's propagation ``S @ X`` involves no
parameters, so it can be computed once and the layer becomes a dense matmul::

    out_1 = S (X W_1) = (S X) W_1          # linearity
    dW_1  = (S X)^T g_1                    # backward is dense too

Exact whenever the first layer's per-edge message is linear in the node
features and nothing stochastic sits between ``X`` and the propagation (GCN
qualifies). ``hops=k`` returns ``S^k X`` for SGC-style models.
"""

from __future__ import annotations

import torch

__all__ = ["precompute_propagation"]


@torch.no_grad()
def precompute_propagation(context, x: torch.Tensor, *, hops: int = 1):
    """Return ``S^hops @ x`` computed once with the context's SpMM::

        sx = precompute_propagation(ctx, x)          # once
        h1 = act(sx @ W1 + b1)                       # per step: dense only
    """
    if hops < 1:
        raise ValueError(f"hops must be >= 1, got {hops}")
    for _ in range(hops):
        x = context.spmm(x)
    return x
