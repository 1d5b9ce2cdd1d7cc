"""Graph Isomorphism Network layer (Xu et al. 2019).

``h' = MLP((1 + eps) * h + AGG_{j in N(i)} h_j)``

Counterpart of the JAX package's ``nn/gin_conv.py``; the contract is the
reference's:

- aggregator one of mean, max, sum;
- eps fixed at ``eps_init``, or a trainable ``[1]`` parameter ``eps``
  starting there (``train_eps=True``);
- MLP = ``[Dense(h, act) + Dropout]* + Dense(out, linear)``, the sub-module
  ``mlp`` (``mlp.dense_0 ..``);
- a graph without edges computes ``MLP((1 + eps) x)``; an empty graph
  returns ``[0, out]``.

With a :class:`~keras_geometric_tpu_torch.ops.csr.GraphContext`, sum and
mean over unit edge weights run ``spmm`` / ``spmm_mean`` (the fused-gather
scatter kernel, no ``[E, F]`` array); otherwise the per-edge path gathers the
messages from the full-stream context and scatters them (sum, mean), or
takes their receiver max with the wide segment max kernel (``scatter_max``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.graph_ops import ensure_edge_index
from .aggregators import aggregate
from .module import MLP, Module

__all__ = ["GINConv"]

_VALID_AGGREGATORS = ("mean", "max", "sum")


class GINConv(Module):
    """GIN convolution with a configurable MLP and a fixed or trainable eps."""

    def __init__(
        self,
        output_dim: int,
        *,
        input_dim: int,
        mlp_hidden: tuple[int, ...] = (),
        aggregator: str = "sum",
        eps_init: float = 0.0,
        train_eps: bool = False,
        use_bias: bool = True,
        activation: str | None = "relu",
        dropout_rate: float = 0.0,
        kernel_initializer: str = "glorot_uniform",
        bias_initializer: str = "zeros",
        generator: torch.Generator | None = None,
        device: torch.device | str = "cuda",
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self._keep_config(locals())
        if aggregator not in _VALID_AGGREGATORS:
            raise ValueError(
                f"Invalid aggregator: {aggregator}. "
                f"Must be one of {list(_VALID_AGGREGATORS)}"
            )
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.mlp_hidden = tuple(mlp_hidden)
        self.aggregator = aggregator
        self.eps_init = eps_init
        self.train_eps = train_eps
        self.mlp = MLP(
            self.mlp_hidden, output_dim, input_dim=input_dim,
            activation=activation, use_bias=use_bias,
            dropout_rate=dropout_rate, kernel_initializer=kernel_initializer,
            bias_initializer=bias_initializer, generator=generator,
            device=device, dtype=dtype,
        )
        if train_eps:
            self.eps = nn.Parameter(
                torch.full((1,), eps_init, dtype=dtype, device=device))
        else:
            self.register_parameter("eps", None)

    def forward(
        self,
        x: torch.Tensor,
        edge_index: torch.Tensor | None = None,
        *,
        edge_mask: torch.Tensor | None = None,
        indices_are_sorted: bool = False,
        context=None,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        num_nodes = x.shape[0]
        if num_nodes == 0:
            return torch.zeros((0, self.output_dim), dtype=x.dtype,
                               device=x.device)
        eps = self.eps if self.train_eps else self.eps_init

        if context is not None:
            if context.has_unit_weights and self.aggregator == "sum":
                agg = context.spmm(x)
            elif context.has_unit_weights and self.aggregator == "mean":
                agg = context.spmm_mean(x)
            else:
                # Per-edge paths need every edge in the stream: band and
                # densified contexts route through the full companion.
                fctx = context.full_stream()
                messages = fctx.gather(x)
                if self.aggregator == "sum":
                    agg = fctx.scatter(messages, masked=True)
                elif self.aggregator == "mean":
                    agg = fctx.scatter_mean(messages)
                else:
                    agg = fctx.scatter_max(messages)
            return self.mlp((1 + eps) * x + agg, generator=generator)
        if edge_index is None:
            raise ValueError("edge_index required when no context is given")

        edge_index = torch.as_tensor(edge_index, device=x.device)
        if edge_index.numel() == 0:
            return self.mlp((1 + eps) * x, generator=generator)
        edge_index = ensure_edge_index(edge_index)
        senders, receivers = edge_index[0], edge_index[1]
        messages = x.index_select(0, senders.long())
        agg = aggregate(
            self.aggregator, messages, receivers, num_nodes, mask=edge_mask,
            indices_are_sorted=indices_are_sorted,
        )
        return self.mlp((1 + eps) * x + agg, generator=generator)
