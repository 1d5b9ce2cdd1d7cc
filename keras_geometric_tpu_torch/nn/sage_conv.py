"""GraphSAGE convolution (Hamilton et al. 2017).

``h' = act(W_self h + W_neigh AGG(h_j) + b)`` with an optional L2 normalize.

Counterpart of the JAX package's ``nn/sage_conv.py``; the contract is the
reference's:

- aggregators mean, max, sum, min, std and pooling; ``pooling`` is the
  elementwise max over ``Dense(pool_dim, pool_activation)`` of the neighbour
  features (the sub-module ``pool_mlp``);
- ``lin_neigh`` / ``lin_self`` are bias-free Dense layers, and one shared
  ``bias`` (zeros at first) is added after they are combined;
- dropout on the neighbour messages and, separately, on the root features
  before ``lin_self``;
- a graph without edges aggregates to zeros (of the pool width for
  ``pooling``), so the output is ``act(W_self x + b)``;
- activation relu by default; optional L2 normalization over features.

With a :class:`~keras_geometric_tpu_torch.ops.csr.GraphContext`: sum and mean
over unit edge weights without message dropout run ``spmm`` / ``spmm_mean``;
otherwise the messages are gathered from the full-stream context, and sum
and mean scatter them, max and pooling take their receiver max with the wide
segment max kernel (``scatter_max``), min takes it over the negated
messages, and std goes through :func:`~.aggregators.aggregate`. A context is
built for one node set, so bipartite inputs are refused there.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.graph_ops import ensure_edge_index
from ..ops.segment import segment_max
from .aggregators import aggregate
from .module import Dense, Module, dropout, get_activation

__all__ = ["SAGEConv"]

_VALID_AGGREGATORS = ("mean", "max", "sum", "min", "std", "pooling")


class SAGEConv(Module):
    """GraphSAGE convolution with six aggregation strategies."""

    def __init__(
        self,
        output_dim: int,
        *,
        input_dim: int,
        aggregator: str = "mean",
        normalize: bool = False,
        root_weight: bool = True,
        use_bias: bool = True,
        activation: str | None = "relu",
        pool_activation: str | None = "relu",
        pool_hidden_dim: int | None = None,
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
                f"Invalid aggregator '{aggregator}'. "
                f"Must be one of {list(_VALID_AGGREGATORS)}"
            )
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.aggregator = aggregator
        self.normalize = normalize
        self.root_weight = root_weight
        self.use_bias = use_bias
        self.activation = activation
        self.dropout_rate = dropout_rate
        dense = dict(kernel_initializer=kernel_initializer,
                     generator=generator, device=device, dtype=dtype)
        neigh_in = input_dim
        if aggregator == "pooling":
            self.pool_mlp = Dense(
                pool_hidden_dim or input_dim, input_dim=input_dim,
                activation=pool_activation, use_bias=use_bias,
                bias_initializer=bias_initializer, **dense)
            neigh_in = self.pool_mlp.units
        self.lin_neigh = Dense(output_dim, input_dim=neigh_in,
                               use_bias=False, **dense)
        if root_weight:
            self.lin_self = Dense(output_dim, input_dim=input_dim,
                                  use_bias=False, **dense)
        if use_bias:
            self.bias = nn.Parameter(
                torch.zeros(output_dim, dtype=dtype, device=device))
        else:
            self.register_parameter("bias", None)

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
        if context is not None and isinstance(x, (tuple, list)):
            raise ValueError(
                "bipartite (x_target, x_source) inputs are not supported on "
                "the GraphContext path: a context is built for one node "
                "set; use the plain edge_index path instead."
            )
        num_nodes = x.shape[0]
        if num_nodes == 0:
            return torch.zeros((0, self.output_dim), dtype=x.dtype,
                               device=x.device)
        rate, training = self.dropout_rate, self.training
        pool_dim = (self.pool_mlp.units if self.aggregator == "pooling"
                    else x.shape[1])

        if context is not None:
            drop_active = training and rate > 0
            if (context.has_unit_weights and not drop_active
                    and self.aggregator in ("sum", "mean")):
                agg = (context.spmm(x) if self.aggregator == "sum"
                       else context.spmm_mean(x))
            else:
                fctx = context.full_stream()
                messages = dropout(fctx.gather(x), rate, training, generator)
                if self.aggregator == "pooling":
                    agg = fctx.scatter_max(self.pool_mlp(messages))
                elif self.aggregator == "sum":
                    agg = fctx.scatter(messages, masked=True)
                elif self.aggregator == "mean":
                    agg = fctx.scatter_mean(messages)
                elif self.aggregator == "max":
                    agg = fctx.scatter_max(messages)
                elif self.aggregator == "min":
                    agg = -fctx.scatter_max(-messages)
                else:
                    agg = aggregate(
                        self.aggregator, messages, fctx.receivers, num_nodes,
                        mask=fctx.edge_mask, indices_are_sorted=True,
                    )
        elif edge_index is None:
            raise ValueError("edge_index required when no context is given")
        elif torch.as_tensor(edge_index).numel() == 0:
            agg = torch.zeros((num_nodes, pool_dim), dtype=x.dtype,
                              device=x.device)
        else:
            edge_index = ensure_edge_index(edge_index, device=x.device)
            senders, receivers = edge_index[0], edge_index[1]
            messages = dropout(x.index_select(0, senders.long()), rate,
                               training, generator)
            if self.aggregator == "pooling":
                agg = segment_max(
                    self.pool_mlp(messages), receivers, num_nodes,
                    mask=edge_mask, indices_are_sorted=indices_are_sorted,
                )
            else:
                agg = aggregate(
                    self.aggregator, messages, receivers, num_nodes,
                    mask=edge_mask, indices_are_sorted=indices_are_sorted,
                )

        out = self.lin_neigh(agg)
        if self.root_weight:
            out = out + self.lin_self(dropout(x, rate, training, generator))
        if self.bias is not None:
            out = out + self.bias
        out = get_activation(self.activation)(out)
        if self.normalize:
            norm = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
            out = out / norm.clamp_min(1e-12)
        return out
