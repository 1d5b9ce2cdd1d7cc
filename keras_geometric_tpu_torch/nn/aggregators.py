"""Aggregation strategies: a registry of functions over the segment ops.

Counterpart of the JAX package's ``nn/aggregators.py``: the five stateless
aggregators ``(messages [E, F], receivers [E], num_nodes) -> [N, F]`` behind
:func:`aggregate`, and the learnable ``pooling`` strategy (an elementwise
max over a Dense layer of the messages) as the module
:class:`PoolingAggregator`, usable outside ``SAGEConv`` as well.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops import segment
from .module import Dense, Module

__all__ = [
    "aggregate",
    "available_aggregators",
    "AGGREGATORS",
    "PoolingAggregator",
]

AGGREGATORS: dict[str, Callable] = {
    "sum": segment.segment_sum,
    "mean": segment.segment_mean,
    "max": segment.segment_max,
    "min": segment.segment_min,
    "std": segment.segment_std,
}


def available_aggregators() -> list[str]:
    return list(AGGREGATORS) + ["pooling"]


def aggregate(
    name: str,
    messages: torch.Tensor,
    receivers: torch.Tensor,
    num_nodes: int,
    *,
    mask: torch.Tensor | None = None,
    indices_are_sorted: bool = False,
) -> torch.Tensor:
    """Reduce per-edge messages into per-node outputs by strategy ``name``."""
    if name not in AGGREGATORS:
        raise ValueError(
            f"Invalid aggregator: {name}. Available: {available_aggregators()}"
        )
    return AGGREGATORS[name](
        messages,
        receivers,
        num_nodes,
        mask=mask,
        indices_are_sorted=indices_are_sorted,
    )


class PoolingAggregator(Module):
    """Learnable pooling aggregation: ``max_j Dense(units, act)(m_j)``.

    The messages pass through one Dense layer (the sub-module ``mlp``, so
    the parameters are ``mlp.kernel`` and ``mlp.bias`` as in the reference's
    ``{"mlp": {"kernel", "bias"}}``), then reduce per receiver with the
    masked segment max (an isolated receiver gets 0).
    """

    def __init__(
        self,
        units: int,
        *,
        input_dim: int,
        activation: str | None = "relu",
        use_bias: bool = True,
        kernel_initializer: str = "glorot_uniform",
        bias_initializer: str = "zeros",
        generator: torch.Generator | None = None,
        device: torch.device | str = "cuda",
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self._keep_config(locals())
        self.units = units
        self.mlp = Dense(
            units,
            input_dim=input_dim,
            activation=activation,
            use_bias=use_bias,
            kernel_initializer=kernel_initializer,
            bias_initializer=bias_initializer,
            generator=generator,
            device=device,
            dtype=dtype,
        )

    def forward(
        self,
        messages: torch.Tensor,
        receivers: torch.Tensor,
        num_nodes: int,
        *,
        mask: torch.Tensor | None = None,
        indices_are_sorted: bool = False,
    ) -> torch.Tensor:
        return segment.segment_max(
            self.mlp(messages),
            receivers,
            num_nodes,
            mask=mask,
            indices_are_sorted=indices_are_sorted,
        )
