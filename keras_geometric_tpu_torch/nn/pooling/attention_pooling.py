"""Attention-based readouts: AttentionPooling and Set2Set.

Counterpart of the JAX package's ``nn/pooling/attention_pooling.py``:

- ``AttentionPooling``: a ``tanh`` Dense transform, a scalar score Dense,
  a softmax over the node axis and the weighted sum of the features ->
  ``[1, F]``. Parameters ``attention_transform`` and ``attention_score``.
- ``Set2Set``: ``processing_steps`` steps of {attend with ``Dense(1, tanh)``
  over ``[x, h]``, softmax over nodes, weighted-sum read, LSTM step}, then one
  final attention pass -> ``[1, lstm_units + F]``, the last hidden state
  beside the attended features. Parameters ``lstm.kernel`` ``[F, 4u]``,
  ``lstm.recurrent_kernel`` ``[u, 4u]``, ``lstm.bias`` ``[4u]`` (gates in the
  order i, f, c, o) and ``attention_dense``: the reference's tree, so
  ``convert.params_from_jax`` loads it with no transpose (``torch.nn.LSTMCell``
  would keep ``[4u, F]`` and two biases). The reference's ``lax.scan`` over
  the steps is a Python loop here.

Under a ``node_mask`` the masked nodes get weight 0; a graph whose nodes are
all masked gives NaN (a softmax over nothing but ``-inf``), as the
reference's does. Dropout hits only the attention's input (``x``, or the
``[x, h]`` concat on every step and in the final pass); the weighted sum
reads the original features. Its masks come from the ``generator`` passed to
``forward``, which a training pass with dropout requires.
"""

from __future__ import annotations

import torch

from ..module import Dense, Module, dropout, get_initializer

__all__ = ["AttentionPooling", "Set2Set"]


def _masked_softmax_over_nodes(
    scores: torch.Tensor, node_mask: torch.Tensor | None
) -> torch.Tensor:
    """Softmax over axis 0 of ``[N, 1]`` scores; masked nodes get weight 0."""
    if node_mask is not None:
        scores = scores.masked_fill(~node_mask[:, None], float("-inf"))
    return torch.softmax(scores, dim=0)


def _check_dropout(rate: float) -> None:
    if not 0.0 <= rate <= 1.0:
        raise ValueError(f"dropout must be in [0, 1], got {rate}")


def _require_generator(module: Module, rate: float, generator) -> None:
    if module.training and rate > 0.0 and generator is None:
        raise ValueError("dropout requires a generator when training")


class AttentionPooling(Module):
    """Softmax-over-nodes weighted-sum readout."""

    def __init__(
        self,
        attention_dim: int | None = None,
        dropout: float = 0.0,
        *,
        input_dim: int,
        generator: torch.Generator | None = None,
        device: torch.device | str = "cuda",
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self._keep_config(locals())
        if attention_dim is not None and attention_dim <= 0:
            raise ValueError(
                f"attention_dim must be positive, got {attention_dim}")
        _check_dropout(dropout)
        self.dropout = dropout
        att_dim = attention_dim if attention_dim is not None else input_dim
        build = dict(generator=generator, device=device, dtype=dtype)
        self.attention_transform = Dense(att_dim, input_dim=input_dim,
                                         activation="tanh", **build)
        self.attention_score = Dense(1, input_dim=att_dim, **build)

    def forward(
        self,
        x: torch.Tensor,
        *,
        node_mask: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        _require_generator(self, self.dropout, generator)
        dropped = dropout(x, self.dropout, self.training, generator)
        scores = self.attention_score(self.attention_transform(dropped))
        weights = _masked_softmax_over_nodes(scores, node_mask)
        return (weights * x).sum(0, keepdim=True)


class _LSTMCell(torch.nn.Module):
    """One LSTM step in the reference's layout: ``z = x @ kernel + h @
    recurrent_kernel + bias``, gates i, f, c, o. Glorot kernel, orthogonal
    recurrent kernel, bias ``[0, 1, 0, 0]`` blocks (unit forget bias)."""

    def __init__(self, units: int, *, input_dim: int, generator=None,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        build = dict(generator=generator, dtype=dtype, device=device)
        self.kernel = torch.nn.Parameter(get_initializer("glorot_uniform")(
            (input_dim, 4 * units), **build))
        self.recurrent_kernel = torch.nn.Parameter(get_initializer(
            "orthogonal")((units, 4 * units), **build))
        bias = torch.zeros(4 * units, dtype=dtype, device=device)
        bias[units:2 * units] = 1.0
        self.bias = torch.nn.Parameter(bias)

    def forward(self, x, h, c):
        z = x @ self.kernel + h @ self.recurrent_kernel + self.bias
        i, f, g, o = z.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c


class Set2Set(Module):
    """LSTM-attention readout over ``processing_steps`` steps (Vinyals et al.
    2016)."""

    def __init__(
        self,
        output_dim: int,
        processing_steps: int = 3,
        lstm_units: int | None = None,
        dropout: float = 0.0,
        *,
        input_dim: int,
        generator: torch.Generator | None = None,
        device: torch.device | str = "cuda",
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self._keep_config(locals())
        if output_dim <= 0:
            raise ValueError(f"output_dim must be positive, got {output_dim}")
        if processing_steps <= 0:
            raise ValueError(
                f"processing_steps must be positive, got {processing_steps}")
        _check_dropout(dropout)
        self.processing_steps = processing_steps
        self.dropout = dropout
        self.units = lstm_units if lstm_units is not None else output_dim
        build = dict(generator=generator, device=device, dtype=dtype)
        self.lstm = _LSTMCell(self.units, input_dim=input_dim, **build)
        self.attention_dense = Dense(1, input_dim=input_dim + self.units,
                                     activation="tanh", **build)

    def out_features(self, input_dim: int) -> int:
        return self.units + input_dim

    def forward(
        self,
        x: torch.Tensor,
        *,
        node_mask: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        _require_generator(self, self.dropout, generator)
        num_nodes = x.shape[0]

        def attend(h: torch.Tensor) -> torch.Tensor:
            att_in = torch.cat([x, h.expand(num_nodes, self.units)], dim=-1)
            att_in = dropout(att_in, self.dropout, self.training, generator)
            weights = _masked_softmax_over_nodes(
                self.attention_dense(att_in), node_mask)
            return (weights * x).sum(0, keepdim=True)

        h = x.new_zeros((1, self.units))
        c = x.new_zeros((1, self.units))
        for _ in range(self.processing_steps):
            h, c = self.lstm(attend(h), h, c)
        return torch.cat([h, attend(h)], dim=-1)
