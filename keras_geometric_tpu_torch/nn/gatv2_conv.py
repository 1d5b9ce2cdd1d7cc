"""GATv2 convolution (Brody et al. 2022).

Multi-head dynamic attention over edges:

``score_e = sum_f att[h, f] * leaky_relu(h_i + h_j)[f]`` per head, softmaxed
per receiver, then an attention-weighted sum-aggregation of ``h_j``.

Counterpart of the JAX package's ``nn/gatv2_conv.py``; the numerical contract
is the reference's:

- one *shared* linear transform for source and target nodes;
- attention ``a^T LeakyReLU(h_i + h_j)`` per head;
- per-receiver softmax with max-shift and ``+1e-10`` in the denominator;
- attention dropout (after normalisation, inverted scaling) in ``train()``
  mode;
- heads concatenated (default) or averaged, bias added after the merge;
- self-loops appended by default; empty / no-edge graphs return zeros.

On a plain ``edge_index`` the layer runs library ops (``ops/segment.py``).
With a :class:`~keras_geometric_tpu_torch.ops.csr.GraphContext` it runs the
fused attention op ``GraphContext.attend`` (hand-written kernels, forward and
backward), or, with ``fused_attend=False`` or ``return_attention=True``, the
composed path: ``gather`` -> ``sddmm_scores`` -> ``edge_softmax`` -> dropout
on ``alpha`` -> ``alpha * hj`` -> ``scatter``, each op with its own kernels.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import csr, edge_dropout
from ..ops.graph_ops import add_self_loops, ensure_edge_index
from ..ops.segment import segment_softmax, segment_sum
from .module import Module, get_initializer

__all__ = ["GATv2Conv"]


class GATv2Conv(Module):
    """GATv2 multi-head attention convolution.

    Parameters are ``kernel`` ``[input_dim, heads*output_dim]``, ``att``
    ``[1, heads, output_dim]`` and ``bias`` (``[heads*output_dim]``, or
    ``[output_dim]`` with ``concat=False``).
    """

    def __init__(
        self,
        output_dim: int,
        *,
        input_dim: int,
        heads: int = 1,
        concat: bool = True,
        negative_slope: float = 0.2,
        dropout: float = 0.0,
        use_bias: bool = True,
        add_self_loops: bool = True,
        kernel_initializer: str = "glorot_uniform",
        bias_initializer: str = "zeros",
        att_initializer: str = "glorot_uniform",
        fused_attend: bool = True,
        generator: torch.Generator | None = None,
        device: torch.device | str = "cuda",
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self._keep_config(locals())
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.heads = heads
        self.concat = concat
        self.negative_slope = negative_slope
        self.dropout = dropout
        self.use_bias = use_bias
        self.add_self_loops = add_self_loops
        # Context-path strategy: True runs the fused attend op, whose backward
        # never forms the [E, H*F] sender rows. False selects the composed
        # path (score, softmax and scatter ops), which return_attention=True
        # takes too, since only it forms alpha.
        self.fused_attend = fused_attend
        h, f = heads, output_dim

        def make(initializer, shape):
            return nn.Parameter(get_initializer(initializer)(
                shape, generator=generator, dtype=dtype, device=device))

        self.kernel = make(kernel_initializer, (input_dim, h * f))
        self.att = make(att_initializer, (1, h, f))
        if use_bias:
            self.bias = make(bias_initializer, (h * f,) if concat else (f,))
        else:
            self.register_parameter("bias", None)

    @classmethod
    def for_context(cls, output_dim: int, **kwargs) -> "GATv2Conv":
        """Construct a GATv2Conv preconfigured for a ``GraphContext``.

        Self-loops must be folded into ``prepare_graph(add_self_loops=True)``;
        this constructor sets ``add_self_loops=False``. Explicitly passed
        flags still win.
        """
        kwargs.setdefault("add_self_loops", False)
        return cls(output_dim, **kwargs)

    @property
    def out_features(self) -> int:
        return self.heads * self.output_dim if self.concat else self.output_dim

    def _merge_heads(self, agg: torch.Tensor) -> torch.Tensor:
        """``[N, H, F]`` -> concatenated or head-averaged output, plus bias."""
        n = agg.shape[0]
        out = agg.reshape(n, -1) if self.concat else agg.mean(dim=1)
        if self.bias is not None:
            out = out + self.bias
        return out

    def forward(
        self,
        x: torch.Tensor | tuple[torch.Tensor, torch.Tensor],
        edge_index: torch.Tensor | None = None,
        *,
        edge_mask: torch.Tensor | None = None,
        node_mask: torch.Tensor | None = None,
        return_attention: bool = False,
        context=None,
        generator: torch.Generator | None = None,
        drop_mask: torch.Tensor | None = None,
    ):
        """``drop_mask`` (``[E, heads]`` pre-scaled keep mask: ``1/keep`` or
        0, in the order of the edges the attention runs over) replaces the
        attention-dropout draw in ``train()`` mode. On a context whose
        attention backward runs in sender order (``ATTEND_BWD_MODE = "send"``
        in ``ops/csr.py``) a drawn mask comes with its sender-order twin; a
        mask passed in here has none, so its backward takes the permute
        finish."""
        if context is not None:
            return self._forward_context(
                x, context, return_attention=return_attention,
                generator=generator, drop_mask=drop_mask,
            )
        if edge_index is None:
            raise ValueError("edge_index required when no context is given")
        if isinstance(x, (tuple, list)):
            x_target, x_source = x[0], x[1]
        else:
            x_target = x_source = x
        n = x_target.shape[0]
        h, f = self.heads, self.output_dim

        edge_index = torch.as_tensor(edge_index, device=x_target.device)
        if n == 0 or edge_index.numel() == 0:
            out = torch.zeros((n, self.out_features), dtype=x_target.dtype,
                              device=x_target.device)
            return (out, None) if return_attention else out

        edge_index = ensure_edge_index(edge_index)
        if self.add_self_loops:
            edge_index, edge_mask = add_self_loops(
                edge_index, n, edge_mask=edge_mask, node_mask=node_mask
            )

        # Shared transform for both endpoints: [N, H*F] -> [N, H, F].
        ht = (x_target @ self.kernel).reshape(n, h, f)
        if x_source is x_target:
            hs = ht
        else:
            hs = (x_source @ self.kernel).reshape(x_source.shape[0], h, f)

        senders, receivers = edge_index[0].long(), edge_index[1].long()
        h_j = hs.index_select(0, senders)  # [E, H, F]
        h_i = ht.index_select(0, receivers)  # [E, H, F]

        z = nn.functional.leaky_relu(h_i + h_j, self.negative_slope)
        scores = (z * self.att).sum(dim=-1)  # [E, H]

        alpha = segment_softmax(scores, receivers, n, mask=edge_mask,
                                eps=1e-10)
        if self.training and self.dropout > 0:
            if drop_mask is None:
                drop_mask = edge_dropout.keep_mask_at(
                    generator, None, h, self.dropout, alpha.dtype,
                    num_edges=alpha.shape[0], device=alpha.device)
            alpha = alpha * drop_mask

        messages = alpha[:, :, None] * h_j  # [E, H, F]
        agg = segment_sum(
            messages.reshape(-1, h * f), receivers, n, mask=edge_mask
        ).reshape(n, h, f)
        out = self._merge_heads(agg)
        return (out, alpha) if return_attention else out

    def _forward_context(self, x, context, *, return_attention, generator,
                         drop_mask):
        """Kernel path over a prepared GraphContext. Self-loops must be folded
        at prepare_graph time."""
        if self.add_self_loops:
            raise ValueError(
                "With a GraphContext, construct GATv2Conv with "
                "add_self_loops=False and fold loops into prepare_graph()."
            )
        if isinstance(x, (tuple, list)):
            raise ValueError(
                "bipartite (x_target, x_source) inputs are not supported on "
                "the GraphContext path: a context is built for one node "
                "set; use the plain edge_index path instead."
            )
        # Densified contexts: per-edge attention needs every edge, so use the
        # attached full-stream companion.
        context = context.full_stream()
        n = x.shape[0]
        h, f = self.heads, self.output_dim
        ht = x @ self.kernel  # [N, H*F]
        fused = self.fused_attend and not return_attention
        drop_mask_ss = None
        if not (self.training and self.dropout > 0):
            drop_mask = None
        elif drop_mask is None:
            num_slots = int(context.senders.shape[0])
            if fused and csr.ATTEND_BWD_MODE == "send":
                # The sender-order backward reads the same draw in sender
                # order: the pair, drawn only where it is read.
                drop_mask, drop_mask_ss = edge_dropout.attention_keep_masks(
                    generator, num_slots, context.bwd_perm, h, self.dropout,
                    ht.dtype)
            else:
                # The fused kernels read the mask in ht's type; the composed
                # path multiplies it into alpha, which is f32.
                drop_mask = edge_dropout.keep_mask_at(
                    generator, None, h, self.dropout,
                    ht.dtype if fused else torch.float32,
                    num_edges=num_slots, device=ht.device)
        if fused:
            agg = context.attend(
                ht, self.att.reshape(h, f),
                negative_slope=self.negative_slope, eps=1e-10,
                drop_mask=drop_mask, drop_mask_ss=drop_mask_ss,
            )
            return self._merge_heads(agg.reshape(n, h, f))
        h_j = context.gather(ht)  # [E, H*F]
        scores = context.sddmm_scores(
            ht, h_j, self.att.reshape(h, f),
            negative_slope=self.negative_slope,
        )
        alpha = context.edge_softmax(scores, eps=1e-10)  # [E, H], 0 on pads
        if drop_mask is not None:
            alpha = alpha * drop_mask
        messages = (
            alpha[:, :, None].to(h_j.dtype) * h_j.view(-1, h, f)
        ).reshape(-1, h * f)
        agg = context.scatter(messages).reshape(n, h, f)
        out = self._merge_heads(agg)
        return (out, alpha) if return_attention else out
