"""Graph Convolutional Network layer (Kipf & Welling 2017).

``H' = D^-1/2 (A + I) D^-1/2 X W + b``

Counterpart of the JAX package's ``nn/gcn_conv.py``; the numerical contract
is the reference's:

- self-loops appended after user edges;
- normalization from receiver in-degree including self-loops,
  ``(d+1e-12)^-1/2`` with inf -> 0;
- message = ``(x_j @ W) * w_e``, sum aggregation, bias added last;
- user-provided ``edge_weight`` multiplies messages;
- no-edge graphs degenerate to the dense transform ``X W (+ b)``; empty
  graphs return ``[0, out]``.

The transform runs as one ``[N, F_in] @ [F_in, F_out]`` matmul *before* the
gather (the message is linear, so the order is free); with a
:class:`~keras_geometric_tpu_torch.ops.csr.GraphContext` a widening layer
propagates first, at the narrow width.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import spmm
from ..ops.graph_ops import add_self_loops, ensure_edge_index, gcn_norm
from .module import Module, dropout, get_initializer

__all__ = ["GCNConv"]


class GCNConv(Module):
    """GCN convolution with optional self-loops and symmetric normalization.

    Parameters are ``kernel`` ``[input_dim, output_dim]`` and ``bias``
    ``[output_dim]``. Dropout is active in ``train()`` mode.
    """

    def __init__(
        self,
        output_dim: int,
        *,
        input_dim: int,
        use_bias: bool = True,
        add_self_loops: bool = True,
        normalize: bool = True,
        dropout_rate: float = 0.0,
        kernel_initializer: str = "glorot_uniform",
        bias_initializer: str = "zeros",
        generator: torch.Generator | None = None,
        device: torch.device | str = "cuda",
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self._keep_config(locals())
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.use_bias = use_bias
        self.add_self_loops = add_self_loops
        self.normalize = normalize
        self.dropout_rate = dropout_rate
        self.kernel = nn.Parameter(
            get_initializer(kernel_initializer)(
                (input_dim, output_dim), generator=generator, dtype=dtype,
                device=device,
            )
        )
        if use_bias:
            self.bias = nn.Parameter(
                get_initializer(bias_initializer)(
                    (output_dim,), generator=generator, dtype=dtype,
                    device=device,
                )
            )
        else:
            self.register_parameter("bias", None)

    @classmethod
    def for_context(cls, output_dim: int, **kwargs) -> "GCNConv":
        """Construct a GCNConv preconfigured for a ``GraphContext``.

        ``prepare_graph(add_self_loops=True, gcn_normalize=True)`` folds
        self-loops and normalization into the context, so the layer's own
        flags must be off: this constructor sets ``add_self_loops=False,
        normalize=False``. Explicitly passed flags still win.
        """
        kwargs.setdefault("add_self_loops", False)
        kwargs.setdefault("normalize", False)
        return cls(output_dim, **kwargs)

    def forward(
        self,
        x: torch.Tensor,
        edge_index: torch.Tensor | None = None,
        edge_weight: torch.Tensor | None = None,
        *,
        edge_mask: torch.Tensor | None = None,
        node_mask: torch.Tensor | None = None,
        indices_are_sorted: bool = False,
        row_ptr: torch.Tensor | None = None,
        context=None,
        generator: torch.Generator | None = None,
        keep_mask: torch.Tensor | None = None,
        self_keep_mask: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """``keep_mask`` (``[E, F_out]`` bool) and ``self_keep_mask``
        (``[N, F_out]`` bool, densified contexts) replace the dropout draws
        on the edge messages and on the dense self-loop term."""
        num_nodes = x.shape[0]
        if num_nodes == 0:
            return torch.zeros((0, self.output_dim), dtype=x.dtype,
                               device=x.device)

        if context is None or x.shape[1] >= self.output_dim:
            h = x @ self.kernel  # [N, F_out] single dense matmul
        else:
            h = None  # widening layer: propagate at F_in, then transform

        if context is not None:
            # Prepared GraphContext path: both CSR orientations and the norm
            # weights are ready; self-loop/normalize flags must have been
            # applied at preparation time.
            if self.add_self_loops or self.normalize:
                raise ValueError(
                    "With a GraphContext, construct GCNConv with "
                    "add_self_loops=False, normalize=False and fold both "
                    "into prepare_graph()."
                )
            drop_active = self.training and self.dropout_rate > 0
            if edge_weight is None and not drop_active:
                if h is None:
                    # Widening layer (F_in < F_out): A(xW) = (Ax)W, so the
                    # gather/scatter runs at the NARROW width. When x also
                    # carries no gradient (input features), dW needs only the
                    # saved [N, F_in] spmm(x) and the layer's backward spmm
                    # disappears entirely.
                    out = context.spmm(x) @ self.kernel
                else:
                    out = context.spmm(h)
            else:
                if h is None:
                    h = x @ self.kernel
                messages = context.gather(h)
                if edge_weight is not None:
                    messages = messages * edge_weight[:, None]
                messages = dropout(
                    messages, self.dropout_rate, self.training, generator,
                    keep_mask,
                )
                # Normalization weights are applied inside the scatter kernel
                # (dropout commutes with the elementwise scale).
                out = context.scatter_weighted(messages)
                if context.self_weight is not None:
                    # Densified diagonal: appended self-loops get iid
                    # per-element dropout like any edge message.
                    self_msg = h * context.self_weight[:, None].to(h.dtype)
                    out = out + dropout(
                        self_msg, self.dropout_rate, self.training, generator,
                        self_keep_mask,
                    )
            if self.bias is not None:
                out = out + self.bias
            return out
        if edge_index is None:
            raise ValueError("edge_index required when no context is given")

        edge_index = torch.as_tensor(edge_index, device=x.device)
        if edge_index.numel() == 0:
            edge_index = torch.zeros((2, 0), dtype=torch.int32, device=x.device)
        edge_index = ensure_edge_index(edge_index)

        if edge_index.shape[1] == 0:
            out = h  # no edges: dense transform only
        else:
            if self.add_self_loops:
                edge_index, edge_mask = add_self_loops(
                    edge_index, num_nodes, edge_mask=edge_mask,
                    node_mask=node_mask,
                )
                # Self-loop insertion breaks receiver-sorted order.
                indices_are_sorted = False
                row_ptr = None
                if edge_weight is not None:
                    ones = torch.ones(num_nodes, dtype=edge_weight.dtype,
                                      device=edge_weight.device)
                    edge_weight = torch.cat([edge_weight, ones])
            w = edge_weight
            if self.normalize:
                norm = gcn_norm(
                    edge_index, num_nodes, edge_mask=edge_mask,
                    indices_are_sorted=indices_are_sorted, dtype=h.dtype,
                )
                w = norm if w is None else w * norm

            senders, receivers = edge_index[0], edge_index[1]
            messages = h.index_select(0, senders)
            if w is not None:
                messages = messages * w[:, None]
            messages = dropout(
                messages, self.dropout_rate, self.training, generator,
                keep_mask,
            )
            out = spmm.scatter_sum(
                messages,
                receivers,
                num_nodes,
                mask=edge_mask,
                indices_are_sorted=indices_are_sorted,
                row_ptr=row_ptr,
            )

        if self.bias is not None:
            out = out + self.bias
        return out
