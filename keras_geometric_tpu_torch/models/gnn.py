"""Standard multi-layer GNN model families.

Counterpart of the JAX package's ``models/gnn.py``: the canonical stacks are
first-class modules so training and benchmarks share one definition: the
GCN, GIN, GATv2 and GraphSAGE families, and ``GraphClassifier`` (an encoder,
a batched readout and a Dense head for graph-level tasks).
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from ..nn.gatv2_conv import GATv2Conv
from ..nn.gcn_conv import GCNConv
from ..nn.gin_conv import GINConv
from ..nn.module import Dense, Module, dropout, get_activation
from ..nn.pooling.global_pooling import batch_pool
from ..nn.sage_conv import SAGEConv

__all__ = ["GNNEncoder", "GCN", "GIN", "GAT", "GraphSAGE", "GraphClassifier"]

_FAMILIES = {"gcn": GCNConv, "gin": GINConv, "gatv2": GATv2Conv,
             "sage": SAGEConv}


def _layer_out_dim(layer: nn.Module) -> int:
    """Width a layer hands to the next one: a GATv2 layer that concatenates
    its heads is ``heads * output_dim`` wide."""
    if isinstance(layer, GATv2Conv):
        return layer.out_features
    return layer.output_dim


class GNNEncoder(Module):
    """A stack of conv layers with inter-layer activation (+ dropout).

    ``conv``: layer family name (``'gcn'`` | ``'gin'`` | ``'gatv2'`` |
    ``'sage'``; SAGE layers are built with ``activation=None``, the encoder
    applying its own between layers). ``hidden_dims``:
    output dim of each layer (for ``'gatv2'`` per head; every layer gets the
    same ``conv_kwargs``, so with the default ``concat=True`` each layer,
    the last included, is ``heads * dim`` wide). The final layer gets no
    activation (logits-friendly). Layers are the sub-modules ``layer_0 ..
    layer_k``, so the state dict mirrors the reference's ``{"layer_i":
    {"kernel", "bias", ...}}`` parameter tree.
    """

    def __init__(
        self,
        conv: str,
        hidden_dims: tuple[int, ...],
        *,
        input_dim: int,
        activation: str | None = "relu",
        dropout_rate: float = 0.0,
        final_activation: str | None = None,
        conv_kwargs: Any = (),
        generator: torch.Generator | None = None,
        device: torch.device | str = "cuda",
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        hidden_dims = tuple(hidden_dims)
        # The reference keeps the pairs sorted by key, and so its config.
        conv_kwargs = tuple(sorted(dict(conv_kwargs).items()))
        self._keep_config(locals())
        if not hidden_dims:
            raise ValueError("hidden_dims must be non-empty")
        if conv not in _FAMILIES:
            raise ValueError(f"Unknown conv family: {conv}")
        self.conv = conv
        self.hidden_dims = hidden_dims
        self.input_dim = input_dim
        self.activation = activation
        self.dropout_rate = dropout_rate
        self.final_activation = final_activation
        self.num_layers = len(hidden_dims)
        layer_kwargs = dict(conv_kwargs)
        if conv == "sage":
            layer_kwargs["activation"] = None
        dim = input_dim
        for i, out_dim in enumerate(hidden_dims):
            layer = _FAMILIES[conv](
                out_dim, input_dim=dim, generator=generator, device=device,
                dtype=dtype, **layer_kwargs,
            )
            self.add_module(f"layer_{i}", layer)
            dim = _layer_out_dim(layer)

    @classmethod
    def for_context(
        cls, conv: str, hidden_dims: tuple, **kwargs
    ) -> "GNNEncoder":
        """Encoder preconfigured for ``forward(..., context=...)`` layers.

        Folds the family's context requirements into ``conv_kwargs`` (GCN:
        ``add_self_loops=False, normalize=False``; GATv2:
        ``add_self_loops=False``) so training on a prepared graph cannot hit
        the layer flag trap. User-passed conv_kwargs win.
        """
        ck = dict(kwargs.pop("conv_kwargs", ()))
        if conv == "gcn":
            ck.setdefault("add_self_loops", False)
            ck.setdefault("normalize", False)
        elif conv == "gatv2":
            ck.setdefault("add_self_loops", False)
        return cls(conv, hidden_dims, conv_kwargs=tuple(ck.items()), **kwargs)

    @property
    def output_dim(self) -> int:
        return _layer_out_dim(self.layers()[-1])

    def layers(self) -> list[nn.Module]:
        return [getattr(self, f"layer_{i}") for i in range(self.num_layers)]

    def forward(
        self,
        x: torch.Tensor,
        edge_index: torch.Tensor | None = None,
        *,
        edge_mask: torch.Tensor | None = None,
        node_mask: torch.Tensor | None = None,
        context=None,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        act = get_activation(self.activation)
        h = x
        for i, layer in enumerate(self.layers()):
            if context is not None:
                h = layer(h, context=context, generator=generator)
            elif isinstance(layer, (GCNConv, GATv2Conv)):
                h = layer(
                    h, edge_index, edge_mask=edge_mask, node_mask=node_mask,
                    generator=generator,
                )
            else:
                h = layer(h, edge_index, edge_mask=edge_mask,
                          generator=generator)
            if i < self.num_layers - 1:
                h = act(h)
                h = dropout(h, self.dropout_rate, self.training, generator)
        if self.final_activation is not None:
            h = get_activation(self.final_activation)(h)
        return h


def GCN(hidden_dims: tuple[int, ...], **kwargs) -> GNNEncoder:
    """2-layer-style GCN stack (Kipf & Welling)."""
    return GNNEncoder("gcn", tuple(hidden_dims), **kwargs)


def GIN(hidden_dims: tuple[int, ...], mlp_hidden: tuple[int, ...] = (),
        **kwargs) -> GNNEncoder:
    """GIN stack; every layer's MLP has the hidden widths ``mlp_hidden``."""
    return GNNEncoder("gin", tuple(hidden_dims),
                      conv_kwargs=(("mlp_hidden", tuple(mlp_hidden)),),
                      **kwargs)


def GAT(hidden_dims: tuple[int, ...], heads: int = 8, **kwargs) -> GNNEncoder:
    """GATv2 stack; every layer has ``heads`` heads and concatenates them."""
    return GNNEncoder(
        "gatv2", tuple(hidden_dims), conv_kwargs=(("heads", heads),), **kwargs
    )


def GraphSAGE(hidden_dims: tuple[int, ...], aggregator: str = "mean",
              **kwargs) -> GNNEncoder:
    """GraphSAGE stack; every layer aggregates with ``aggregator``."""
    return GNNEncoder("sage", tuple(hidden_dims),
                      conv_kwargs=(("aggregator", aggregator),), **kwargs)


class GraphClassifier(Module):
    """Encoder, batched readout and Dense head for graph-level tasks.

    ``encoder`` is a built :class:`GNNEncoder`, or its config (a dict, as
    ``from_config`` hands it over), which is then built here with
    ``input_dim``. The readout is :func:`batch_pool` with ``readout`` in
    ``'sum'`` | ``'mean'`` | ``'max'``; the head is ``head_0 .. head_k``:
    a Dense layer with ``relu`` for each width of ``head_hidden``, then a
    linear one to ``num_classes``. Sub-modules mirror the reference's tree
    (``{"encoder": {"layer_i": ...}, "head_i": {"kernel", "bias"}}``).
    """

    def __init__(
        self,
        encoder: GNNEncoder | dict,
        num_classes: int,
        readout: str = "mean",
        head_hidden: tuple[int, ...] = (),
        *,
        input_dim: int | None = None,
        generator: torch.Generator | None = None,
        device: torch.device | str = "cuda",
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if isinstance(encoder, dict):
            encoder = GNNEncoder.from_config(
                encoder, input_dim=input_dim, generator=generator,
                device=device, dtype=dtype)
        self._keep_config(locals())
        self.encoder = encoder
        self.num_classes = num_classes
        self.readout = readout
        widths = tuple(head_hidden) + (num_classes,)
        self.num_head_layers = len(widths)
        dim = encoder.output_dim
        for i, units in enumerate(widths):
            layer = Dense(
                units, input_dim=dim,
                activation="relu" if i < len(widths) - 1 else None,
                generator=generator, device=device, dtype=dtype,
            )
            self.add_module(f"head_{i}", layer)
            dim = units

    def forward(
        self,
        x: torch.Tensor,
        edge_index: torch.Tensor,
        batch: torch.Tensor,
        num_graphs: int,
        *,
        edge_mask: torch.Tensor | None = None,
        node_mask: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """``[num_graphs, num_classes]`` logits; ``batch[i]`` is node ``i``'s
        graph id (a padded batch's padded nodes carry the dummy id and are
        masked by ``node_mask``)."""
        h = self.encoder(x, edge_index, edge_mask=edge_mask,
                         node_mask=node_mask, generator=generator)
        pooled = batch_pool(h, batch, num_graphs, self.readout,
                            node_mask=node_mask)
        for i in range(self.num_head_layers):
            pooled = getattr(self, f"head_{i}")(pooled)
        return pooled
