"""Node classification with a 2-layer GCN — the framework's canonical flow,
on the PyTorch port.

Twin of ``examples/node_classification.py``: build a 2-layer GCN, train with
masked softmax cross-entropy on the train split, report val/test accuracy.
On the card the graph is prepared once (``prepare_graph``: self-loops, GCN
norm, both CSR orientations) and aggregation runs through the hand-written
SpMM kernels; on the CPU the layers take the edge list. Reads a Planetoid
dataset already cached under ``data/`` (either package writes the same
cache); otherwise, and without ever downloading, it trains on the synthetic
stand-in with the same shape profile. Runs on the CUDA card; pass ``--device
cpu`` to run on the CPU (without a card and without that flag it raises).

Usage:  python examples_torch/node_classification.py [--dataset cora] [--epochs 100]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

import keras_geometric_tpu_torch as kgt
from keras_geometric_tpu_torch.data.datasets import synthetic_planetoid
from keras_geometric_tpu_torch.training import (
    masked_accuracy,
    masked_softmax_cross_entropy,
)
from keras_geometric_tpu_torch.utils import pick_device


def load_graph(name: str):
    if os.path.exists(os.path.join("data", name, "processed", "meta.npz")):
        classes = kgt.get_dataset_classes()
        cls = {
            "cora": classes["CoraDataset"],
            "citeseer": classes["CiteSeerDataset"],
            "pubmed": classes["PubMedDataset"],
        }[name]
        ds = cls(root="data")
        g = ds[0]
        if hasattr(g, "train_mask"):
            return g, ds.num_classes
    print(f"[offline] using synthetic {name} stand-in")
    g = synthetic_planetoid(name)
    return g, int(g.y.max()) + 1


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="cora")
    ap.add_argument("--hidden", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--weight-decay", type=float, default=5e-4)
    ap.add_argument("--dropout", type=float, default=0.5)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def graph_tensors(graph, device) -> dict:
    """The graph's features, edges, labels and splits on ``device``."""
    names = ("x", "edge_index", "y", "train_mask", "val_mask", "test_mask")
    out = {k: torch.as_tensor(getattr(graph, k), device=device)
           for k in names}
    out["y"] = out["y"].long()
    return out


def prepare_context(graph, device):
    """Preprocess once on the card (self-loops + GCN norm + dual CSR
    orientations): aggregation then runs through the hand-written SpMM
    kernels. None on the CPU, where the layers take the edge list."""
    if device.type != "cuda":
        return None
    return kgt.prepare_graph(
        np.asarray(graph.edge_index), np.asarray(graph.x).shape[0],
        add_self_loops=True, gcn_normalize=True, device=device,
    )


def make_model(in_dim, hidden, num_classes, dropout, *, context: bool,
               device, generator) -> torch.nn.ModuleDict:
    """The 2-layer GCN; ``context``: its layers take a prepared context."""
    build = dict(generator=generator, device=device)
    if context:
        # for_context sets add_self_loops=False, normalize=False — those
        # are folded into prepare_graph.
        conv1 = kgt.GCNConv.for_context(
            output_dim=hidden, dropout_rate=dropout, input_dim=in_dim,
            **build)
        conv2 = kgt.GCNConv.for_context(output_dim=num_classes,
                                        input_dim=hidden, **build)
    else:
        conv1 = kgt.GCNConv(hidden, dropout_rate=dropout, input_dim=in_dim,
                            **build)
        conv2 = kgt.GCNConv(num_classes, input_dim=hidden, **build)
    return torch.nn.ModuleDict({"conv1": conv1, "conv2": conv2})


def make_forward(model, x, edge_index, context, generator):
    def forward():
        h = model["conv1"](x, edge_index, context=context,
                           generator=generator)
        h = torch.relu(h)
        return model["conv2"](h, edge_index, context=context)

    return forward


def make_train_step(model, forward, y, train_mask, optimizer):
    def train_step():
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss = masked_softmax_cross_entropy(forward(), y, train_mask)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step


def main():
    args = parse_args()
    device = pick_device(args.device)

    graph, num_classes = load_graph(args.dataset)
    t = graph_tensors(graph, device)
    x, y = t["x"], t["y"]
    print(
        f"{args.dataset}: {x.shape[0]} nodes, {t['edge_index'].shape[1]} "
        f"edges, {x.shape[1]} features, {num_classes} classes"
    )

    gen = torch.Generator(device=device).manual_seed(0)
    context = prepare_context(graph, device)
    model = make_model(x.shape[1], args.hidden, num_classes, args.dropout,
                       context=context is not None, device=device,
                       generator=gen)
    forward = make_forward(model, x, t["edge_index"], context, gen)
    optimizer = torch.optim.AdamW(model.parameters(), lr=args.lr,
                                  weight_decay=args.weight_decay)
    train_step = make_train_step(model, forward, y, t["train_mask"],
                                 optimizer)

    @torch.no_grad()
    def accuracy(mask):
        model.eval()
        return masked_accuracy(forward(), y, mask)

    start = time.time()
    for epoch in range(args.epochs):
        loss = train_step()
        if (epoch + 1) % 20 == 0:
            print(
                f"epoch {epoch + 1:3d}  loss {float(loss):.4f}  "
                f"train {float(accuracy(t['train_mask'])):.3f}  "
                f"val {float(accuracy(t['val_mask'])):.3f}"
            )
    print(f"training took {time.time() - start:.1f}s")
    print(f"test accuracy: {float(accuracy(t['test_mask'])):.3f}")


if __name__ == "__main__":
    main()
