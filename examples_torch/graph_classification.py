"""Graph classification with GIN + batched pooling (BASELINE.json config 3),
on the PyTorch port.

Twin of ``examples/graph_classification.py``: batches of small synthetic
graphs, disjoint-union-batched into padded fixed-shape buckets, a 5-layer GIN
encoder, sum readout, a Dense head and Adam. Runs on the CUDA card; pass
``--device cpu`` to run on the CPU (without a card and without that flag it
raises).

Usage: python examples_torch/graph_classification.py [--epochs 30]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from keras_geometric_tpu_torch.data.datasets import synthetic_graph
from keras_geometric_tpu_torch.models import GIN, GraphClassifier
from keras_geometric_tpu_torch.training import label_nll
from keras_geometric_tpu_torch.utils import batch_graphs_padded, pick_device

NUM_FEATS = 8


def make_dataset(num_graphs=200, num_classes=3, seed=0):
    """Graphs whose class is encoded in edge density + a feature motif."""
    rng = np.random.default_rng(seed)
    graphs, labels = [], []
    for i in range(num_graphs):
        c = int(rng.integers(num_classes))
        n = int(rng.integers(10, 24))
        e = n * (2 + 2 * c)  # class-dependent density
        g = synthetic_graph(n, e, NUM_FEATS, seed=int(rng.integers(1 << 31)))
        g.x[:, c] += 1.5  # class-dependent feature motif
        graphs.append(g)
        labels.append(c)
    for g, c in zip(graphs, labels):
        g.y = np.array([c], np.int32)
    return graphs, np.array(labels, np.int32), num_classes


def make_model(hidden, num_classes, readout="sum", *, device, generator):
    """``GraphClassifier(GIN((hidden,) * 5, mlp_hidden=(hidden,)))``."""
    encoder = GIN((hidden,) * 5, mlp_hidden=(hidden,), input_dim=NUM_FEATS,
                  generator=generator, device=device)
    return GraphClassifier(encoder, num_classes, readout=readout,
                           generator=generator, device=device)


def batch_to_arrays(graph_list, batch_size, device):
    """One padded bucket (nodes 24 * batch_size, edges 24 * 8 * batch_size:
    every batch has the same shapes) and its labels, -1 on the slots of
    missing graphs and of the dummy graph that holds the padded nodes."""
    g = batch_graphs_padded(graph_list, node_bucket=24 * batch_size,
                            edge_bucket=24 * 8 * batch_size, device=device)
    num_graphs = batch_size + 1  # +1 dummy graph for padded nodes
    y = np.full(num_graphs, -1, np.int64)
    for i, bg in enumerate(graph_list):
        y[i] = int(bg.y[0])
    return g, torch.as_tensor(y, device=device), num_graphs


def graph_nll(logits, y):
    """Mean negative log-likelihood over the graph slots with a label."""
    valid = (y >= 0).to(logits.dtype)
    nll = label_nll(torch.log_softmax(logits, dim=-1), y.clamp_min(0))
    return (nll * valid).sum() / valid.sum().clamp_min(1.0)


def make_train_step(model, optimizer, num_graphs):
    """``train_step(g, y) -> loss``: one optimizer step on a padded bucket;
    the loss comes back detached and unsynchronised."""

    def train_step(g, y):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        logits = model(g.x, g.edge_index, g.batch, num_graphs,
                       edge_mask=g.edge_mask, node_mask=g.node_mask)
        loss = graph_nll(logits, y)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step


def make_predict(model, num_graphs):
    @torch.no_grad()
    def predict(g):
        model.eval()
        logits = model(g.x, g.edge_index, g.batch, num_graphs,
                       edge_mask=g.edge_mask, node_mask=g.node_mask)
        return logits.argmax(-1)

    return predict


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = pick_device(args.device)

    graphs, labels, num_classes = make_dataset()
    n_train = 160
    gen = torch.Generator(device=device).manual_seed(0)
    model = make_model(args.hidden, num_classes, device=device, generator=gen)
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-3)
    num_graphs = args.batch_size + 1
    train_step = make_train_step(model, optimizer, num_graphs)
    predict = make_predict(model, num_graphs)

    rng = np.random.default_rng(0)
    order = np.arange(n_train)
    start = time.time()
    for epoch in range(args.epochs):
        rng.shuffle(order)
        losses = []
        for i in range(0, n_train - args.batch_size + 1, args.batch_size):
            chunk = [graphs[j] for j in order[i : i + args.batch_size]]
            g, y, _ = batch_to_arrays(chunk, args.batch_size, device)
            losses.append(float(train_step(g, y)))
        if (epoch + 1) % 10 == 0:
            print(f"epoch {epoch+1:3d}  loss {np.mean(losses):.4f}")

    # Test accuracy.
    correct = total = 0
    for i in range(n_train, len(graphs) - args.batch_size + 1, args.batch_size):
        chunk = graphs[i : i + args.batch_size]
        g, y, _ = batch_to_arrays(chunk, args.batch_size, device)
        pred = predict(g)
        valid = y >= 0
        correct += int(((pred == y) & valid).sum())
        total += int(valid.sum())
    print(f"training took {time.time()-start:.1f}s")
    print(f"test accuracy: {correct / max(total,1):.3f}")


if __name__ == "__main__":
    main()
