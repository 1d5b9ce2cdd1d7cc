"""GraphSAGE minibatch training with neighbor sampling (BASELINE config 4),
on the PyTorch port.

Twin of ``examples/sage_minibatch.py``: SAGE fanout-(25, 10) minibatch node
classification on (synthetic) ogbn-arxiv, read from the repository's cache
``data/ogbn_arxiv``: host-side fixed-shape neighbor sampling overlapped with
device steps via a prefetch thread. The features and labels are held on the
device and each bucket is gathered there. Runs on the CUDA card; pass
``--device cpu`` to run on the CPU (without a card and without that flag it
raises).

Usage: python examples_torch/sage_minibatch.py [--epochs 3] [--batch-size 512]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from keras_geometric_tpu_torch.data.datasets import OGBNodeDataset
from keras_geometric_tpu_torch.data.sampling import NeighborSampler, prefetch
from keras_geometric_tpu_torch.nn.sage_conv import SAGEConv
from keras_geometric_tpu_torch.training import TrainState
from keras_geometric_tpu_torch.training.sage_minibatch import (
    make_sage_minibatch_step,
    subgraph_to_arrays,
)
from keras_geometric_tpu_torch.utils import pick_device


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--fanouts", type=int, nargs="+", default=[25, 10])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = pick_device(args.device)

    ds = OGBNodeDataset("ogbn-arxiv", synthetic=True)
    # The cache is memory-mapped read-only: copy once, then to the device.
    x = torch.from_numpy(np.array(ds.x)).to(device)
    y = torch.from_numpy(np.array(ds.y)).to(device)
    senders, receivers = ds.edges()
    edge_index = np.stack([np.asarray(senders), np.asarray(receivers)])
    split = ds.split_idx()
    print(
        f"ogbn-arxiv: {ds.num_nodes} nodes, {ds.num_edges} edges, "
        f"{ds.num_feats} feats, {ds.num_classes} classes "
        f"(train {len(split['train'])})"
    )

    sampler = NeighborSampler(
        edge_index, ds.num_nodes, tuple(args.fanouts), seed=0
    )
    gen = torch.Generator(device=device).manual_seed(0)
    build = dict(generator=gen, device=device)
    layers = (
        SAGEConv(args.hidden, input_dim=ds.num_feats, **build),
        SAGEConv(ds.num_classes, input_dim=args.hidden, activation=None,
                 **build),
    )
    optimizer = torch.optim.Adam(
        [p for layer in layers for p in layer.parameters()], lr=1e-3)
    state = TrainState(torch.nn.ModuleList(layers), optimizer, generator=gen)
    step, infer = make_sage_minibatch_step(layers, ds.num_classes, optimizer,
                                           generator=gen)

    train_nodes = split["train"]
    for epoch in range(args.epochs):
        t0 = time.time()
        losses, n_batches = [], 0
        it = prefetch(
            (
                subgraph_to_arrays(sub, x, y)
                for sub in sampler.epoch(train_nodes, args.batch_size)
            ),
            depth=2,
        )
        for data in it:
            losses.append(step(data))
            state.step += 1
            n_batches += 1
        losses = [float(l) for l in losses]
        print(
            f"epoch {epoch + 1}: loss {np.mean(losses):.4f} "
            f"({n_batches} batches, {time.time() - t0:.1f}s)"
        )

    # Eval on a sampled subset of validation nodes.
    correct = total = 0
    for sub in sampler.epoch(split["valid"][:4096], args.batch_size):
        data = subgraph_to_arrays(sub, x, y)
        pred = infer(data)[: args.batch_size].argmax(-1)
        valid = data["seed_mask"]
        correct += int(((pred == data["y_seed"]) & valid).sum())
        total += int(valid.sum())
    print(f"valid accuracy (sampled): {correct / max(total, 1):.3f}")


if __name__ == "__main__":
    main()
