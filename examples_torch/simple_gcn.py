"""Minimal GCN forward + one training run on a tiny graph, on the PyTorch
port.

Twin of ``examples/simple_gcn.py``: build one GCNConv, run a forward pass,
take gradient steps: the smallest end-to-end use of the modules. Runs on the
CUDA card; pass ``--device cpu`` to run on the CPU (without a card and
without that flag it raises). No dataset download.

Usage: python examples_torch/simple_gcn.py [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import keras_geometric_tpu_torch as kgt
from keras_geometric_tpu_torch.utils import pick_device


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = pick_device(args.device)
    rng = np.random.default_rng(0)
    num_nodes, num_feats, num_classes = 12, 8, 3
    x = torch.as_tensor(rng.standard_normal((num_nodes, num_feats)),
                        dtype=torch.float32, device=device)
    edge_index = torch.as_tensor(
        np.stack([rng.integers(0, num_nodes, 40),
                  rng.integers(0, num_nodes, 40)]).astype(np.int32),
        device=device)
    y = torch.as_tensor(rng.integers(0, num_classes, num_nodes),
                        device=device)

    layer = kgt.GCNConv(num_classes, input_dim=num_feats, device=device,
                        generator=torch.Generator(device).manual_seed(0))
    out = layer(x, edge_index)
    print(f"forward: {tuple(out.shape)} (expected ({num_nodes}, {num_classes}))")

    def loss_fn():
        logp = torch.log_softmax(layer(x, edge_index), dim=-1)
        return -logp[torch.arange(num_nodes, device=device), y].mean()

    optimizer = torch.optim.Adam(layer.parameters(), lr=0.05)
    with torch.no_grad():
        loss0 = float(loss_fn())
    for _ in range(20):
        optimizer.zero_grad(set_to_none=True)
        loss_fn().backward()
        optimizer.step()
    with torch.no_grad():
        loss = float(loss_fn())
    print(f"loss: {loss0:.4f} -> {loss:.4f}")
    assert loss < loss0


if __name__ == "__main__":
    main()
