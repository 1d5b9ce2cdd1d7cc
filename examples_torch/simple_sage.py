"""Minimal SAGEConv usage: all six aggregators, root weight, L2 normalize,
on the PyTorch port.

Twin of ``examples/simple_sage.py``. Runs on the CUDA card; pass ``--device
cpu`` to run on the CPU (without a card and without that flag it raises).

Usage: python examples_torch/simple_sage.py [--device cuda]
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
    rng = np.random.default_rng(2)
    n, f = 14, 5
    x = torch.as_tensor(rng.standard_normal((n, f)), dtype=torch.float32,
                        device=device)
    ei = torch.as_tensor(
        np.stack([rng.integers(0, n, 50), rng.integers(0, n, 50)])
        .astype(np.int32), device=device)
    build = dict(input_dim=f, device=device,
                 generator=torch.Generator(device).manual_seed(0))

    for agg in ("mean", "max", "sum", "min", "std", "pooling"):
        layer = kgt.SAGEConv(8, aggregator=agg, **build)
        out = layer(x, ei)
        print(f"SAGEConv(aggregator={agg!r}): {tuple(out.shape)}")

    normed = kgt.SAGEConv(8, normalize=True, **build)
    with torch.no_grad():
        norms = torch.linalg.norm(normed(x, ei), dim=-1)
    print(f"L2-normalized row norms: min={float(norms.min()):.3f} "
          f"max={float(norms.max()):.3f}")

    no_root = kgt.SAGEConv(8, root_weight=False, **build)
    assert not any(name.startswith("lin_self")
                   for name, _ in no_root.named_parameters())
    print("root_weight=False drops lin_self as expected")


if __name__ == "__main__":
    main()
