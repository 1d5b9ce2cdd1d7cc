"""Minimal GINConv usage: MLP depth, trainable epsilon, aggregators, on the
PyTorch port.

Twin of ``examples/simple_gin.py``. Runs on the CUDA card; pass ``--device
cpu`` to run on the CPU (without a card and without that flag it raises).

Usage: python examples_torch/simple_gin.py [--device cuda]
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
    rng = np.random.default_rng(1)
    n, f = 10, 6
    x = torch.as_tensor(rng.standard_normal((n, f)), dtype=torch.float32,
                        device=device)
    ei = torch.as_tensor(
        np.stack([rng.integers(0, n, 30), rng.integers(0, n, 30)])
        .astype(np.int32), device=device)

    for kwargs in (
        {"mlp_hidden": ()},
        {"mlp_hidden": (32,), "aggregator": "mean"},
        {"mlp_hidden": (32, 32), "train_eps": True, "eps_init": 0.1},
    ):
        layer = kgt.GINConv(4, input_dim=f, device=device,
                            generator=torch.Generator(device).manual_seed(0),
                            **kwargs)
        out = layer(x, ei)
        (layer(x, ei) ** 2).sum().backward()
        grads = [p.grad for p in layer.parameters()]
        n_params = sum(g.numel() for g in grads)
        print(f"GINConv({kwargs}): out {tuple(out.shape)}, {n_params} params, "
              f"grads finite={all(bool(torch.isfinite(g).all()) for g in grads)}")

    # Config round-trip (parity with Keras get_config/from_config).
    gen = torch.Generator(device).manual_seed(1)
    layer = kgt.GINConv(4, mlp_hidden=(16,), train_eps=True, input_dim=f,
                        device=device, generator=gen)
    clone = kgt.GINConv.from_config(layer.get_config(), input_dim=f,
                                    device=device, generator=gen)
    assert clone.get_config() == layer.get_config()
    print("config round-trip ok")


if __name__ == "__main__":
    main()
