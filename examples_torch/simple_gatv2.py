"""Minimal GATv2Conv usage: heads, concat vs mean, attention weights, on the
PyTorch port.

Twin of ``examples/simple_gatv2.py``. Runs on the CUDA card; pass ``--device
cpu`` to run on the CPU (without a card and without that flag it raises).

Usage: python examples_torch/simple_gatv2.py [--device cuda]
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
    rng = np.random.default_rng(3)
    n, f = 10, 6
    x = torch.as_tensor(rng.standard_normal((n, f)), dtype=torch.float32,
                        device=device)
    ei = torch.as_tensor(
        np.stack([rng.integers(0, n, 30), rng.integers(0, n, 30)])
        .astype(np.int32), device=device)

    concat = kgt.GATv2Conv(8, heads=4, concat=True, input_dim=f,
                           device=device,
                           generator=torch.Generator(device).manual_seed(0))
    out = concat(x, ei)
    print(f"heads=4 concat: {tuple(out.shape)} (H*F = 32)")

    mean = kgt.GATv2Conv(8, heads=4, concat=False, input_dim=f, device=device,
                         generator=torch.Generator(device).manual_seed(0))
    out_m = mean(x, ei)
    print(f"heads=4 mean:   {tuple(out_m.shape)} (F = 8)")

    # Attention weights sum to 1 over each receiver's incoming edges.
    out, alpha = concat(x, ei, return_attention=True)
    ei_sl, _ = kgt.add_self_loops(ei, n)
    sums = torch.zeros((n, 4), device=device).index_add_(
        0, ei_sl[1].long(), alpha.detach())
    print(f"attention column sums ~1: max dev "
          f"{float((sums - 1).abs().max()):.2e}")


if __name__ == "__main__":
    main()
