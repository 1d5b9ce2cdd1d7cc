"""Graph-level readouts: Global, BatchGlobal, Attention, Set2Set, and the
standalone PoolingAggregator, on the PyTorch port.

Twin of ``examples/pooling_readouts.py``: one script exercising every readout
family on a small batch of graphs. Runs on the CUDA card; pass ``--device
cpu`` to run on the CPU (without a card and without that flag it raises).

Usage: python examples_torch/pooling_readouts.py [--device cuda]
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
    gen = torch.Generator(device=device).manual_seed(0)
    rng = np.random.default_rng(4)
    f = 6

    # --- single-graph readouts -------------------------------------------
    x = torch.as_tensor(rng.standard_normal((9, f)), dtype=torch.float32,
                        device=device)
    for pooling in ("mean", "max", "sum"):
        out = kgt.GlobalPooling(pooling=pooling)(x)
        print(f"GlobalPooling({pooling}): {tuple(out.shape)}")

    attn = kgt.AttentionPooling(attention_dim=16, input_dim=f,
                                generator=gen, device=device).eval()
    print(f"AttentionPooling: {tuple(attn(x).shape)}")

    s2s = kgt.Set2Set(output_dim=8, processing_steps=3, input_dim=f,
                      generator=gen, device=device).eval()
    out = s2s(x)
    print(f"Set2Set: {tuple(out.shape)} (lstm_units + F = {8 + f})")

    # --- batched readout over a disjoint-union batch ----------------------
    graphs = []
    for i in range(4):
        n_i = int(rng.integers(3, 8))
        e_i = int(rng.integers(2, 12))
        graphs.append(kgt.GraphData(
            x=rng.standard_normal((n_i, f)).astype(np.float32),
            edge_index=np.stack([
                rng.integers(0, n_i, e_i), rng.integers(0, n_i, e_i)
            ]).astype(np.int32),
            y=np.array([i % 2], np.int32),
        ))
    batch = kgt.batch_graphs(graphs)
    pooled = kgt.BatchGlobalPooling(pooling="mean")(
        torch.as_tensor(batch.x, device=device),
        torch.as_tensor(batch.batch, device=device), len(graphs))
    print(f"BatchGlobalPooling over {len(graphs)} graphs: "
          f"{tuple(pooled.shape)}")

    # --- standalone learnable pooling aggregation -------------------------
    e = 30
    msgs = torch.as_tensor(rng.standard_normal((e, f)), dtype=torch.float32,
                           device=device)
    recv = torch.as_tensor(np.sort(rng.integers(0, 9, e)).astype(np.int32),
                           device=device)
    agg = kgt.PoolingAggregator(units=12, input_dim=f, generator=gen,
                                device=device)
    out = agg(msgs, recv, 9)
    print(f"PoolingAggregator: {tuple(out.shape)}")


if __name__ == "__main__":
    main()
