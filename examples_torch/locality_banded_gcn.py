"""Locality pipeline demo: reorder + banded-dense SpMM on a community graph,
on the PyTorch port.

Twin of ``examples/locality_banded_gcn.py``. Real citation/social graphs
have community structure; this example shows the preprocessing that exploits
it:

1. generate a scrambled community power-law graph (a stand-in for a
   real-world edge list with arbitrary node ids);
2. recover the latent locality with LPA cluster reordering;
3. prepare a banded GraphContext — the majority of edges become dense
   band products (the hand-written band SpMM kernel on the card) with no
   gather at all — and train a 2-layer GCN on it.

Runs on the CUDA card; pass ``--device cpu`` to run on the CPU, where the
context's kernels are their plain versions (without a card and without that
flag it raises).

Usage: python examples_torch/locality_banded_gcn.py [--nodes 20000]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from keras_geometric_tpu_torch.data.datasets.synthetic import community_graph
from keras_geometric_tpu_torch.models import GNNEncoder
from keras_geometric_tpu_torch.ops import reorder
from keras_geometric_tpu_torch.ops.csr import prepare_graph
from keras_geometric_tpu_torch.training import masked_softmax_cross_entropy
from keras_geometric_tpu_torch.utils import pick_device


CLASSES = 16
FEATURES = 64


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=20_000)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def make_graph(n: int) -> dict:
    """The scrambled community graph, its LPA cluster order and the labels
    (host numpy; the same on every device)."""
    e = 12 * n
    ei = community_graph(n, e, community_size=256, seed=0)
    s, r = ei[0].astype(np.int64), ei[1].astype(np.int64)

    # Labels follow the latent communities — learnable signal.
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, FEATURES)).astype(np.float32)

    t0 = time.time()
    order = reorder.cluster_order(s, r, n)
    inv = reorder.invert_order(order)
    print(f"cluster_order: {time.time() - t0:.1f}s  "
          f"band coverage (|s-r| <= 512): "
          f"{reorder.band_coverage(inv[s], inv[r], windows=(1024,))[1024]:.2f}")
    lpa = reorder.lpa_labels(inv[s], inv[r], n)
    return dict(n=n, edges=np.stack([inv[s], inv[r]]), x=x[order],
                labels=np.unique(lpa, return_inverse=True)[1] % CLASSES)


def prepare(graph: dict, device):
    """The banded context and the padded features, labels and mask."""
    n = graph["n"]
    ctx = prepare_graph(
        graph["edges"], n,
        add_self_loops=True, gcn_normalize=True, symmetric=True,
        densify_self_loops=True, pad_nodes=True, attend_full_stream=False,  # GCN-only demo
        band_window=1024, device=device,
    )
    print(f"band edges: {ctx.num_band_edges} "
          f"({ctx.num_band_edges / ctx.num_edges:.1%}); "
          f"residual: {ctx.num_real_edges}")

    # Node features/labels follow the SAME relabeling as the edges.
    x = np.pad(graph["x"], ((0, ctx.num_nodes - n), (0, 0)))
    labels = np.zeros(ctx.num_nodes, np.int64)
    labels[:n] = graph["labels"]
    y = torch.as_tensor(labels, device=device)
    mask = torch.as_tensor(np.arange(ctx.num_nodes) < n, device=device)
    return ctx, torch.as_tensor(x, device=device), y, mask


def make_encoder(device, generator) -> GNNEncoder:
    # for_context folds the GraphContext flag requirements in
    # (add_self_loops=False, normalize=False) — see GCNConv.for_context.
    return GNNEncoder.for_context(
        "gcn", (FEATURES, CLASSES), input_dim=FEATURES, device=device,
        generator=generator)


def make_train_step(enc, optimizer, ctx, x, y, mask):
    def step():
        enc.train()
        optimizer.zero_grad(set_to_none=True)
        loss = masked_softmax_cross_entropy(enc(x, context=ctx), y, mask)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def main():
    args = parse_args()
    device = pick_device(args.device)

    ctx, xt, y, mask = prepare(make_graph(args.nodes), device)
    enc = make_encoder(device, torch.Generator(device=device).manual_seed(0))
    optimizer = torch.optim.Adam(enc.parameters(), lr=1e-2)
    step = make_train_step(enc, optimizer, ctx, xt, y, mask)

    for epoch in range(args.epochs):
        loss = step()
        if epoch % 10 == 0 or epoch == args.epochs - 1:
            print(f"epoch {epoch:3d}  loss {float(loss):.4f}")
    with torch.no_grad():
        pred = enc.eval()(xt, context=ctx).argmax(-1)
    acc = float(((pred == y) & mask).sum() / mask.sum().clamp_min(1))
    print(f"train accuracy: {acc:.3f}")


if __name__ == "__main__":
    main()
