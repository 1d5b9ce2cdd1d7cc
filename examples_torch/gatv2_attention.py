"""GATv2 multi-head attention on a citation graph (BASELINE config 2 shape),
on the PyTorch port.

Twin of ``examples/gatv2_attention.py``: trains an 8-head GATv2 encoder on
(synthetic) CiteSeer through the training step factory and inspects the
learned attention distribution. The layers take the edge list, as the
reference's script does. Runs on the CUDA card; pass ``--device cpu`` to run
on the CPU (without a card and without that flag it raises).

Usage: python examples_torch/gatv2_attention.py [--epochs 50]
"""

from __future__ import annotations

import argparse

import torch

from keras_geometric_tpu_torch.data.datasets import synthetic_planetoid
from keras_geometric_tpu_torch.models import GAT
from keras_geometric_tpu_torch.training import (
    TrainState,
    make_eval_fn,
    make_node_classification_step,
)
from keras_geometric_tpu_torch.utils import pick_device


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--hidden", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = pick_device(args.device)

    g = synthetic_planetoid("citeseer")
    x = torch.as_tensor(g.x, device=device)
    ei = torch.as_tensor(g.edge_index, device=device)
    y = torch.as_tensor(g.y, device=device).long()
    num_classes = int(g.y.max()) + 1
    print(f"citeseer: {x.shape[0]} nodes, {ei.shape[1]} edges")

    # 8-head hidden layer (concat); the output layer concatenates its heads
    # too, as in the reference's script.
    gen = torch.Generator(device=device).manual_seed(0)
    encoder = GAT(
        hidden_dims=(args.hidden, num_classes),
        heads=args.heads,
        dropout_rate=0.3,
        input_dim=x.shape[1],
        generator=gen,
        device=device,
    )
    optimizer = torch.optim.AdamW(encoder.parameters(), lr=5e-3,
                                  weight_decay=5e-4)
    state = TrainState(encoder, optimizer, generator=gen)
    step = make_node_classification_step(encoder, optimizer, generator=gen)
    evaluate = make_eval_fn(encoder)

    train_mask = torch.as_tensor(g.train_mask, device=device)
    val_mask = torch.as_tensor(g.val_mask, device=device)
    for epoch in range(args.epochs):
        loss = step(x, ei, y, train_mask)
        state.step += 1
        if (epoch + 1) % 10 == 0:
            acc = evaluate(x, ei, y, val_mask)
            print(f"epoch {epoch+1:3d}  loss {float(loss):.4f}  val {float(acc):.3f}")

    # Inspect attention of the first layer on a few edges.
    layer = encoder.layer_0.eval()
    with torch.no_grad():
        _, alpha = layer(x, ei, return_attention=True)
    alpha = alpha.cpu().numpy()
    print(
        f"attention: shape {alpha.shape}, head-0 stats "
        f"min {alpha[:,0].min():.4f} max {alpha[:,0].max():.4f} "
        f"mean {alpha[:,0].mean():.4f}"
    )
    test_mask = torch.as_tensor(g.test_mask, device=device)
    print(f"test accuracy: {float(evaluate(x, ei, y, test_mask)):.3f}")


if __name__ == "__main__":
    main()
