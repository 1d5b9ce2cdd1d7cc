#!/usr/bin/env python3
"""How far the 2-D tensor-parallel GCN block's ``d x`` moves between repeats
of the same forward + backward pass on one card, with relu and with gelu
between its layers.

Four processes share the card in a gloo group on a ``(graph 2, model 2)``
mesh (NCCL takes one rank a card) and run ``tp_graph_gcn_block_local`` at
the main path's widths (128 -> 256 -> 40) on ``chip_smoke.py``'s uniform
arxiv-shaped graph with its self-loops and GCN normalisation, ``--reps``
times per activation, the parameters' gradients summed over the graph group
after each pass as a 2-D step would. For each pass it prints the largest
difference of ``d x`` from the element-wise median of the passes, over its
largest entry. The card's f32 sums (``index_add``'s atomics) come out in an
order that changes from run to run; where a pre-activation lies within
rounding of relu's kink, a pass can land on the other side and move the
gradient by that element's whole term, which a smooth activation cannot.

Run from the repository root on a machine with a CUDA card::

    python3 tp_activation_probe.py [--reps 24]
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import pathlib
import pickle
import shutil
import sys
import traceback

import numpy as np
import torch

import chip_smoke as cs

ACTIVATIONS = {"relu": torch.relu, "gelu": torch.nn.functional.gelu}
GRID = (2, 2)


def rank_body(rank, out_dir, reps):
    import torch.distributed as dist

    from keras_geometric_tpu_torch import parallel as par
    from keras_geometric_tpu_torch.parallel import tensor_parallel as tp
    from keras_geometric_tpu_torch.parallel.distributed import _sum_gradients
    from keras_geometric_tpu_torch.parallel.mesh import local_device

    out = pathlib.Path(out_dir)
    try:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // 4))
        dist.init_process_group(
            "gloo", init_method=f"file://{out / 'store'}", rank=rank,
            world_size=4, timeout=datetime.timedelta(seconds=120))
        mesh = par.make_mesh(GRID, ("graph", "model"), device_type="cuda")
        device = local_device(mesh)
        part, t = mesh.get_local_rank("graph"), mesh.get_local_rank("model")
        graph_group = mesh.get_group("graph")
        group_kw = {"graph_group": graph_group,
                    "model_group": mesh.get_group("model")}
        with open(out / "payload.pkl", "rb") as f:
            payload = pickle.load(f)
        pg = payload["partition"]
        L = pg["nodes_per_part"]
        edges = tuple(torch.from_numpy(np.ascontiguousarray(pg[k][part]))
                      .to(device) for k in ("senders_global",
                                            "receivers_local", "edge_weight",
                                            "edge_mask"))
        x = torch.from_numpy(payload["x"]).to(device)
        rows = slice(part * L, min((part + 1) * L, x.shape[0]))
        x_local = torch.zeros(L, x.shape[1], device=device)
        x_local[:rows.stop - rows.start] = x[rows]
        gen = torch.Generator(device=device).manual_seed(5)
        g = torch.randn(GRID[0] * L, cs.ARXIV_CLASSES, generator=gen,
                        device=device)[part * L:(part + 1) * L]
        params = cs.tensor_tree(payload["shards"][t], device)
        leaves = list(cs.flat_tree(params).values())
        result = {}
        for name, act in ACTIVATIONS.items():
            fn = cs.tp_block_fn("gcn", tp, group_kw, act)
            grads = []
            for _ in range(reps):
                dist.barrier()
                for p in leaves:
                    p.grad = None
                xx = x_local.clone().requires_grad_()
                fn(params, xx, *edges).backward(g)
                _sum_gradients(leaves, graph_group)
                grads.append(xx.grad.clone())
            median = torch.stack(grads).median(dim=0).values
            scale = median.abs().max()
            result[name] = [((d - median).abs().max() / scale).item()
                            for d in grads]
            del grads, median
        torch.save(result, out / f"rank{rank}.pt")
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - the parent reports it
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def main() -> int:
    import multiprocessing

    from keras_geometric_tpu_torch import parallel as par
    from keras_geometric_tpu_torch.parallel import tensor_parallel as tp

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=24)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tp_activation_probe: no CUDA device", file=sys.stderr)
        return 1
    out = cs.ROOT / "build" / f"tp_activation_probe_{os.getpid()}"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    try:
        x, edges, _ = cs.arxiv_arrays(symmetric=True)
        pg = par.partition_graph(edges, cs.ARXIV_NODES, GRID[0],
                                 gcn_normalize=True, add_self_loops=True)
        mods = cs.tp_modules(torch.device("cuda"), torch.Generator(
            device="cuda").manual_seed(43))
        shards = tp.shard_params_tp(cs.tp_param_tree("gcn", mods["gcn"]),
                                    GRID[1])
        with open(out / "payload.pkl", "wb") as f:
            pickle.dump(dict(x=x, shards=shards, partition={
                **{k: getattr(pg, k) for k in (
                    "senders_global", "receivers_local", "edge_weight",
                    "edge_mask")}, "nodes_per_part": pg.nodes_per_part}), f)
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=rank_body, args=(r, str(out), args.reps))
                 for r in range(4)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(600)
        for p in procs:
            if p.is_alive():
                p.kill()
        errors = sorted(out.glob("rank*.err"))
        if errors or any(p.exitcode for p in procs):
            print(errors[0].read_text() if errors else
                  [p.exitcode for p in procs], file=sys.stderr)
            return 1
        results = [torch.load(out / f"rank{r}.pt") for r in range(4)]
    finally:
        shutil.rmtree(out, ignore_errors=True)
    summary = {name: {"reps": args.reps,
                      "passes_over_1e-5": [sum(v > 1e-5 for v in r[name])
                                           for r in results],
                      "largest": max(max(r[name]) for r in results),
                      "largest_of_the_rest": max(
                          v for r in results for v in r[name] if v <= 1e-5)}
               for name in ACTIVATIONS}
    print(json.dumps({"d_x_rel_deviation_from_median": summary,
                      "device": torch.cuda.get_device_name(0)}))
    print(cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
