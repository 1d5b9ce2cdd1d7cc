#!/usr/bin/env python3
"""Measure what the distributed path costs the host on one CUDA card.

Two probes, on a process group of one rank (NCCL, a ``file://`` store under
the git-ignored ``build/``):

1. ``collectives``: the host milliseconds of one call of each collective the
   distributed path issues (``all_to_all_single`` blocking, with
   ``async_op=True`` and a ``wait()``, and without the wait;
   ``all_reduce``; ``all_gather_into_tensor``) on a ``[64, 256]`` f32
   tensor, each timed with ten f32 matmuls of 8192 x 8192 queued ahead of
   it (far more card time than any call takes), so that a call that
   returns before they end shows that it does not wait for the card;
   beside a ``clone`` of the same tensor (a plain launch) and the host time
   of queueing the matmuls;
2. ``steps``: the distributed GCN and fused GATv2 steps of ``chip_smoke.py``'s
   ``train_distributed_arxiv_shape`` (its arrays, ``(256, 40)`` and 4 x 64 /
   4 x 40, bf16 IO, Adam, kernel and attend plans), 20 steps after 5:
   the host's milliseconds a step to queue them against the wall's.

Run from the repository root on a machine with one CUDA card::

    python3 distributed_host_probe.py

It prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import datetime
import json
import os
import pathlib
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent


def host_ms(fn, busy, reps=5):
    """The host's milliseconds for one call of ``fn`` with ``busy`` queued
    ahead of it (the median of ``reps``), and of queueing ``busy``."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    calls, queue = [], []
    for _ in range(reps):
        start = time.perf_counter()
        busy()
        queue.append(time.perf_counter() - start)
        start = time.perf_counter()
        fn()
        calls.append(time.perf_counter() - start)
        torch.cuda.synchronize()
    return 1e3 * sorted(calls)[reps // 2], 1e3 * sorted(queue)[reps // 2]


def collectives(dist, device):
    a = torch.randn(8192, 8192, device=device)
    x = torch.randn(64, 256, device=device)
    out, gathered = torch.empty_like(x), torch.empty_like(x)

    def busy():
        for _ in range(10):
            a @ a

    def async_wait():
        dist.all_to_all_single(out, x, async_op=True).wait()

    cases = {
        "all_to_all_single": lambda: dist.all_to_all_single(out, x),
        "all_to_all_single async + wait": async_wait,
        "all_to_all_single async, no wait": lambda: dist.all_to_all_single(
            out, x, async_op=True),
        "all_reduce": lambda: dist.all_reduce(x),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            gathered, x),
        "clone (a plain launch)": lambda: x.clone(),
    }
    result = {}
    for label, fn in cases.items():
        call, queue = host_ms(fn, busy)
        result[label] = {"host_ms": call, "queue_busy_host_ms": queue}
    return result


def steps(device):
    import chip_smoke as cs
    import keras_geometric_tpu_torch as kgt
    from keras_geometric_tpu_torch import parallel as par
    from keras_geometric_tpu_torch.parallel.attend_plan import (
        build_attend_plan,
    )

    mesh = par.make_mesh((1,), device_type="cuda")
    masks = {"train_mask": np.ones(cs.ARXIV_NODES, bool)}
    x, edges, y = cs.arxiv_arrays(symmetric=True)
    pg = par.partition_graph(edges, cs.ARXIV_NODES, 1, gcn_normalize=True,
                             add_self_loops=True)
    gcn_data = par.shard_partitioned_graph(
        pg, mesh, x=x, y=y, masks=masks, kernel_plan=par.build_kernel_plan(pg))
    gx, gedges, gy = cs.gat_arxiv_arrays()
    gpg = par.partition_graph(gedges, cs.ARXIV_NODES, 1, add_self_loops=True)
    gat_data = par.shard_partitioned_graph(
        gpg, mesh, x=gx, y=gy, masks=masks,
        kernel_plan=par.build_kernel_plan(gpg),
        attend_plan=build_attend_plan(gpg))

    def gen():
        return torch.Generator(device=device).manual_seed(0)

    models = {
        "gcn": (lambda: par.distributed_gcn_encoder(
            (cs.HIDDEN, cs.ARXIV_CLASSES), input_dim=cs.ARXIV_FEATS,
            generator=gen(), device=device), gcn_data),
        "gatv2": (lambda: kgt.GNNEncoder.for_context(
            "gatv2", cs.GAT_ARXIV_DIMS, input_dim=cs.ARXIV_FEATS,
            conv_kwargs={"heads": cs.GAT_ARXIV_HEADS}, generator=gen(),
            device=device), gat_data),
    }
    result = {}
    for label, (make, data) in models.items():
        model = make()
        step = par.make_distributed_train_step(
            model, torch.optim.Adam(model.parameters(), lr=1e-2), mesh,
            compute_dtype=torch.bfloat16, generator=gen())
        for _ in range(5):
            step(data)
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(20):
            step(data)
        queued = time.perf_counter() - start
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        result[label] = {"host_ms_per_step": queued / 20 * 1e3,
                         "wall_ms_per_step": wall / 20 * 1e3}
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("distributed_host_probe: no CUDA device", file=sys.stderr)
        return 1
    import subprocess

    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    store = ROOT / "build" / f"probe_store_{os.getpid()}"
    store.parent.mkdir(exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group(
        "nccl", init_method=f"file://{store}", rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=120))
    try:
        report = {"collectives": collectives(dist, device),
                  "steps": steps(device)}
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "torch": torch.__version__,
                      "nccl": ".".join(map(str, torch.cuda.nccl.version())),
                      **report}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
