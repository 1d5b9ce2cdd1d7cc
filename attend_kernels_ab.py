#!/usr/bin/env python3
"""Time the fused GATv2 attention kernels of several copies of
keras_geometric_tpu_torch on one CUDA card, in turns, to compare versions
inside one run.

Each argument is a directory that holds a copy of the package (``.`` for this
checkout; unpack another commit with ``git archive <commit>
keras_geometric_tpu_torch | tar -x -C build/parent``). Each copy runs in its
own process, in the order given (give them as parent, change, change,
parent), builds its kernels from its own sources, and prints one JSON line
(after a first line with the card's name and power limit):
the median milliseconds (CUDA events, after a write over a buffer larger than
the L2 cache) of each attention kernel it has, at the two arxiv-shaped GATv2
layers (169,343 nodes, 1,335,586 random edges plus self-loops, 4 heads of 64
then of 40, bf16). With ``--ptxas`` it first prints, per copy, the registers
and spills that ``nvcc -Xptxas -v`` reports for the kernels' bf16
instantiations at those widths.

    python3 attend_kernels_ab.py build/parent . . build/parent --ptxas
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys


def ptxas_report(root: str) -> None:
    source = os.path.join(root, "keras_geometric_tpu_torch", "kernels", "csrc",
                          "attend.cu")
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "nvcc")
    proc = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-Xptxas", "-v", "-c", "-o", os.devnull, source],
        capture_output=True, text=True, check=True)
    kernel = None
    for line in proc.stderr.splitlines():
        found = re.search(r"Compiling entry function '(\S+)'", line)
        if found:
            kernel = subprocess.run(["c++filt", found.group(1)],
                                    capture_output=True, text=True).stdout
        regs = re.search(r"Used (\d+) registers", line)
        spill = re.search(r"(\d+) bytes spill stores", line)
        if kernel and "unsigned short, 8, 1" in kernel and (regs or spill):
            name = re.search(r"::(\w+<[^>]*>)\(", kernel).group(1)
            print(json.dumps({"root": root, "kernel": name,
                              "line": line.strip()}), flush=True)


def time_copy(root: str) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import keras_geometric_tpu_torch as kgt
    from keras_geometric_tpu_torch.kernels import _build
    from keras_geometric_tpu_torch.kernels import attend_cuda as A

    if not A.__file__.startswith(os.path.abspath(root) + os.sep):
        raise SystemExit(f"imported {A.__file__}, not the copy in {root}")
    device = torch.device("cuda")
    _build.load_library("attend")
    rng = np.random.default_rng(0)
    n, e = 169_343, 1_335_586
    edges = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    ctx = kgt.prepare_graph(edges.astype(np.int32), n, add_self_loops=True,
                            device=device)
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=device)

    def cold_ms(fn, iters=20, warmup=3):
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(iters):
            flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            pairs.append((start, stop))
        torch.cuda.synchronize()
        times = sorted(a.elapsed_time(b) for a, b in pairs)
        return times[len(times) // 2]

    gen = torch.Generator(device=device).manual_seed(6)
    graph = (ctx.senders, ctx.receivers, ctx.row_ptr)
    valid = ctx.edge_mask
    has_modes = "attend_send_bwd_sorted" in A.LAUNCH_COUNTS
    result = {"root": root,
              "card": torch.cuda.get_device_name(0)}
    for layer, f in (("layer 1", 64), ("layer 2", 40)):
        d = 4 * f
        ht = (0.5 * torch.randn(n, d, generator=gen, device=device)).to(
            torch.bfloat16)
        att = (0.3 * torch.randn(4, f, generator=gen, device=device)).to(
            torch.bfloat16)
        g = torch.randn(n, d, generator=gen, device=device).to(torch.bfloat16)
        _, scores, m, l = A.sddmm_stats_agg_sorted(ht, *graph, att,
                                                   edge_valid=valid)
        rho = A.attend_rho_sorted(g, scores, m, l, ht, *graph)
        cases = {
            "sddmm_stats_agg_sorted": lambda: A.sddmm_stats_agg_sorted(
                ht, *graph, att, edge_valid=valid),
            "attend_rho_sorted": lambda: A.attend_rho_sorted(
                g, scores, m, l, ht, *graph),
            "attend_recv_bwd_full_sorted": lambda: (
                A.attend_recv_bwd_full_sorted(ht, g, *graph, att, scores, m,
                                              l, rho)),
        }
        if has_modes:
            cases.update({
                "attend_rho_sorted(scores=None)": lambda: A.attend_rho_sorted(
                    g, None, m, l, ht, *graph, att=att, edge_valid=valid),
                "attend_recv_bwd_full_sorted(scores=None)": lambda: (
                    A.attend_recv_bwd_full_sorted(
                        ht, g, *graph, att, None, m, l, rho,
                        edge_valid=valid)),
                "attend_recv_bwd_full_sorted(emit_v=False)": lambda: (
                    A.attend_recv_bwd_full_sorted(
                        ht, g, *graph, att, scores, m, l, rho,
                        emit_v=False)),
                "attend_send_bwd_sorted": lambda: A.attend_send_bwd_sorted(
                    ht, g, ctx.receivers_ss, ctx.senders_sorted,
                    ctx.row_ptr_bwd, att, m, l, rho,
                    valid_ss=ctx.edge_mask_ss),
            })
        result[layer] = {name: cold_ms(fn) for name, fn in cases.items()}
    print(json.dumps(result), flush=True)


def main() -> int:
    args = sys.argv[1:]
    if args and args[0] == "--child":
        time_copy(args[1])
        return 0
    ptxas = "--ptxas" in args
    roots = [a for a in args if a != "--ptxas"]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    if ptxas:
        for root in dict.fromkeys(roots):
            ptxas_report(root)
    for root in roots:
        subprocess.run([sys.executable, __file__, "--child", root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
