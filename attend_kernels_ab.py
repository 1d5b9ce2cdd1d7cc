#!/usr/bin/env python3
"""Time the fused GATv2 attention kernels of several copies of
keras_geometric_tpu_torch on one CUDA card, in turns, to compare versions
inside one run.

Each argument is a directory that holds a copy of the package (``.`` for this
checkout; unpack another commit with ``git archive <commit>
keras_geometric_tpu_torch | tar -x -C build/parent``). Each copy runs in its
own process, in the order given (give them as parent, change, change,
parent), builds its kernels from its own sources, and prints one JSON line
(after a first line with the card's name and power limit): the median
milliseconds (CUDA events, after a write over a buffer ten times the L2
cache, which also keeps the card busy, about 0.17 ms, while the host
prepares the call, so that a small kernel's time is the card's alone) of
each attention kernel it has, in each of its modes, and of the sender
finish (the fused-gather scatter over ``bwd_perm``), at the two arxiv-shaped
GATv2 layers (169,343 nodes, 1,335,586 random edges plus self-loops, 4 heads
of 64 then of 40, bf16) and the two CiteSeer-shaped ones (3,327 nodes, 2 x
4,732 edges plus self-loops, 8 heads of 8 then of 6, f32, a dropout mask),
each on the context as ``prepare_graph`` pads it, with the slot counts and
the longest row. ``--unpadded`` adds the same graphs prepared with
``edge_chunk=1``, whose streams hold no padded slot. ``--band`` adds the
banded SpMM (``band_spmm``) at the banded GCN runs' shapes (169,472 padded
nodes, a dense random bf16 band of 1,024 columns, row blocks of 256, F =
128, 40, 100, 47 and 7, and 104, 48 and 8, where a copy that has it also
times the route of F = 100, 47 and 7 there) and at the banded twin's
(20,480 padded nodes, a dense random f32 band, F = 64 and 16), each with
the route it takes, beside ``torch.bmm`` over the row blocks with the ``x``
windows gathered beforehand. ``--gcn`` adds the fused-gather scatter (K1) at the
arxiv-shaped GCN's two layers (169,343 nodes padded to 169,472, 2 x
583,121 symmetric edges, GCN weights and the densified diagonal in bf16, F
= 128 and 40). Where a copy's fused-gather scatter walks pieces, the GCN
cases and the sender finish are also timed as its row walk
(``pieces=False``). ``--only=a,b`` keeps the named groups of cases
(``attend``: the forward, rho and the receiver backward in every mode;
``send``: the sender backward; ``finish``; ``gcn``; ``band``; ``window``:
the window scatter at the windowed GATv2 run's two widths, H*F = 256 and
160 in bf16, on its LPA-reordered community graph with
``attend_window=1024``, beside ``index_add_`` over the eligible slots and,
where a copy lists those slots in sender order, the row walk of that list,
with the host seconds of that context's ``prepare_graph``;
``composed``: the composed path's score kernel (K7a), softmax statistics
(K5) and score backward (K7b) at the four GATv2 shapes on ``hj =
ht[senders]`` and the fused forward's scores, with whether K7a's scores
equal the fused forward's on every valid slot and K5's ``(m, l)`` the
fused forward's on every row and on the rows of one piece, and K5's and
K7b's CUDA kernels timed apart by ``torch.profiler`` (the walk, then the
second launch: K5's merge of split rows, K7b's sum of the ``datt``
partials)), so that a copy that changes one kernel is timed on that
kernel alone; beside K7b, a copy of ``hj`` into a tensor like it (the
``[E, H*F]`` read and write that are most of K7b's bytes: what the card
reaches on them); the normalisation (K6) on seeded ``[E, H]`` f32 scores
(``-inf`` on padded slots) and K5's statistics of them, beside a copy of
those scores into a like tensor, with the SHA-256 of K6's f32 and bf16
alpha bytes and of its inputs, so that the copies' bits can be compared.
``two_pass``: the two-pass forward, K8 (``sddmm_stats_sorted``) and K10a
(``attend_aggregate_sorted``), beside the one-pass forward K9 at the four
GATv2 shapes (``--unpadded`` adds the streams without padded slots) and at
4 heads of 64 in bf16 on ``chip_smoke.py``'s ``skewed_graph`` with its
20,000-slot hub row and without it, with whether K8's scores, ``m`` and
``l`` equal K9's (on every row, and on the rows of one piece), the SHA-256
of K10a's output on the rows of at most one piece (to compare the copies'
bits) and K8's and K10a's CUDA kernels timed apart by ``torch.profiler``
(the walk, then the merge of split rows). ``narrow``: the narrow segment
max (K3) over seeded ``[E, 4]`` scores in bf16 and f32 with the slot mask,
on the arxiv-shaped GATv2 graph (``--unpadded`` adds it without padded
slots) and on ``skewed_graph`` with its 20,000-slot hub row and without
it, beside a copy of the scores and ``torch.segment_reduce``, with whether
it equals its plain version; K3 and the copy are also timed behind the
flush read back, so that no dirty line of the flush is written back while
they run (``clean L2``). ``messages``: the messages-form scatter (K1's
``scatter_sum_sorted``) and the expand (K2) at the shapes the training runs
give them, on ``chip_smoke.py``'s contexts: the composed GATv2 arxiv and
CiteSeer runs' messages (H*F = 256 / 160 bf16, 64 / 48 f32) and softmax row
sums (H = 4 / 8, f32), the Cora-shaped GCN's weighted F = 16 and the
Cora-shaped GraphSAGE's masked F = 1,433 / 16 (f32), and at H*F = 256 bf16
and H = 4 f32 on ``chip_smoke.py``'s ``skewed_graph`` with its
20,000-slot hub row and without it, each beside a copy of
its ``[E, F]`` block into a like tensor (the bytes' ceiling the card
reaches), with each CUDA kernel of a call timed apart by ``torch.profiler``
(the one launch, or a walk and a split-row launch); ``--unpadded`` adds the
same graphs prepared with ``edge_chunk=1``. ``step``: the composed and the fused GATv2 training step
of ``chip_smoke.py``'s arxiv-shaped run (its workload, model and Adam; 8
steps first), each timed twice by two schemes in turn, both taken from
this checkout so that every copy is timed by the same code: ``timed_steps``
of this checkout's ``utils/profiling.py`` as ``chip_smoke.py`` calls it
(``k_lo=2, k_hi=12, trials=2``, seconds x 1e3) and the mean of 10 steps
after 2 (how ``step_ms`` was taken before ``timed_steps`` returned seconds).
With ``--ptxas`` it first prints, per copy, the registers and
spills that ``nvcc -Xptxas -v`` reports for the attention kernels' bf16
instantiations at the arxiv widths and their f32 ones at CiteSeer's, for
the fused-gather scatter's at bf16 (16-byte packs) and f32 (four-wide
packs), for the window scatter's and the score kernels' (K7a, K7b, K8) at
those widths, for the softmax kernels (K5 and its merge, K6) and for the
narrow segment max (K3).

    python3 attend_kernels_ab.py build/parent . . build/parent --ptxas
    python3 attend_kernels_ab.py build/parent . . build/parent --gcn \
        --only=send,finish,gcn --unpadded
    python3 attend_kernels_ab.py build/parent . . build/parent \
        --only=window,composed --ptxas
    python3 attend_kernels_ab.py build/parent . . build/parent --only=step
    python3 attend_kernels_ab.py build/parent . . build/parent \
        --only=messages --unpadded --ptxas
    python3 attend_kernels_ab.py build/parent . . build/parent \
        --only=two_pass,composed --unpadded --ptxas
    python3 attend_kernels_ab.py build/parent . . build/parent \
        --only=two_pass,narrow --unpadded --ptxas
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

GROUPS = ("attend", "send", "finish", "gcn", "band", "window", "composed",
          "two_pass", "messages", "narrow", "step")
# Template arguments of the instantiations --ptxas shows, per source.
SHOWN = {"attend.cu": ("unsigned short, 8, 1", "float, 4, 1", "float, 2, 1"),
         # the fused gather's piece walk, its row walk; the messages form
         # and expand (the parent's row walk of messages: "..., false>")
         # without weights or mask, with weights (f32), with a mask (F=1433)
         "spmm.cu": ("unsigned short, 8>", "float, 4>",
                     "unsigned short, 8, true>", "float, 4, true>",
                     "unsigned short, 8, false>", "float, 4, false>",
                     "float, 1, false>", "unsigned short, 8, false, false>",
                     "float, 4, false, false>", "float, 4, true, false>",
                     "float, 1, false, true>"),
         # the window scatter; K11's TMA kernel (the parent's "<128>",
         # "<40>"), its flat-x instantiations at F = 100, 47, 7, the wmma
         # kernel at F = 7 (the parent's route there), the f32 kernel (the
         # parent's has no template) at the twin's F = 64 and 16
         "band.cu": ("unsigned short, 8>", "band_bf16_tma_kernel<128",
                     "band_bf16_tma_kernel<40", "tma_kernel<104, true>",
                     "tma_kernel<48, true>", "tma_kernel<8, true>",
                     "band_bf16_kernel<1, false>", "band_f32_kernel(",
                     "band_f32_kernel<64, 32, true>",
                     "band_f32_kernel<16, 64, true>"),
         "sddmm.cu": ("unsigned short, 8, 1, false>", "float, 4, 1, false>",
                      "float, 2, 1, false>"),
         "softmax.cu": ("softmax_stats", "softmax_apply"),
         "segment_max.cu": ("segment_max_sorted",)}
# The case groups of each attention-shape case (the rest are attend's).
CASE_GROUP = {"sender finish": ("finish",),
              "sender finish (rows)": ("finish",),
              "attend_send_bwd_sorted": ("send",),
              "sddmm_scores_sorted": ("composed",),
              "softmax_stats_sorted": ("composed",),
              "softmax_apply_sorted": ("composed",),
              "sddmm_bwd_sorted": ("composed",),
              "hj copy": ("composed",), "scores copy": ("composed",),
              "sddmm_stats_agg_sorted": ("attend", "two_pass"),
              "sddmm_stats_sorted": ("two_pass",),
              "attend_aggregate_sorted": ("two_pass",)}
# The CUDA kernels of a call, timed apart (a name matches the kernels that
# contain it): the piece walk, then the second launch.
SPLIT = {"softmax_stats_sorted": ("softmax_stats_kernel",
                                  "softmax_stats_finish_kernel"),
         "sddmm_stats_sorted": ("sddmm_stats_kernel",
                                "softmax_stats_finish_kernel"),
         "attend_aggregate_sorted": ("attend_aggregate_kernel",
                                     "shares_finish_kernel"),
         "sddmm_bwd_sorted": ("sddmm_bwd_kernel", "reduce_partials_kernel"),
         # the parent's messages form (the row walk's template), the new one
         "scatter_sum_sorted": ("scatter_sum_sorted_kernel",
                                "scatter_messages_kernel"),
         "expand_sorted": ("expand_sorted_kernel",)}


def ptxas_report(root: str) -> list:
    """The ptxas lines of the shown instantiations of a copy's sources."""
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "nvcc")
    out = []
    for name, shown_args in SHOWN.items():
        source = os.path.join(root, "keras_geometric_tpu_torch", "kernels",
                              "csrc", name)
        proc = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xptxas", "-v", "-c", "-o", os.devnull, source],
            capture_output=True, text=True, check=True)
        kernel = None
        for line in proc.stderr.splitlines():
            found = re.search(r"Compiling entry function '(\S+)'", line)
            if found:
                kernel = subprocess.run(["c++filt", found.group(1)],
                                        capture_output=True,
                                        text=True).stdout
            regs = re.search(r"Used (\d+) registers", line)
            spill = re.search(r"(\d+) bytes spill stores", line)
            shown = kernel and any(a in kernel for a in shown_args)
            if shown and (regs or spill):
                kname = re.search(r"::(\w+(?:<[^>]*>)?)\(", kernel).group(1)
                out.append({"root": root, "kernel": kname,
                            "line": line.strip()})
    return out


def from_this_checkout(name: str, path: str):
    """A module of this checkout loaded by its path, whichever copy of the
    package the process imports."""
    import importlib.util

    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(here, path))
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module  # its dataclasses look themselves up there
    spec.loader.exec_module(module)
    return module


def step_times(device) -> dict:
    """Milliseconds per composed / fused GATv2 training step at the arxiv
    shape, by both schemes in turn (see the module's docstring)."""
    import torch

    import keras_geometric_tpu_torch as kgt
    from keras_geometric_tpu_torch.training import (
        make_node_classification_step)

    smoke = from_this_checkout("_ab_chip_smoke", "chip_smoke.py")
    profiling = from_this_checkout(
        "_ab_profiling", "keras_geometric_tpu_torch/utils/profiling.py")

    def mean_ms(fn, warmup=2, iters=10):
        for _ in range(warmup):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / iters

    ctx, x, y, mask, _ = smoke.gat_arxiv_workload(device)
    out = {}
    for name, fused in (("composed", False), ("fused", True)):
        gen = torch.Generator(device=device).manual_seed(0)
        model = kgt.GNNEncoder.for_context(
            "gatv2", smoke.GAT_ARXIV_DIMS, input_dim=smoke.ARXIV_FEATS,
            conv_kwargs={"heads": smoke.GAT_ARXIV_HEADS,
                         "fused_attend": fused},
            generator=gen, device=device)
        step = make_node_classification_step(
            model, torch.optim.Adam(model.parameters(), lr=1e-2),
            compute_dtype=torch.bfloat16,
            generator=torch.Generator(device=device).manual_seed(7))
        fn = lambda: step(x, None, y, mask, context=ctx)  # noqa: E731
        for _ in range(8):
            fn()
        times = {"timed_steps ms": [], "mean of 10 ms": []}
        for _ in range(2):
            times["timed_steps ms"].append(1e3 * profiling.timed_steps(
                fn, k_lo=2, k_hi=12, trials=2))
            times["mean of 10 ms"].append(mean_ms(fn))
        out[name] = times
        del model, step, fn
        torch.cuda.empty_cache()
    return out


def message_times(device, chunks, cold_ms, split_ms) -> dict:
    """K1's messages form and K2 at the training runs' shapes (see the
    module's docstring), each beside a copy of its ``[E, F]`` block."""
    import types

    import torch

    from keras_geometric_tpu_torch.kernels import spmm_cuda as K

    smoke = from_this_checkout("_ab_chip_smoke", "chip_smoke.py")

    def hub_graph(dev, hub=20_000):
        g = smoke.skewed_graph(dev, hub=hub)
        return (types.SimpleNamespace(num_nodes=g["n"], receivers=g["recv"],
                                      row_ptr=g["row_ptr"],
                                      edge_mask=g["mask"]),)

    gat_widths = [smoke.GAT_ARXIV_HEADS * d for d in smoke.GAT_ARXIV_DIMS]
    cs_widths = [smoke.GAT_CITESEER_HEADS * d
                 for d in smoke.GAT_CITESEER_DIMS]
    f32, bf16 = torch.float32, torch.bfloat16
    graphs = (  # context, (width, type, weighted, masked) of each case
        ("composed arxiv", smoke.gat_arxiv_workload,
         [(gat_widths[0], bf16, False, False),
          (gat_widths[1], bf16, False, False),
          (smoke.GAT_ARXIV_HEADS, f32, False, False)]),
        ("composed citeseer", smoke.citeseer_workload,
         [(cs_widths[0], f32, False, False), (cs_widths[1], f32, False, False),
          (smoke.GAT_CITESEER_HEADS, f32, False, False)]),
        ("cora", smoke.cora_workload, [(16, f32, True, False)]),
        ("sage cora", lambda dev: smoke.cora_workload(dev, gcn=False),
         [(1_433, f32, False, True), (16, f32, False, True)]),
        ("hub", hub_graph, [(gat_widths[0], bf16, False, False),
                            (smoke.GAT_ARXIV_HEADS, f32, False, False)]),
        ("no hub", lambda dev: hub_graph(dev, hub=0),
         [(gat_widths[0], bf16, False, False),
          (smoke.GAT_ARXIV_HEADS, f32, False, False)]),
    )
    gen = torch.Generator(device=device).manual_seed(17)
    out = {}
    for name, workload, cases in graphs:
        prepared = workload(device)[0]
        for pad_name, _ in chunks:
            if pad_name != "padded" and "hub" in name:
                continue  # chip_smoke.skewed_graph has no unpadded twin
            ctx = (prepared if pad_name == "padded"
                   else smoke.unpadded_context(prepared))
            n, e = ctx.num_nodes, ctx.receivers.shape[0]
            lengths = ctx.row_ptr[1:] - ctx.row_ptr[:-1]
            key = f"{name} {pad_name}"
            out[key] = {"slots": e, "longest_row": int(lengths.max())}
            for f, dtype, weighted, masked in cases:
                msgs = torch.randn(e, f, generator=gen,
                                   device=device).to(dtype)
                rows = torch.randn(n, f, generator=gen,
                                   device=device).to(dtype)
                w = (torch.rand(e, generator=gen, device=device)
                     if weighted else None)
                mask = ctx.edge_mask if masked else None
                if masked and mask is None:  # a stream without padding
                    mask = torch.ones(e, dtype=torch.bool, device=device)
                copy = torch.empty_like(msgs)
                calls = {
                    "scatter_sum_sorted": lambda: K.scatter_sum_sorted(
                        msgs, ctx.receivers, n, row_ptr=ctx.row_ptr,
                        weights=w, mask=mask),
                    "expand_sorted": lambda: K._expand_raw(
                        rows, ctx.receivers, w, mask),
                    "[E, F] copy": lambda: copy.copy_(msgs),
                }
                times = {call: cold_ms(fn) for call, fn in calls.items()}
                for call, names in SPLIT.items():
                    if call in calls:
                        times[f"{call} split ms"] = split_ms(calls[call],
                                                             names)
                out[key][f"F={f} {str(dtype)[6:]}"
                         f"{' weighted' if weighted else ''}"
                         f"{' masked' if masked else ''}"] = times
                del msgs, rows, copy, calls
            del ctx
        del prepared
        torch.cuda.empty_cache()
    return out


def narrow_times(device, chunks, cold_ms, clean_ms) -> dict:
    """The narrow segment max (K3) over seeded ``[E, 4]`` scores in bf16 and
    f32 with the slot mask, on ``chip_smoke.py``'s arxiv-shaped GATv2 graph
    (``--unpadded`` adds it without padded slots) and on its
    ``skewed_graph`` with the 20,000-slot hub row and without it, beside a
    copy of the scores into a like tensor and ``torch.segment_reduce``, with
    whether the kernel equals its plain version; K3 and the copy also behind
    a flush read back (``clean_ms``)."""
    import types

    import torch

    from keras_geometric_tpu_torch.kernels import spmm_cuda as K

    smoke = from_this_checkout("_ab_chip_smoke", "chip_smoke.py")

    def hub_graph(dev, hub=20_000):
        g = smoke.skewed_graph(dev, hub=hub)
        return (types.SimpleNamespace(num_nodes=g["n"], receivers=g["recv"],
                                      row_ptr=g["row_ptr"],
                                      edge_mask=g["mask"]),)

    graphs = (("arxiv", smoke.gat_arxiv_workload), ("hub", hub_graph),
              ("no hub", lambda dev: hub_graph(dev, hub=0)))
    gen = torch.Generator(device=device).manual_seed(19)
    heads = smoke.GAT_ARXIV_HEADS
    out = {}
    for name, workload in graphs:
        prepared = workload(device)[0]
        for pad_name, _ in chunks:
            if pad_name != "padded" and "hub" in name:
                continue  # chip_smoke.skewed_graph has no unpadded twin
            ctx = (prepared if pad_name == "padded"
                   else smoke.unpadded_context(prepared))
            n, e = ctx.num_nodes, ctx.receivers.shape[0]
            lengths = ctx.row_ptr[1:] - ctx.row_ptr[:-1]
            key = f"{name} {pad_name}"
            out[key] = {"slots": e, "longest_row": int(lengths.max())}
            mask = ctx.edge_mask
            if mask is None:  # a stream without padding
                mask = torch.ones(e, dtype=torch.bool, device=device)
            for dtype in (torch.bfloat16, torch.float32):
                scores = torch.randn(e, heads, generator=gen,
                                     device=device).to(dtype)
                copy = torch.empty_like(scores)
                got = K.segment_max_sorted(scores, ctx.receivers, n,
                                           row_ptr=ctx.row_ptr, mask=mask)
                out[key][str(dtype)[6:]] = {
                    "segment_max_sorted": cold_ms(
                        lambda: K.segment_max_sorted(
                            scores, ctx.receivers, n, row_ptr=ctx.row_ptr,
                            mask=mask)),
                    "[E, K] copy": cold_ms(lambda: copy.copy_(scores)),
                    "segment_max_sorted, clean L2": clean_ms(
                        lambda: K.segment_max_sorted(
                            scores, ctx.receivers, n, row_ptr=ctx.row_ptr,
                            mask=mask)),
                    "[E, K] copy, clean L2": clean_ms(
                        lambda: copy.copy_(scores)),
                    "torch.segment_reduce": cold_ms(
                        lambda: torch.segment_reduce(
                            scores, "max", lengths=lengths, unsafe=True)),
                    "equal to plain": bool(torch.equal(
                        got, K.segment_max_sorted_plain(
                            scores, ctx.receivers, n, mask=mask))),
                }
                del scores, copy, got
            del ctx
        del prepared
        torch.cuda.empty_cache()
    return out


def digest(t) -> str:
    """The first 16 hex digits of the SHA-256 of a tensor's bytes."""
    import hashlib

    import torch

    raw = t.detach().contiguous().flatten().view(torch.uint8).cpu().numpy()
    return hashlib.sha256(raw.tobytes()).hexdigest()[:16]


def two_pass_hub_times(device, cold_ms, split_ms) -> dict:
    """K8, K10a and K9 at the arxiv layer-1 width (4 heads of 64, bf16) on
    ``chip_smoke.py``'s ``skewed_graph`` with its 20,000-slot hub row and
    without it, K8's CUDA kernels apart, and whether K8's scores, ``m`` and
    ``l`` equal K9's."""
    import torch

    from keras_geometric_tpu_torch.kernels import attend_cuda as A
    from keras_geometric_tpu_torch.kernels import sddmm_cuda as D
    from keras_geometric_tpu_torch.kernels import spmm_cuda as K

    smoke = from_this_checkout("_ab_chip_smoke", "chip_smoke.py")
    gen = torch.Generator(device=device).manual_seed(18)
    out = {}
    for label, hub in (("with hub row", 20_000), ("without hub row", 0)):
        g = smoke.skewed_graph(device, hub=hub)
        heads, f = 4, 64
        ht = (0.5 * torch.randn(g["n"], heads * f, generator=gen,
                                device=device)).to(torch.bfloat16)
        att = (0.3 * torch.randn(heads, f, generator=gen,
                                 device=device)).to(torch.bfloat16)
        graph = (g["idx"], g["recv"], g["row_ptr"])
        valid = g["mask"]
        _, scores, m, l = A.sddmm_stats_agg_sorted(ht, *graph, att,
                                                   edge_valid=valid)
        k8 = D.sddmm_stats_sorted(ht, *graph, att, edge_valid=valid)
        lengths = g["row_ptr"][1:] - g["row_ptr"][:-1]
        calls = {
            "sddmm_stats_sorted": lambda: D.sddmm_stats_sorted(
                ht, *graph, att, edge_valid=valid),
            "attend_aggregate_sorted": lambda: A.attend_aggregate_sorted(
                scores, m, l, ht, *graph),
            "sddmm_stats_agg_sorted": lambda: A.sddmm_stats_agg_sorted(
                ht, *graph, att, edge_valid=valid),
        }
        one = lengths <= K.RECV_BWD_PIECE
        out[label] = {
            "slots": int(valid.shape[0]), "longest_row": int(lengths.max()),
            **{call: cold_ms(fn) for call, fn in calls.items()},
            "sddmm_stats_sorted split ms": split_ms(
                calls["sddmm_stats_sorted"], SPLIT["sddmm_stats_sorted"]),
            "attend_aggregate_sorted split ms": split_ms(
                calls["attend_aggregate_sorted"],
                SPLIT["attend_aggregate_sorted"]),
            "K10a one-piece rows sha256": digest(
                calls["attend_aggregate_sorted"]()[one]),
            "K8 equals K9": all(torch.equal(a, b)
                                for a, b in zip(k8, (scores, m, l))),
        }
        del g, ht, scores, m, l, k8, calls
        torch.cuda.empty_cache()
    return out


def time_copy(root: str, unpadded: bool, groups: set) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import inspect

    import numpy as np
    import torch

    import keras_geometric_tpu_torch as kgt
    from keras_geometric_tpu_torch.kernels import _build
    from keras_geometric_tpu_torch.kernels import attend_cuda as A
    from keras_geometric_tpu_torch.kernels import band_cuda as B
    from keras_geometric_tpu_torch.kernels import sddmm_cuda as D
    from keras_geometric_tpu_torch.kernels import softmax_cuda as S
    from keras_geometric_tpu_torch.kernels import spmm_cuda as K

    if not A.__file__.startswith(os.path.abspath(root) + os.sep):
        raise SystemExit(f"imported {A.__file__}, not the copy in {root}")
    device = torch.device("cuda")
    gat = bool(groups & {"attend", "send", "finish", "composed", "two_pass"})
    band = "band" in groups
    window = "window" in groups
    step = "step" in groups
    _build.load_libraries(["spmm"] + (["attend"] if gat or step else [])
                          + (["sddmm", "softmax"]
                             if groups & {"composed", "two_pass"} or step
                             else [])
                          + (["band"] if band or window else [])
                          + (["segment_max"] if "narrow" in groups else []))
    flush = torch.empty(512 * 1024 * 1024, dtype=torch.uint8, device=device)
    has_pieces = "pieces" in inspect.signature(
        K.gather_scatter_sum_sorted).parameters

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

    def clean_ms(fn, iters=20, warmup=3):
        """cold_ms with the flush read back before each call: its dirty
        lines are written back then, and the L2 holds clean lines, so a
        call's misses write nothing back."""
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(iters):
            flush.zero_()
            flush.max()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            pairs.append((start, stop))
        torch.cuda.synchronize()
        times = sorted(a.elapsed_time(b) for a, b in pairs)
        return times[len(times) // 2]

    def split_ms(fn, names, iters=20, warmup=3):
        """Device milliseconds per call of the CUDA kernels whose names
        contain each of ``names``, from ``torch.profiler`` over ``iters``
        calls, each behind the flush."""
        from torch.profiler import ProfilerActivity, profile

        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        out = dict.fromkeys(names, 0.0)
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
            for name in names:
                if name in ev.key:
                    out[name] += us / 1e3 / iters
        return out

    rng = np.random.default_rng(0)
    n, e = 169_343, 1_335_586
    arxiv = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    nc, pairs = 3_327, 4_732
    a, b = rng.integers(0, nc, pairs), rng.integers(0, nc, pairs)
    citeseer = np.stack([np.concatenate([a, b]), np.concatenate([b, a])])
    shapes = (("arxiv", arxiv, n, 4, (64, 40), torch.bfloat16, False),
              ("citeseer", citeseer, nc, 8, (8, 6), torch.float32, True))
    chunks = [("padded", {})]
    if unpadded:
        chunks.append(("unpadded", {"edge_chunk": 1}))
    has_modes = "attend_send_bwd_sorted" in A.LAUNCH_COUNTS
    result = {"root": root, "card": torch.cuda.get_device_name(0),
              "groups": sorted(groups)}
    if "step" in groups:
        result["step"] = step_times(device)
    if "messages" in groups:
        result["messages"] = message_times(device, chunks, cold_ms, split_ms)
    if "two_pass" in groups:
        result["two_pass hub"] = two_pass_hub_times(device, cold_ms, split_ms)
    if "narrow" in groups:
        result["narrow"] = narrow_times(device, chunks, cold_ms, clean_ms)
    if "gcn" in groups:
        # chip_smoke.py's arxiv_workload: the features are drawn first.
        half = 1_166_243 // 2
        gcn_rng = np.random.default_rng(0)
        gcn_rng.standard_normal((n, 128))
        a = gcn_rng.integers(0, n, half).astype(np.int32)
        b = gcn_rng.integers(0, n, half).astype(np.int32)
        sym = np.stack([np.concatenate([a, b]), np.concatenate([b, a])])
        gen = torch.Generator(device=device).manual_seed(2)
        for pad_name, kwargs in chunks:
            ctx = kgt.prepare_graph(
                sym, n, add_self_loops=True, gcn_normalize=True,
                symmetric=True, densify_self_loops=True, pad_nodes=True,
                device=device, **kwargs).with_weight_dtype(torch.bfloat16)
            key = f"gcn {pad_name}"
            lengths = ctx.row_ptr[1:] - ctx.row_ptr[:-1]
            result[key] = {"slots": ctx.senders.shape[0],
                           "padded_slots": ctx.senders.shape[0]
                           - ctx.num_real_edges,
                           "longest_row": int(lengths.max())}
            for layer, f in (("layer 1", 128), ("layer 2", 40)):
                h = torch.randn(ctx.num_nodes, f, generator=gen,
                                device=device).to(torch.bfloat16)
                args = (h, ctx.senders, ctx.receivers, ctx.row_ptr,
                        ctx.num_nodes)
                kw = dict(weights=ctx.edge_weight,
                          self_weight=ctx.self_weight)
                cases = {"K1 gcn": lambda: K.gather_scatter_sum_sorted(
                    *args, **kw)}
                if has_pieces:
                    cases["K1 gcn (rows)"] = lambda: (
                        K.gather_scatter_sum_sorted(*args, pieces=False,
                                                    **kw))
                result[key][layer] = {case: cold_ms(fn)
                                      for case, fn in cases.items()}
                del h, args
            del ctx
            torch.cuda.empty_cache()
    if not gat:
        shapes = ()
    if window:
        # chip_smoke.py's gat_skewed context: the community graph of arxiv's
        # size relabelled by its LPA cluster order, with self-loops,
        # edge_chunk=512 and attend_window=1024.
        from keras_geometric_tpu_torch.data.datasets import community_graph
        from keras_geometric_tpu_torch.ops import reorder

        ei = community_graph(n, 2 * (1_166_243 // 2), seed=0)
        src, dst = ei[0].astype(np.int64), ei[1].astype(np.int64)
        inv = reorder.invert_order(reorder.cluster_order(src, dst, n))
        start = time.perf_counter()
        ctx = kgt.prepare_graph(np.stack([inv[src], inv[dst]]), n,
                                add_self_loops=True, edge_chunk=512,
                                pad_nodes=True, attend_window=1024,
                                device=device)
        torch.cuda.synchronize()
        prepare_s = time.perf_counter() - start
        plan, tab = ctx.attw_plan, ctx.attw_sender
        sel = tab >= 0
        rows = plan.num_windows * plan.window
        result["window"] = {"slots": tab.shape[0],
                            "eligible": int(sel.sum()), "rows": rows,
                            "prepare_graph_seconds": prepare_s}
        gen = torch.Generator(device=device).manual_seed(13)
        for layer, d in (("layer 1", 256), ("layer 2", 160)):
            v = torch.randn(tab.shape[0], d, generator=gen,
                            device=device).to(torch.bfloat16)
            v_sel, senders = v[sel], tab[sel].long()
            cases = {
                "window_scatter_sum": lambda: B.window_scatter_sum(
                    v, tab, plan),
                "index_add_": lambda: torch.zeros(
                    rows, d, dtype=v.dtype, device=device).index_add_(
                        0, senders, v_sel),
            }
            if hasattr(plan, "scatter_idx"):  # the sender-order list
                cases["window_scatter_sum (row walk)"] = lambda: (
                    K.gather_scatter_sum_sorted(
                        v, plan.scatter_idx, None, plan.scatter_row_ptr,
                        rows, pieces=False))
            result["window"][layer] = {case: cold_ms(fn)
                                       for case, fn in cases.items()}
            del v, v_sel, cases
        del ctx, plan, tab
        torch.cuda.empty_cache()
    if band:
        gen = torch.Generator(device=device).manual_seed(13)
        result["band"] = {}
        # (n_pad, dtype, widths): the skewed GCN runs' band (bf16; the arxiv
        # and products widths, F = 7, the padded widths) and the banded
        # twin's (f32, examples_torch/locality_banded_gcn.py).
        for n_pad, dtype, widths in (
                (169_472, torch.bfloat16, (128, 40, 100, 47, 7, 104, 48, 8)),
                (20_480, torch.float32, (64, 16))):
            window, rb = 1_024, 256
            nb = n_pad // rb
            mat = torch.randn(n_pad, window, generator=gen,
                              device=device).to(dtype)
            base_idx = torch.from_numpy(B._block_base_rows(
                n_pad, window, rb).astype(np.int32)).to(device)
            rows = (base_idx.long() * (window // 2))[:, None] + torch.arange(
                window, device=device)
            for f in widths:
                x = torch.randn(n_pad, f, generator=gen,
                                device=device).to(dtype)
                windows = x.index_select(0, rows.reshape(-1)).view(
                    nb, window, f)
                case = {
                    "route": B.band_route(f, window, rb, dtype),
                    "band_spmm": cold_ms(lambda: B.band_matmul(
                        x, mat, base_idx, window, rb)),
                    "torch.bmm": cold_ms(lambda: torch.bmm(
                        mat.view(nb, rb, window), windows)),
                }
                if (dtype == torch.bfloat16 and f % 8 == 0 and
                        hasattr(B, "_band_matmul_on")):
                    # a padded width on the route of the width below it
                    case["band_spmm (wgmma_flat)"] = cold_ms(
                        lambda: B._band_matmul_on(
                            "wgmma_flat", x, mat, base_idx, window, rb))
                result["band"][f"n_pad={n_pad} {str(dtype)[6:]} F={f}"] = case
                del x, windows
            del mat
        torch.cuda.empty_cache()
    for name, edges, nodes, heads, dims, dtype, dropped in shapes:
        for pad_name, kwargs in chunks:
            ctx = kgt.prepare_graph(edges.astype(np.int32), nodes,
                                    add_self_loops=True, device=device,
                                    **kwargs)
            gen = torch.Generator(device=device).manual_seed(6)
            graph = (ctx.senders, ctx.receivers, ctx.row_ptr)
            valid = ctx.edge_mask
            slots = ctx.senders.shape[0]
            lengths = ctx.row_ptr[1:] - ctx.row_ptr[:-1]
            lengths_ss = ctx.row_ptr_bwd[1:] - ctx.row_ptr_bwd[:-1]
            key = f"{name} {pad_name}"
            result[key] = {
                "slots": slots,
                "padded_slots": slots - int(valid.sum()),
                "longest_row": int(lengths.max()),
                "longest_row_at": int(lengths.argmax()),
                "longest_sender_row": int(lengths_ss.max()),
            }
            for layer, f in zip(("layer 1", "layer 2"), dims):
                d = heads * f
                ht = (0.5 * torch.randn(nodes, d, generator=gen,
                                        device=device)).to(dtype)
                att = (0.3 * torch.randn(heads, f, generator=gen,
                                         device=device)).to(dtype)
                g = torch.randn(nodes, d, generator=gen,
                                device=device).to(dtype)
                drop = drop_ss = None
                if dropped:
                    u = torch.rand(slots, heads, generator=gen, device=device)
                    drop = torch.where(u < 0.7, 1.0 / 0.7, 0.0).to(dtype)
                    drop_ss = drop.index_select(0, ctx.bwd_perm.long())
                _, scores, m, l = A.sddmm_stats_agg_sorted(
                    ht, *graph, att, edge_valid=valid, drop_mask=drop)
                rho = A.attend_rho_sorted(g, scores, m, l, ht, *graph,
                                          drop_mask=drop)
                _, _, v = A.attend_recv_bwd_full_sorted(
                    ht, g, *graph, att, scores, m, l, rho, drop_mask=drop)

                def recv_bwd(cached=True, emit_v=True):
                    return A.attend_recv_bwd_full_sorted(
                        ht, g, *graph, att, scores if cached else None, m,
                        l, rho, edge_valid=None if cached else valid,
                        emit_v=emit_v, drop_mask=drop)

                finish = (v, ctx.bwd_perm, ctx.senders_sorted,
                          ctx.row_ptr_bwd, nodes)
                hj = ds = None
                if "composed" in groups:
                    hj = ht.index_select(0, ctx.senders)
                    ds = torch.randn(slots, heads, generator=gen,
                                     device=device).masked_fill(
                                         ~valid[:, None], 0.0)
                # The copy's score kernel and backward walk the pieces of
                # row_ptr where their signatures take it.
                k7a_kw, k7b_kw = (
                    {"row_ptr": ctx.row_ptr} if "row_ptr" in
                    inspect.signature(fn).parameters else {}
                    for fn in (D.sddmm_scores_sorted, D.sddmm_bwd_sorted))
                cases = {
                    "sddmm_stats_agg_sorted": lambda: (
                        A.sddmm_stats_agg_sorted(ht, *graph, att,
                                                 edge_valid=valid,
                                                 drop_mask=drop)),
                    "attend_rho_sorted": lambda: A.attend_rho_sorted(
                        g, scores, m, l, ht, *graph, drop_mask=drop),
                    "attend_recv_bwd_full_sorted": recv_bwd,
                }
                if "finish" in groups:
                    cases["sender finish"] = (
                        lambda: K.gather_scatter_sum_sorted(*finish))
                    if has_pieces:
                        cases["sender finish (rows)"] = (
                            lambda: K.gather_scatter_sum_sorted(
                                *finish, pieces=False))
                if has_modes:
                    cases.update({
                        "sddmm_stats_agg_sorted(emit_scores=False)": lambda: (
                            A.sddmm_stats_agg_sorted(
                                ht, *graph, att, edge_valid=valid,
                                drop_mask=drop, emit_scores=False)),
                        "attend_rho_sorted(scores=None)": lambda: (
                            A.attend_rho_sorted(
                                g, None, m, l, ht, *graph, att=att,
                                edge_valid=valid, drop_mask=drop)),
                        "attend_recv_bwd_full_sorted(scores=None)": (
                            lambda: recv_bwd(cached=False)),
                        "attend_recv_bwd_full_sorted(emit_v=False)": (
                            lambda: recv_bwd(emit_v=False)),
                        "attend_recv_bwd_full_sorted(scores=None, "
                        "emit_v=False)": (
                            lambda: recv_bwd(cached=False, emit_v=False)),
                        "attend_send_bwd_sorted": lambda: (
                            A.attend_send_bwd_sorted(
                                ht, g, ctx.receivers_ss, ctx.senders_sorted,
                                ctx.row_ptr_bwd, att, m, l, rho,
                                valid_ss=ctx.edge_mask_ss, drop_ss=drop_ss)),
                    })
                cases["sddmm_scores_sorted"] = lambda: (
                    D.sddmm_scores_sorted(ht, hj, att, ctx.receivers,
                                          **k7a_kw))
                # K5 on the fused forward's scores (-inf on padded slots).
                cases["softmax_stats_sorted"] = lambda: (
                    S.softmax_stats_sorted(scores, ctx.receivers,
                                           ctx.row_ptr, nodes))
                cases["sddmm_bwd_sorted"] = lambda: D.sddmm_bwd_sorted(
                    ht, hj, att, ds, ctx.receivers, **k7b_kw)
                if hj is not None:
                    hj_out = torch.empty_like(hj)
                    cases["hj copy"] = lambda: hj_out.copy_(hj)
                    # K6 on seeded scores (-inf on padded slots) and K5's
                    # statistics of them, beside a copy of those scores.
                    k6_scores = (3.0 * torch.randn(
                        slots, heads, generator=gen, device=device)
                    ).masked_fill(~valid[:, None], float("-inf"))
                    k6_m, k6_l = S.softmax_stats_sorted(
                        k6_scores, ctx.receivers, ctx.row_ptr, nodes)
                    k6_like = torch.empty_like(k6_scores)
                    cases["softmax_apply_sorted"] = lambda: (
                        S.softmax_apply_sorted(k6_scores, k6_m, k6_l,
                                               ctx.receivers))
                    cases["scores copy"] = lambda: k6_like.copy_(k6_scores)
                # The two-pass forward as it is, beside K9 (above).
                cases["sddmm_stats_sorted"] = lambda: D.sddmm_stats_sorted(
                    ht, *graph, att, edge_valid=valid)
                cases["attend_aggregate_sorted"] = lambda: (
                    A.attend_aggregate_sorted(scores, m, l, ht, *graph,
                                              drop_mask=drop))
                cases = {k: fn for k, fn in cases.items()
                         if set(CASE_GROUP.get(k, ("attend",))) & groups}
                result[key][layer] = {case: cold_ms(fn)
                                      for case, fn in cases.items()}
                if "composed" in groups:
                    # One score function: the composed path's scores are the
                    # fused forward's on every valid slot.
                    k7a = D.sddmm_scores_sorted(ht, hj, att, ctx.receivers,
                                                **k7a_kw)
                    result[key][layer]["scores equal K9's"] = bool(
                        torch.equal(k7a[valid], scores[valid]))
                    k5_m, k5_l = S.softmax_stats_sorted(
                        scores, ctx.receivers, ctx.row_ptr, nodes)
                    same = (k5_m == m).all(1) & (k5_l == l).all(1)
                    one = lengths <= K.RECV_BWD_PIECE
                    result[key][layer].update({
                        "stats equal K9's on every row": bool(same.all()),
                        "stats equal K9's on one-piece rows": bool(
                            same[one].all()),
                        "one-piece rows": int(one.sum()),
                    })
                    # K6's bits, to compare across copies: its f32 and bf16
                    # alpha and the inputs they came from.
                    result[key][layer]["softmax_apply_sorted sha256"] = {
                        what: digest(t) for what, t in (
                            ("scores, m, l", torch.cat([
                                k6_scores.flatten(), k6_m.flatten(),
                                k6_l.flatten()])),
                            ("alpha f32", S.softmax_apply_sorted(
                                k6_scores, k6_m, k6_l, ctx.receivers)),
                            ("alpha bf16", S.softmax_apply_sorted(
                                k6_scores, k6_m, k6_l, ctx.receivers,
                                out_dtype=torch.bfloat16)))}
                    del k7a, k5_m, k5_l, k6_scores, k6_m, k6_l, k6_like
                if "two_pass" in groups:
                    # K8 walks K9's pieces: its scores, m and l are K9's.
                    k8 = D.sddmm_stats_sorted(ht, *graph, att,
                                              edge_valid=valid)
                    same = (k8[1] == m).all(1) & (k8[2] == l).all(1)
                    one = lengths <= K.RECV_BWD_PIECE
                    k10a = A.attend_aggregate_sorted(scores, m, l, ht,
                                                     *graph, drop_mask=drop)
                    result[key][layer].update({
                        "K10a one-piece rows sha256": digest(k10a[one]),
                        "K8 scores equal K9's": bool(torch.equal(k8[0],
                                                                 scores)),
                        "K8 stats equal K9's on every row": bool(same.all()),
                        "K8 stats equal K9's on one-piece rows": bool(
                            same[one].all()),
                        "one-piece rows": int(one.sum()),
                    })
                    del k8, k10a
                for call, names in SPLIT.items():
                    if call in cases:
                        result[key][layer][f"{call} split ms"] = split_ms(
                            cases[call], names)
                del v, scores, cases, finish, hj, ds
                hj_out = None
            del ctx
            torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)


def groups_of(flags) -> set:
    """The case groups the flags ask for: ``--only=`` names them; otherwise
    the attention's (attend, send, finish), plus gcn / band when asked."""
    only = [f.split("=", 1)[1] for f in flags if f.startswith("--only=")]
    if only:
        groups = set(only[-1].split(","))
        unknown = groups - set(GROUPS)
        if unknown:
            raise SystemExit(f"unknown groups {sorted(unknown)}; known: "
                             f"{GROUPS}")
        return groups
    return ({"attend", "send", "finish"} | ({"gcn"} if "--gcn" in flags
                                            else set())
            | ({"band"} if "--band" in flags else set()))


def main() -> int:
    args = sys.argv[1:]
    if args and args[0] == "--child":
        time_copy(args[1], "--unpadded" in args, groups_of(args[2:]))
        return 0
    flags = [a for a in args if a in ("--ptxas", "--unpadded", "--band",
                                      "--gcn") or a.startswith("--only=")]
    roots = [a for a in args if a not in flags]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    groups_of(flags)  # refuses an unknown group before anything runs
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    if "--ptxas" in flags:
        unique = list(dict.fromkeys(roots))
        with ThreadPoolExecutor(max_workers=len(unique)) as pool:
            for lines in pool.map(ptxas_report, unique):
                for line in lines:
                    print(json.dumps(line), flush=True)
    for root in roots:
        subprocess.run([sys.executable, __file__, "--child", root,
                        *[a for a in flags if a != "--ptxas"]],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
