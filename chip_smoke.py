#!/usr/bin/env python3
"""Drive keras_geometric_tpu_torch on one NVIDIA GPU: build its CUDA kernels,
hold each against its plain PyTorch version, and train the 2-layer GCN and the
2-layer GATv2 (fused and composed attention, the fused attention's other
backward and score-cache modes, and both models on the locality tier), and
GraphSAGE and GIN (their max and pooling paths through the segment max
kernel) through the package's entry points; the GCN and the GATv2 on an
ogbn-products-sized graph (2.45M nodes, 123.7M edges); then GraphSAGE minibatch,
partitioned full-graph training on ``torch.distributed`` (a mesh of one
card, and a four-partition plan as four processes on it), tensor and data
parallelism (four processes on the card each), GIN graph classification on
the library ops, the readouts, and the twins of the examples.

Run from the repository root, with no arguments, on a machine with one CUDA
card, nvcc and PyTorch built for CUDA::

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure ends the run with a non-zero
exit code and without the final line; so does a run of a subset of the phases
(``--phases``), which exits with code 4 once its phases have passed):

1. ``device``   card, power limit (nvidia-smi), toolchain, kernel build, and
                the registers and spills ``nvcc -Xptxas -v`` reports for the
                band kernels (TMA, both ways of bringing x; f32) and the
                kernels that walk pieces (forward,
                rho, both backwards, the fused-gather scatter and its row
                walk, the composed path's score kernel, score backward,
                softmax statistics and normalisation, and the two-pass
                forward's score-and-statistics kernel);
2. ``kernels``  every kernel against its plain version on a skewed-degree
                graph (hub row, empty rows, padded slots; bf16 and f32;
                F in 128, 40, 16, 7; weighted / unweighted / masked; the
                attention kernels at (H, F) in (4, 64), (4, 40), (8, 8),
                (8, 6), (1, 7), with and without a dropout mask; the
                composed path's score kernels at the same (H, F) (the score
                backward's ``d_pre`` and ``datt`` also bit for bit over two
                launches, and refused without ``row_ptr``; at the composed
                runs' shapes the score kernel bit for bit against the fused
                forward's scores on ``hj = ht[senders]`` and the softmax
                statistics of those scores bit for bit against the fused
                forward's ``m`` and ``l`` on every row), its softmax kernels
                at K in 1, 4, 8 with a row whose scores are all -inf), the
                band SpMM at F in 1, 7, 40, 47, 100, 128, 130, 256 and
                W in 256, 512, 1024 (symmetric and transposed plans, a row
                block with an empty band, the clamped last block), the window
                scatter at F in 8, 40, 160, 256 (a window with no item, a
                row of thousands of eligible slots, an all -1 table; held
                against its sum in f64, two launches bit for bit, and bit
                for bit against the row walk of its sender-order list on
                every row of at most 32 eligible slots, as also at the
                windowed GATv2 run's shapes); the attention
                kernels' other modes (the forward without its scores, rho
                and the receiver backward recomputing them, the receiver
                backward without ``v``), the sender backward, the
                score-and-statistics kernel and the aggregation at the same
                (H, F) on a graph that adds a 20,000-slot hub sender, an
                empty and an all-invalid sender row and the padded tail in
                sender order, each mode also bit for bit against the cached
                launch, the score-and-statistics kernel against the
                forward's scores, ``m`` and ``l`` on every row (the
                20,000-slot hub receiver row and the padded tail included),
                and two sender-backward launches against each other, the
                permute finish on the same graph (the fused-gather scatter's
                piece walk, and bit for bit its row walk on every sender row
                of at most one piece; the same on every fused-gather case of
                the sweep above and at the training shapes below); the
                attention kernels also at
                the wide heads (H, F) in (1, 320), (2, 512), which walk a
                head in 256-column slabs; the narrow segment max at K in
                1, 3, 4, 6, 8, 11, 16 (the scores also at an address off
                their pack's alignment) and the wide one, forward and both
                tie rules of its
                backward, at F in 1, 7, 40, 128, 256, 320 on tied inputs
                (bf16 and f32, with and without the slot mask), forwards bit
                for bit; then timings at the shapes the training paths use
                (the receiver walks also on the same graph without padded
                slots, the kernels that walk pieces with their work list's
                pieces and split rows and their times with and without the
                hub row, the band kernel at the banded runs' widths and at
                F = 7, each also at its width padded to a multiple of 8 and
                into an output filled with NaN past its end;
                the messages-form scatter and expand also at the composed
                CiteSeer and the Cora-shaped GraphSAGE shapes, each the same
                bits over two calls, expand its plain version's bits, the
                scatter an f64 sum's value and, at the Cora and CiteSeer
                shapes, a serial slot-order walk's bits on every row of at
                most one piece), and the fused attention kernels at one head
                of 256 columns against the wide heads; last, the kernels
                whose ``[E, D]`` operand passes 2**31 elements at
                ogbn-products' widths (K2, K1's messages form, K4 forward
                and backward, K10c's ``v``) on such an operand, against their
                plain versions on sampled blocks of rows whose element
                offsets pass 2**31 (``past_int32_case``);
3. ``autograd`` gradients of ``GraphContext.spmm`` (symmetric and general),
                ``gather`` and ``scatter_weighted`` through the kernels against
                autograd over the plain versions, of ``GraphContext.attend``,
                ``sddmm_scores`` and ``edge_softmax`` against autograd over
                restatements of them in library ops (``attend`` in every
                combination of ``ATTEND_BWD_MODE`` and ``ATTEND_SCORE_CACHE``,
                with and without dropout, and the send mode's fallback for a
                mask without its sender-order twin); ``return_attention=True``
                on the CiteSeer-shaped context; ``spmm`` on a symmetric and a
                directed band context and ``attend`` on an ``attend_window``
                context against autograd over the plain versions;
                ``GINConv`` (sum, mean, max) and ``SAGEConv`` (all six
                aggregators) on a CUDA context with tied inputs, and
                ``GATv2Conv`` with two heads of 320 columns, against the same
                layers on the plain versions (f32 and bf16);
4. ``train_arxiv_shape``  the slice at full width: 169,343 nodes, 1,166,242
                symmetric stream edges, 128 features, 256 hidden, 40 classes,
                bf16 IO / f32 master parameters, Adam;
5. ``train_directed`` (the general, asymmetric operator) and
   ``train_cora_shape`` (2,708 nodes / 10,556 edges / 1,433 features / 16
                hidden / 7 classes, dropout 0.5 on layer 1: gather + weighted
                scatter forward, expand kernel in the backward);
6. ``train_gat_arxiv_shape``  the attention slice at full width: 169,343
                nodes, 1,335,586 directed edges plus self-loops, 128 features,
                GATv2 4 heads x 64 then 4 heads x 40, bf16 IO / f32 master
                parameters, Adam;
7. ``train_gat_citeseer_shape``  3,327 nodes / 9,464 edges / 3,703 features /
                8 heads x 8 then 8 heads x 6, attention dropout, f32, AdamW;
                then a short run whose last layer averages its heads;
8. ``train_gat_arxiv_shape_composed`` and ``train_gat_citeseer_shape_composed``
                the same two GATv2 workloads with ``fused_attend=False``:
                gather, score kernel, softmax kernels, ``alpha * hj``, scatter;
                step 1 also against the fused model's;
9. ``train_gat_arxiv_shape_send``, ``_nocache``, ``_send_nocache`` and
   ``train_gat_citeseer_shape_send``  the fused GATv2 runs with the
                attention's module constants set (``ATTEND_BWD_MODE =
                "send"``: the sender backward kernel in place of ``v`` and
                its fused-gather finish; ``ATTEND_SCORE_CACHE = False``: the
                scores recomputed in the backward) and restored after; step
                1 also against the default modes' (the same loss, gradients
                within the tolerance below); the CiteSeer run draws the
                dropout mask pair the sender backward reads;
10. ``attend_two_pass_arxiv_shape``  the two-pass forward (score-and-
                statistics kernel, then the aggregation) at both arxiv-shaped
                GATv2 layers against the one-pass forward: scores, ``m``,
                ``l`` bit for bit, the output under the kernel tolerance
                against the one-pass forward and the plain version; then
                the aggregation at layer 1 with a dropout mask, and on the
                kernel sweep's graph with and without its 20,000-slot hub
                row;
11. ``train_skewed_arxiv_shape``  the locality tier: a scrambled community
                graph of 169,343 nodes and 1,166,242 edges relabelled by the
                LPA cluster order, ``band_window=1024``, the GCN of run 4;
                step 1 also against the same graph without the band; then
                ``precompute_propagation`` on both contexts; then
                ``train_skewed_products_widths``: the same contexts with
                ogbn-products' widths, random features of 100 columns and
                labels of 47 classes (seed 0), ``GNNEncoder.for_context(
                "gcn", (256, 47))``, bf16 IO / f32 masters, Adam: the band
                kernel 3 times a step at F = 100 and 47 (x by 1-D copies),
                step 1 also against the same graph without the band;
                this run and the fused GATv2 arxiv runs of 6 and 9 also
                trace five more steps (device busy time, idle share);
12. ``train_gat_skewed_arxiv_shape``  the same graph with self-loops and
                ``attend_window=1024``, the GATv2 of run 6; step 1 also against
                the same graph without the window tables;
13. ``segment_max_narrow_arxiv_shape``  the narrow segment max over random
                ``[E, 4]`` scores (bf16 and f32) on run 6's graph, bit for bit
                against its plain version and the softmax statistics kernel's
                ``m`` (no module calls it: this is its path), then on the
                kernel sweep's graph with and without its 20,000-slot hub
                row, bit for bit;
14. ``train_sage_pool_arxiv_shape`` and ``train_gin_max_arxiv_shape``  run 6's
                graph and features, ``GraphSAGE((256, 40),
                aggregator="pooling")`` and a GIN with ``aggregator="max"``,
                128 -> 256 -> 40, bf16 IO / f32 masters, Adam (1e-3): the
                wide segment max and its backward with the ties split;
15. ``train_sage_cora_shape``  run 5's Cora-shaped graph without self-loops,
                ``GraphSAGE((16, 7))`` (mean) with message dropout 0.5, f32,
                AdamW: the per-edge mean (messages-form scatter);
16. ``train_sage_minibatch_ogbn_arxiv``  the data tier and neighbour-sampled
                GraphSAGE minibatch training on the repository's ogbn-arxiv
                cache (``data/ogbn_arxiv``, 169,343 nodes, 2,332,486 edges):
                ``NeighborSampler`` fanouts (25, 10), batch 512, ``SAGEConv``
                128 -> 256 -> 40 (mean), Adam 1e-3, f32, features and labels
                held on the card; 20 batches through ``prefetch``; step 1
                against the same bucket's step on the CPU, the loss falling,
                a checkpoint resumed bit for bit, sampled validation
                accuracy, host and device times, the device's idle share
                and the bucket's real against padded rows (no hand-written
                kernel lies on this path: the aggregations are library ops,
                as the reference's are XLA segment ops);
17. ``train_gcn_ogbn_arxiv``  the full-graph GCN of run 4 on the same
                dataset's own graph and train split, through ``prepare_graph``
                (the fused-gather scatter, 3 launches a step);
18. ``train_gcn_ogbn_products``  BASELINE.json's north star on the one
                card: a size-faithful ogbn-products stand-in (2,449,029
                nodes, 123,718,280 symmetrized edges, 100 features, 47
                classes, a 60/20/20 split) generated with numpy from seed 0
                into the git-ignored ``build/ogb`` at a first run and read
                from there by the next, prepared as run 17 (2,449,152
                padded nodes), ``GNNEncoder.for_context("gcn", (256,
                47))``, bf16 IO / f32 masters, Adam, the train split as the
                loss mask: K1's row walk 3 a step (layer 1 propagates first
                at F = 100); step 1 against the plain versions run block by
                block (``PlainContext(ctx, block_slots=2**23)``: no
                ``[E, F]`` array of this graph fits whole); host seconds,
                peak host memory, peak device memory, ``step_ms``, device
                busy time and idle share, stream edges a second; then K1 at
                both widths against its blocked plain version, with
                ``torch.sparse.mm`` beside it;
19. ``train_gat_ogbn_products``  the same graph with one self-loop a node
                in the stream (126,167,309 edges), the GATv2 of run 6 at
                100 -> 4 x 64 -> 4 x 47 in ``ATTEND_BWD_MODE = "send"``
                with the score cache (restored after): 2 each of K9, K10b,
                K10c without ``v`` and K10d a step; step 1 against the
                plain versions in blocks of 2**21 slots, and the same
                numbers as run 18; then those four kernels at both layers
                against their plain versions run block by block;
20. ``train_distributed_arxiv_shape``  partitioned full-graph training
                (``parallel/``) on an NCCL process group of one rank (a
                ``file://`` store under ``build/``) and a mesh ``(1,)``:
                ``train_arxiv_shape``'s graph partitioned with the GCN
                normalization and self-loops folded in, its kernel plan,
                ``distributed_gcn_encoder((256, 40))`` (run 4's weights),
                20 steps of ``make_distributed_train_step`` (bf16 IO / f32
                masters, Adam); then run 6's fused GATv2 over an attend
                plan (the no-cache kernels over the exchanged table). Each:
                step 1 against the single-device port at the same weights
                (the GATv2 in the no-cache mode), the bf16 limits below;
                launches a step exactly as predicted (``DIST_GCN_PER_STEP``,
                ``DIST_GAT_PER_STEP``) and no fallback taken; the
                evaluation function's accuracy; ``step_ms``, device busy
                time and idle share beside the single-device run's, timed
                in the same call; the group destroyed at the end;
21. ``distributed_partitions_arxiv_shape``  a P = 4 plan of run 11's
                community graph in ``community_partition_order`` (halo size
                and comm fraction beside the cluster order alone and the
                uniform graph's), each partition a process of its own on
                the one card, the four in a gloo group (NCCL takes one rank
                a card) whose all-to-all carries the halo rows: each runs
                the public ``spmm_local_overlapped`` (the local and remote
                K1 streams at F = 128 / 40 bf16), ``pooled_max_local``
                (the two streams' K4 maxes at F = 128 / 256 f32, columns
                of distinct values) and ``attend_local`` (H = 4, F = 64),
                forward and backward; launches per rank exactly as
                predicted; the outputs and gradients reassembled and held
                against the single-device context's ops and the plain
                versions (K4's forward bit for bit; elsewhere the kernel
                tolerance plus a unit in the last place of the sum of the
                parts' absolute values, for parts rounded to bf16 before
                they are added), each check's limit and largest reference
                reported, and each shown to fail an output of zeros;
22. ``tensor_parallel_arxiv_shape``  the tensor-parallel blocks at the
                main path's widths on run 4's graph with its self-loops and
                GCN normalisation: the GCN pair 128 -> 256 -> 40 and GATv2
                at 4 heads x 64 (concat, the fused arxiv config's layer 1)
                and 4 heads x 40 (mean), on a 1-D ``model`` mesh of 4 and a
                ``(graph 2, model 2)`` mesh partitioned by
                ``partition_graph``, each rank a process of its own on the
                card in a gloo group; the outputs, ``d x`` and each
                parameter shard's gradient held against the unsharded
                layers run here in f32 with the same weights (2e-4 of the
                largest entry), the GCN's output also against the context
                path (K1); each block's forward + backward ms per rank and
                the unsharded block's; one world-1 NCCL run of the GCN block
                through the default ``make_mesh``; no hand-written kernel
                on this path (library segment ops, as the reference's XLA);
23. ``train_dp_graph_classification``  run 24's configuration (the 5-layer
                GIN at width 32, sum readout, Adam 1e-3, f32, buckets of 768
                nodes / 6,144 edges holding 32 graphs and the dummy)
                trained data-parallel by four processes on the card, one
                bucket each a step, for 10 steps: the losses and final
                parameters against one process over the same four buckets
                (NLL sums and counts added, one backward), the parameters
                equal on every rank, the step ms, 0 hand-written launches;
                one world-1 NCCL run holding all four buckets;
24. ``train_gin_graph_classification``  BASELINE.json config 3 as
                ``examples_torch/graph_classification.py`` builds it: 200
                synthetic graphs of 10-23 nodes (seed 0), buckets of 768
                nodes / 6,144 edges / 33 graph slots, ``GraphClassifier(GIN(
                (32,) * 5, mlp_hidden=(32,)), 3)``, Adam 1e-3, f32; readout
                ``sum`` for the example's 30 epochs (150 steps) and its test
                accuracy, ``mean`` and ``max`` for 11 steps; each: step 1
                against the CPU path, the loss falling, ``step_ms``, device
                busy time and idle share, peak memory, 0 hand-written
                launches (the edge-list GIN and the readout are library ops);
25. ``readouts_on_card``  ``GlobalPooling`` and ``BatchGlobalPooling`` in
                every mode, with and without a node mask, on tied maxes, and
                ``AttentionPooling`` and ``Set2Set`` (3 steps), forward and
                backward against the CPU path (f32 1e-5, bf16 2e-2 of the
                largest entry), on the encoder's output for one padded batch
                and on one graph of 100,000 nodes x 128 features;
26. ``examples_torch``  each of the ten twins of ``examples/`` in
                ``examples_torch/`` (and ``node_classification.py --dataset
                pubmed``) as a process of its own on the card, at the
                fewest epochs its flags allow: every exit code 0, all of
                them within three minutes;
27. ``accuracy_trajectory``  the hardware accuracy gate
                (``tools/accuracy_check_torch.py``, in process): 60 training
                steps on the kernel path and on the plain edge-list path
                from the same parameters, on the reference gate's community
                graph (169,343 nodes, 1,166,242 edges): the GCN 128 -> 256
                -> 40 in f32 and in bf16 IO / f32 masters (K1's row walk, 3
                a step), and the send-mode fused GATv2 at ogbn-products'
                widths 100 -> 4 x 64 -> 4 x 47 in bf16 IO (K9, K10b, K10c
                without ``v`` and K10d, 2 each a step); every logged loss
                (steps 0, 10, ..., 50, 59) within 2% relative of the plain
                path's (the reference's limit) and within 0.15% (the
                port's), final train accuracies within 0.01, launches a
                step exactly as listed; then the control, the f32 GCN with
                the kernel path's edge weights x 1.1, which must break a
                loss limit; the card's name and power limit.

Then one line ``{"kernels": [...]}``, the card's name and power limit as
``nvidia-smi`` prints them, and last ``{"ok": true, "device": {...}}``.

Tolerances. Kernel against plain version, per output element:
``|kernel - plain| <= 1e-6 + 2e-5 * S + u * |plain|`` with ``S`` the sum of
``|w * message|`` over the element's row (both sides accumulate in f32, in
another order) and ``u`` one unit in the last place of the stored type: 0 for
f32, ``2**-7`` for bf16 (both sides round the f32 sum once, and the two
roundings may fall on neighbouring bf16 values). For the attention kernels
``S`` is the sum of the absolute values of the element's terms, and for what
lies behind the softmax's ``exp`` it is multiplied by ``1 + `` the row's
largest score mass (an error ``d`` in a score scales its ``exp`` by
``1 + d``). The softmax kernels are held to the same rule with ``S`` the
element's own value (``m``: its max; alpha: itself; ``l``, a sum of the row's
``n`` positive terms: ``l`` times ``1 + n * 2**-24 / 2e-5``, which adds the
worst-case error ``n * 2**-24 * l`` of such a sum: the plain version adds a
20,000-slot row with atomics in an arbitrary order). Training step 1 through
the kernels against the same step through the plain versions: loss within
``1e-4`` (f32) / ``2e-2`` (bf16 IO), every gradient within ``2e-4`` / ``5e-2``
of its largest entry.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import pathlib
import pickle
import re
import subprocess
import sys
import time

import numpy as np
import torch

from keras_geometric_tpu_torch.kernels import (
    launch_counts,
    mode_launch_counts,
    reset_launch_counts,
)
from keras_geometric_tpu_torch.ops.csr import attend_modes

PHASES = ("device", "kernels", "autograd", "train_arxiv_shape",
          "train_directed", "train_cora_shape", "train_gat_arxiv_shape",
          "train_gat_citeseer_shape", "train_gat_arxiv_shape_composed",
          "train_gat_citeseer_shape_composed", "train_gat_arxiv_shape_send",
          "train_gat_arxiv_shape_nocache",
          "train_gat_arxiv_shape_send_nocache",
          "train_gat_citeseer_shape_send", "attend_two_pass_arxiv_shape",
          "train_skewed_arxiv_shape", "train_skewed_products_widths",
          "train_gat_skewed_arxiv_shape",
          "segment_max_narrow_arxiv_shape", "train_sage_pool_arxiv_shape",
          "train_gin_max_arxiv_shape", "train_sage_cora_shape",
          "train_sage_minibatch_ogbn_arxiv", "train_gcn_ogbn_arxiv",
          "train_gcn_ogbn_products", "train_gat_ogbn_products",
          "train_distributed_arxiv_shape",
          "distributed_partitions_arxiv_shape",
          "tensor_parallel_arxiv_shape", "train_dp_graph_classification",
          "train_gin_graph_classification", "readouts_on_card",
          "examples_torch", "accuracy_trajectory")
# Exit code of a run of a subset of the phases that passed: not 0, so that no
# reader of the exit code takes a partial run for a pass.
PARTIAL_EXIT_CODE = 4

ARXIV_NODES = 169_343
ARXIV_EDGES = 1_166_243
ARXIV_FEATS = 128
ARXIV_CLASSES = 40
HIDDEN = 256
GAT_ARXIV_EDGES = 1_335_586
GAT_ARXIV_DIMS, GAT_ARXIV_HEADS = (64, 40), 4
CITESEER = dict(nodes=3_327, pairs=4_732, feats=3_703, classes=6)
GAT_CITESEER_DIMS, GAT_CITESEER_HEADS = (8, 6), 8
# (H, F) of the attention kernel sweeps; the last two are wider than a warp
# holds at once (256 columns), so the kernels walk them in slabs.
WIDE_HEAD_SHAPES = ((1, 320), (2, 512))
ATTEND_SHAPES = ((4, 64), (4, 40), (8, 8), (8, 6), (1, 7)) + WIDE_HEAD_SHAPES
SOFTMAX_HEADS = (1, 4, 8)  # K of the softmax kernels
SKEWED_EDGES = 2 * (ARXIV_EDGES // 2)  # the community graph's edge count
BAND_WINDOW = ATTEND_WINDOW = 1024
BAND_WIDTHS = (1, 7, 40, 47, 100, 128, 130, 256)  # F of the band sweep
BAND_WINDOWS = (256, 512, 1024)
SCATTER_WIDTHS = (8, 40, 160, 256)  # F of the window scatter sweep
SEGMENT_MAX_HEADS = (1, 3, 4, 6, 8, 11, 16)  # K of the narrow sweep
SEGMENT_MAX_WIDTHS = (1, 7, 40, 128, 256, 320)  # F of the wide one

SOURCES = {
    "spmm": "keras_geometric_tpu_torch/kernels/csrc/spmm.cu",
    "attend": "keras_geometric_tpu_torch/kernels/csrc/attend.cu",
    "softmax": "keras_geometric_tpu_torch/kernels/csrc/softmax.cu",
    "sddmm": "keras_geometric_tpu_torch/kernels/csrc/sddmm.cu",
    "band": "keras_geometric_tpu_torch/kernels/csrc/band.cu",
    "segment_max": "keras_geometric_tpu_torch/kernels/csrc/segment_max.cu",
}
# For each kernel: its CUDA source, and the file (under the reference
# package's kernels/) and line of the pl.pallas_call it replaces.
REPLACES = {
    "scatter_sum_sorted": ("spmm", "spmm_pallas.py", 319),
    "gather_scatter_sum_sorted": ("spmm", "spmm_pallas.py", 319),
    "expand_sorted": ("spmm", "spmm_pallas.py", 620),
    "sddmm_stats_agg_sorted": ("attend", "sddmm_pallas.py", 617),
    "attend_aggregate_sorted": ("attend", "attend_pallas.py", 205),
    "attend_rho_sorted": ("attend", "attend_pallas.py", 441),
    "attend_recv_bwd_full_sorted": ("attend", "attend_pallas.py", 737),
    "attend_send_bwd_sorted": ("attend", "attend_pallas.py", 958),
    "softmax_stats_sorted": ("softmax", "softmax_pallas.py", 168),
    "softmax_apply_sorted": ("softmax", "softmax_pallas.py", 282),
    "sddmm_scores_sorted": ("sddmm", "sddmm_pallas.py", 770),
    "sddmm_bwd_sorted": ("sddmm", "sddmm_pallas.py", 847),
    "sddmm_stats_sorted": ("sddmm", "sddmm_pallas.py", 316),
    "band_spmm": ("band", "band_pallas.py", 393),
    "window_scatter_sum": ("band", "band_pallas.py", 249),
    "segment_max_sorted": ("segment_max", "spmm_pallas.py", 915),
    "segment_max_wide_sorted": ("segment_max", "spmm_pallas.py", 1071),
    # The backward of the same TPU kernel (its custom VJP, whose two sorted
    # expands and select this one kernel replaces).
    "segment_max_wide_bwd": ("segment_max", "spmm_pallas.py", 1071),
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def replaced_tpu_kernels() -> dict:
    """``file:line`` of the TPU kernel each CUDA kernel replaces: the
    reference's sources are found in the checkout and each line is checked to
    hold a ``pallas_call``."""
    root = pathlib.Path(__file__).resolve().parent
    out = {}
    for name, (_, filename, line) in REPLACES.items():
        found = sorted(root.glob(f"*/kernels/{filename}"))
        check(len(found) == 1, f"the reference's kernels/{filename} not found")
        lines = found[0].read_text().splitlines()
        check("pallas_call" in lines[line - 1],
              f"{name}: no pallas_call at line {line} of {filename}")
        out[name] = f"{found[0].relative_to(root).as_posix()}:{line}"
    return out


# Instantiations whose registers and spills the device phase reports (the
# band kernels and the kernels that walk the work list of pieces, at the
# shapes the training runs give them):
# mangled-name fragment -> what it is.
PTXAS_SHOWN = {
    "band_bf16_tma_kernelILi128ELb0E": "band_bf16_tma_kernel<N=128>",
    "band_bf16_tma_kernelILi40ELb0E": "band_bf16_tma_kernel<N=40>",
    "band_bf16_tma_kernelILi104ELb1E":
        "band_bf16_tma_kernel<N=104, flat x> (F=100)",
    "band_bf16_tma_kernelILi48ELb1E":
        "band_bf16_tma_kernel<N=48, flat x> (F=47)",
    "band_bf16_tma_kernelILi8ELb1E": "band_bf16_tma_kernel<N=8, flat x> (F=7)",
    "band_bf16_kernelILi1ELb0E":
        "band_bf16_kernel<NF=1, VEC=false> (wmma, other row blocks)",
    "band_f32_kernelILi64ELi32ELb1E":
        "band_f32_kernel<NC=64, K=32, VEC> (banded twin F=64)",
    "band_f32_kernelILi16ELi64ELb1E":
        "band_f32_kernel<NC=16, K=64, VEC> (banded twin F=16)",
    "attend_recv_bwd_kernelItLi8ELi1ELb0ELb1ELb0E":
        "attend_recv_bwd_kernel<bf16, 8, 1, cached, v> (arxiv)",
    "attend_recv_bwd_kernelItLi8ELi1ELb0ELb0ELb0E":
        "attend_recv_bwd_kernel<bf16, 8, 1, cached, no v> (arxiv, send)",
    "attend_recv_bwd_kernelItLi8ELi1ELb1ELb1ELb0E":
        "attend_recv_bwd_kernel<bf16, 8, 1, recompute, v> (arxiv)",
    "attend_recv_bwd_kernelIfLi4ELi1ELb0ELb1ELb0E":
        "attend_recv_bwd_kernel<f32, 4, 1, cached, v> (CiteSeer L1)",
    "attend_recv_bwd_kernelIfLi2ELi1ELb0ELb1ELb0E":
        "attend_recv_bwd_kernel<f32, 2, 1, cached, v> (CiteSeer L2)",
    "attend_recv_bwd_kernelItLi8ELi1ELb0ELb1ELb1E":
        "attend_recv_bwd_kernel<bf16, 8, 1, cached, v, wide>",
    "recv_bwd_finish_kernelItE": "recv_bwd_finish_kernel<bf16>",
    "sddmm_stats_agg_kernelItLi8ELi1ELb0E":
        "sddmm_stats_agg_kernel<bf16, 8, 1> (arxiv)",
    "sddmm_stats_agg_kernelIfLi4ELi1ELb0E":
        "sddmm_stats_agg_kernel<f32, 4, 1> (CiteSeer L1)",
    "sddmm_stats_agg_kernelItLi8ELi1ELb1E":
        "sddmm_stats_agg_kernel<bf16, 8, 1, wide>",
    "agg_finish_kernelItE": "agg_finish_kernel<bf16>",
    "attend_rho_kernelItLi8ELi1ELb0ELb0E":
        "attend_rho_kernel<bf16, 8, 1, cached> (arxiv)",
    "attend_rho_kernelItLi8ELi1ELb1ELb0E":
        "attend_rho_kernel<bf16, 8, 1, recompute> (arxiv)",
    "attend_rho_kernelIfLi4ELi1ELb0ELb0E":
        "attend_rho_kernel<f32, 4, 1, cached> (CiteSeer L1)",
    "attend_send_bwd_kernelItLi8ELi1ELb0E":
        "attend_send_bwd_kernel<bf16, 8, 1> (arxiv)",
    "attend_send_bwd_kernelIfLi4ELi1ELb0E":
        "attend_send_bwd_kernel<f32, 4, 1> (CiteSeer L1)",
    "attend_send_bwd_kernelItLi8ELi1ELb1E":
        "attend_send_bwd_kernel<bf16, 8, 1, wide>",
    "shares_finish_kernelItE": "shares_finish_kernel<bf16> (K10a, K10d)",
    "attend_aggregate_kernelItLi8ELi1ELb0E":
        "attend_aggregate_kernel<bf16, 8, 1> (two-pass arxiv)",
    "attend_aggregate_kernelItLi8ELi1ELb1E":
        "attend_aggregate_kernel<bf16, 8, 1, wide>",
    "segment_max_sorted_kernelItLi4ELb1E":
        "segment_max_sorted_kernel<bf16, 4, mask> (narrow arxiv)",
    "segment_max_sorted_kernelIfLi4ELb1E":
        "segment_max_sorted_kernel<f32, 4, mask> (narrow arxiv)",
    "gather_scatter_pieces_kernelItLi8E":
        "gather_scatter_pieces_kernel<bf16, 8> (GCN arxiv, finish arxiv)",
    "gather_scatter_pieces_kernelIfLi4E":
        "gather_scatter_pieces_kernel<f32, 4> (finish CiteSeer)",
    "gather_scatter_merge_kernelItE": "gather_scatter_merge_kernel<bf16>",
    "scatter_sum_sorted_kernelItLi8ELb1E":
        "scatter_sum_sorted_kernel<bf16, 8, gather> (the row walk)",
    "scatter_messages_kernelItLi8ELb0ELb0E":
        "scatter_messages_kernel<bf16, 8> (composed arxiv messages)",
    "scatter_messages_kernelIfLi4ELb0ELb0E":
        "scatter_messages_kernel<f32, 4> (row sums, composed CiteSeer)",
    "scatter_messages_kernelIfLi4ELb1ELb0E":
        "scatter_messages_kernel<f32, 4, weights> (Cora GCN)",
    "scatter_messages_kernelIfLi1ELb0ELb1E":
        "scatter_messages_kernel<f32, 1, mask> (Cora GraphSAGE F=1433)",
    "expand_sorted_kernelItLi8ELb0ELb0E":
        "expand_sorted_kernel<bf16, 8> (composed arxiv)",
    "expand_sorted_kernelIfLi4ELb0ELb0E":
        "expand_sorted_kernel<f32, 4> (row sums, composed CiteSeer)",
    "window_scatter_kernelItLi8E":
        "window_scatter_kernel<bf16, 8> (windowed GATv2)",
    "window_scatter_merge_kernelItE": "window_scatter_merge_kernel<bf16>",
    "sddmm_scores_kernelItLi8ELi1ELb0E":
        "sddmm_scores_kernel<bf16, 8, 1> (composed arxiv)",
    "sddmm_scores_kernelIfLi4ELi1ELb0E":
        "sddmm_scores_kernel<f32, 4, 1> (composed CiteSeer L1)",
    "sddmm_scores_kernelIfLi2ELi1ELb0E":
        "sddmm_scores_kernel<f32, 2, 1> (composed CiteSeer L2)",
    "sddmm_bwd_kernelItLi8ELi1ELb0E":
        "sddmm_bwd_kernel<bf16, 8, 1> (composed arxiv)",
    "sddmm_bwd_kernelIfLi4ELi1ELb0E":
        "sddmm_bwd_kernel<f32, 4, 1> (composed CiteSeer L1)",
    "sddmm_bwd_kernelIfLi2ELi1ELb0E":
        "sddmm_bwd_kernel<f32, 2, 1> (composed CiteSeer L2)",
    "sddmm_bwd_kernelItLi8ELi1ELb1E": "sddmm_bwd_kernel<bf16, 8, 1, wide>",
    "softmax_stats_kernelE": "softmax_stats_kernel",
    "softmax_stats_finish_kernelE": "softmax_stats_finish_kernel",
    "softmax_apply_kernelIfLi4EE":
        "softmax_apply_kernel<f32, 4> (composed arxiv, CiteSeer)",
    "sddmm_stats_kernelItLi8ELi1ELb0E":
        "sddmm_stats_kernel<bf16, 8, 1> (two-pass arxiv)",
    "sddmm_stats_kernelItLi8ELi1ELb1E": "sddmm_stats_kernel<bf16, 8, 1, wide>",
}

# The CUDA kernels each call of a piece-walking wrapper launches: the walk
# over the pieces, then (where the work list has split rows) the merge.
PIECE_KERNELS = {
    "sddmm_stats_agg_sorted": ("sddmm_stats_agg_kernel", "agg_finish_kernel"),
    "attend_rho_sorted": ("attend_rho_kernel", "rho_finish_kernel"),
    "attend_recv_bwd_full_sorted": ("attend_recv_bwd_kernel",
                                    "recv_bwd_finish_kernel"),
    "attend_send_bwd_sorted": ("attend_send_bwd_kernel",
                               "shares_finish_kernel"),
    "attend_aggregate_sorted": ("attend_aggregate_kernel",
                                "shares_finish_kernel"),
    "sddmm_stats_sorted": ("sddmm_stats_kernel",
                           "softmax_stats_finish_kernel"),
    "gather_scatter_sum_sorted": ("gather_scatter_pieces_kernel",
                                  "gather_scatter_merge_kernel"),
}


def ptxas_report() -> dict:
    """Registers, spills and static shared memory that ``nvcc -Xptxas -v``
    reports for the instantiations of PTXAS_SHOWN (one compiler per source,
    side by side; object code is discarded)."""
    from concurrent.futures import ThreadPoolExecutor

    from keras_geometric_tpu_torch.kernels import _build

    def one(source):
        flags = [f for f in _build.NVCC_FLAGS if f not in
                 ("-shared", "-Xcompiler", "-fPIC")]
        proc = subprocess.run(
            [_build._find_nvcc(), *flags, "-Xptxas", "-v", "-c", "-o",
             os.devnull, str(_build.CSRC / f"{source}.cu")],
            capture_output=True, text=True, timeout=900)
        check(proc.returncode == 0, f"nvcc -Xptxas -v failed for {source}")
        return proc.stderr.splitlines()

    with ThreadPoolExecutor(max_workers=6) as pool:
        lines = [l for out in pool.map(one, ("band", "attend", "spmm",
                                              "sddmm", "softmax",
                                              "segment_max"))
                 for l in out]
    report, shown = {}, None
    for line in lines:
        found = re.search(r"Compiling entry function '(\S+)'", line)
        if found:
            shown = next((v for k, v in PTXAS_SHOWN.items()
                          if k in found.group(1)), None)
            continue
        if shown is None:
            continue
        item = report.setdefault(shown, {})
        for key, pattern in (("registers", r"Used (\d+) registers"),
                             ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads"),
                             ("smem_bytes", r"(\d+) bytes smem")):
            value = re.search(pattern, line)
            if value:
                item[key] = int(value.group(1))
    check(set(report) == set(PTXAS_SHOWN.values()),
          f"ptxas reported {sorted(report)}, expected every instantiation "
          f"of {sorted(PTXAS_SHOWN.values())}")
    return report


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------


class Timer:
    """Median milliseconds of one call, each call timed by its own pair of
    CUDA events after a write over a buffer ten times the L2 cache, so the
    call finds the cache as cold as it would behind other work; the write
    keeps the card busy (about 0.17 ms) while the host prepares the call, so
    that a small kernel's time is the card's alone."""

    def __init__(self, device):
        self.flush = torch.empty(512 * 1024 * 1024, dtype=torch.uint8,
                                 device=device)

    def cold_ms(self, fn, iters: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            pairs.append((start, stop))
        torch.cuda.synchronize()
        times = sorted(a.elapsed_time(b) for a, b in pairs)
        return times[len(times) // 2]


# ---------------------------------------------------------------------------
# Kernel against plain version
# ---------------------------------------------------------------------------


ATOL, RTOL_MASS = 1e-6, 2e-5
ULP = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7}


def compare(kernel_out, plain_out, mass, dtype, what, partials=None,
            report=False):
    """max |kernel - plain|, checked element by element against
    ``ATOL + RTOL_MASS * mass + ULP[dtype] * (|plain| + partials)``.

    ``partials``: for a result added up from parts that were each rounded
    to ``dtype`` first (the partitions' or the streams'), the sum of the
    parts' absolute values (or a bound above it), element by element; each
    rounding adds at most half a unit of its part. ``report=True`` returns,
    instead of the error, a dict: the error, the limit where the error comes
    nearest it, the largest limit, the largest ``|plain|``, and the share
    of elements where an output of zeros would exceed the limit (above 0:
    zeros fail the check)."""
    check(kernel_out.shape == plain_out.shape and
          kernel_out.dtype == plain_out.dtype, f"{what}: shape/dtype differ")
    k, p = kernel_out.float(), plain_out.float()
    check(bool(torch.isfinite(k).all()), f"{what}: kernel output not finite")
    err = (k - p).abs()
    allowed = ATOL + RTOL_MASS * mass + ULP[dtype] * p.abs()
    if partials is not None:
        allowed = allowed + ULP[dtype] * partials
    ratios = err / allowed
    ratio = ratios.max().item()
    check(ratio <= 1.0, f"{what}: kernel disagrees with its plain version "
          f"(max abs err {err.max().item():.3e}, {ratio:.2f}x the tolerance)")
    if not report:
        return err.max().item()
    worst = int(ratios.argmax())
    return {"max_abs_err": err.max().item(), "err_over_limit": ratio,
            "limit_at_worst": allowed.reshape(-1)[worst].item(),
            "max_limit": allowed.max().item(),
            "max_abs_reference": p.abs().max().item(),
            "zeros_fail_share": (p.abs() > allowed).float().mean().item()}


def skewed_graph(device, n=20_000, seed=1, hub=20_000):
    """Receiver-sorted stream with one hub row (20,000 edges), every odd row
    empty, and padded slots (weight 0) inside the last row."""
    rng = np.random.default_rng(seed)
    recv = np.concatenate([
        np.full(hub, 6), 2 * rng.integers(0, n // 2 - 1, 100_000),
    ])
    recv = np.sort(recv).astype(np.int32)
    e_real = recv.shape[0]
    e_pad = -(-e_real // 1024) * 1024
    recv = np.concatenate([recv, np.full(e_pad - e_real, n - 1, np.int32)])
    idx = rng.integers(0, n, e_pad).astype(np.int32)
    w = rng.uniform(0.05, 1.0, e_pad).astype(np.float32)
    w[e_real:] = 0.0
    mask = np.arange(e_pad) < e_real
    self_w = rng.uniform(0.0, 1.0, n).astype(np.float32)
    row_ptr = np.searchsorted(recv, np.arange(n + 1)).astype(np.int32)
    dev = lambda a: torch.from_numpy(a).to(device)
    return dict(n=n, e=e_pad, recv=dev(recv), idx=dev(idx), w=dev(w),
                mask=dev(mask), self_w=dev(self_w), row_ptr=dev(row_ptr))


def check_one_piece_rows_equal(pieces_out, rows_out, row_ptr, what):
    """The fused-gather form's piece walk against its row walk: the same
    bits on every row of at most one piece's slots (a split row's shares
    are added in another order)."""
    from keras_geometric_tpu_torch.kernels import spmm_cuda as K

    one = (row_ptr[1:] - row_ptr[:-1]) <= K.RECV_BWD_PIECE
    check(torch.equal(pieces_out[one], rows_out[one]),
          f"{what}: the piece walk differs from the row walk on a row that "
          f"is one piece")
    return int(one.sum())


def kernel_sweep(device):
    """Every kernel, every variant, on the skewed graph. Returns the number of
    comparisons and the worst error per kernel."""
    from keras_geometric_tpu_torch.kernels import spmm_cuda as K

    g = skewed_graph(device)
    n, e = g["n"], g["e"]
    gen = torch.Generator(device=device).manual_seed(0)
    worst = {name: 0.0 for name in K.LAUNCH_COUNTS}
    cases = 0
    for dtype in (torch.bfloat16, torch.float32):
        for f in (128, 40, 16, 7):
            msgs = torch.randn(e, f, generator=gen, device=device).to(dtype)
            rows = torch.randn(n, f, generator=gen, device=device).to(dtype)
            w_variants = {"weighted": g["w"], "unweighted": None}
            if dtype == torch.bfloat16:
                w_variants["weighted_bf16"] = g["w"].to(torch.bfloat16)
            for w_name, w in w_variants.items():
                for mask in (None, g["mask"]):
                    tag = (f"{str(dtype)[6:]} F={f} {w_name}"
                           f"{' masked' if mask is not None else ''}")
                    # messages form
                    mass = K.scatter_sum_sorted_plain(
                        msgs.float().abs(), g["recv"], n,
                        weights=None if w is None else w.float().abs(),
                        mask=mask)
                    out = K.scatter_sum_sorted(
                        msgs, g["recv"], n, row_ptr=g["row_ptr"], weights=w,
                        mask=mask)
                    ref = K.scatter_sum_sorted_plain(
                        msgs, g["recv"], n, weights=w, mask=mask)
                    worst["scatter_sum_sorted"] = max(
                        worst["scatter_sum_sorted"],
                        compare(out, ref, mass, dtype,
                                f"scatter_sum_sorted {tag}"))
                    # expand (mask only reaches it as the scatter's VJP)
                    out = K._expand_raw(rows, g["recv"], w, mask)
                    ref = K.expand_sorted_plain(rows, g["recv"], weights=w,
                                                mask=mask)
                    worst["expand_sorted"] = max(
                        worst["expand_sorted"],
                        compare(out, ref, ref.float().abs(), dtype,
                                f"expand_sorted {tag}"))
                    cases += 2
                # fused-gather form, without and with the diagonal epilogue
                for self_w in (None, g["self_w"]):
                    tag = (f"{str(dtype)[6:]} F={f} {w_name}"
                           f"{' +diag' if self_w is not None else ''}")
                    mass = K.gather_scatter_sum_sorted_plain(
                        rows.float().abs(), g["idx"], g["recv"], n,
                        weights=None if w is None else w.float().abs(),
                        self_weight=self_w)
                    out = K.gather_scatter_sum_sorted(
                        rows, g["idx"], g["recv"], g["row_ptr"], n,
                        weights=w, self_weight=self_w)
                    by_rows = K.gather_scatter_sum_sorted(
                        rows, g["idx"], g["recv"], g["row_ptr"], n,
                        weights=w, self_weight=self_w, pieces=False)
                    ref = K.gather_scatter_sum_sorted_plain(
                        rows, g["idx"], g["recv"], n, weights=w,
                        self_weight=self_w)
                    worst["gather_scatter_sum_sorted"] = max(
                        worst["gather_scatter_sum_sorted"],
                        compare(out, ref, mass, dtype,
                                f"gather_scatter_sum_sorted {tag}"),
                        compare(by_rows, ref, mass, dtype,
                                f"gather_scatter_sum_sorted (rows) {tag}"))
                    check_one_piece_rows_equal(
                        out, by_rows, g["row_ptr"],
                        f"gather_scatter_sum_sorted {tag}")
                    cases += 2
    torch.cuda.synchronize()
    # Empty rows are exact zeros; an empty output launches nothing.
    out = K.scatter_sum_sorted(msgs, g["recv"], n, row_ptr=g["row_ptr"])
    check(not out[1::2][:-1].any().item(), "empty rows must be zero")
    # A CUDA tensor never takes the plain version: bad input raises.
    try:
        K.scatter_sum_sorted(msgs.double(), g["recv"], n,
                             row_ptr=g["row_ptr"])
    except TypeError:
        pass
    else:
        check(False, "float64 data must be refused on a CUDA tensor")
    return cases, worst


# [E, D] arrays of more than 2**31 elements, as ogbn-products' per-edge
# arrays are (126.2M slots x 256 columns): K2, K1's messages form and K4 on
# E = 2**24 + 4,096 slots x 128 columns (2,148,007,936 elements, 4.3 GB in
# bf16), K10c's v on 2**23 + 4,096 slots x 256; the sampled blocks of rows:
# the first, the middle and the last ones, whose slots' element offsets
# pass 2**31.
BIG_SLOTS, BIG_F, BIG_NODES = 2**24 + 4_096, 128, 2**20
BIG_ATTEND_SLOTS, BIG_ATTEND_NODES = 2**23 + 4_096, 2**19
BIG_SAMPLE_SLOTS = 2**16


def big_graph(device, gen, slots, nodes):
    """Random receiver-sorted slots over ``nodes`` rows, its ``row_ptr``
    and the sampled blocks of rows (``row_blocks``' kind) of about
    ``BIG_SAMPLE_SLOTS`` slots at the start, the middle and the end."""
    recv = torch.randint(0, nodes, (slots,), generator=gen, device=device,
                         dtype=torch.int32).sort().values
    row_ptr = torch.searchsorted(
        recv, torch.arange(nodes + 1, device=device, dtype=torch.int32)).to(
        torch.int32)
    blocks = row_blocks(row_ptr, BIG_SAMPLE_SLOTS)
    sample = [blocks[0], blocks[len(blocks) // 2], blocks[-1]]
    return recv, row_ptr, sample


def past_int32_case(device):
    """Each kernel whose ``[E, D]`` operand passes 2**31 elements at
    ogbn-products' widths, on such an operand, against its plain version on
    sampled blocks of rows (``big_graph``): K2 and K4's backward bit for
    bit on the blocks' slots, K1's messages form and K4's forward on their
    rows, K10c's ``v`` on its blocks' slots (fed K9's and K10b's outputs,
    under the module docstring's tolerance). A 32-bit element offset would
    wrap on the last blocks. Returns each kernel's largest error and the
    largest element offset it checked."""
    from keras_geometric_tpu_torch.kernels import attend_cuda as A
    from keras_geometric_tpu_torch.kernels import spmm_cuda as K

    gen = torch.Generator(device=device).manual_seed(33)
    recv, row_ptr, sample = big_graph(device, gen, BIG_SLOTS, BIG_NODES)
    rows = torch.randn(BIG_NODES, BIG_F, generator=gen,
                       device=device).to(torch.bfloat16)
    w = torch.rand(BIG_SLOTS, generator=gen, device=device)
    errs = {}
    msgs = K.expand_sorted(rows, recv, row_ptr=row_ptr, weights=w)
    check(msgs.numel() > 2**31, "the [E, F] array must pass 2**31 elements")
    for _, _, lo, hi in sample:
        check(torch.equal(msgs[lo:hi], K.expand_sorted_plain(
            rows, recv[lo:hi], weights=w[lo:hi])),
            f"expand_sorted past 2**31 elements: slots {lo}..{hi} differ "
            f"from the plain version")
    errs["expand_sorted"] = 0.0
    out = K.scatter_sum_sorted(msgs, recv, BIG_NODES, row_ptr=row_ptr,
                               weights=w)
    maxv = K.segment_max_wide_raw(msgs, BIG_NODES, row_ptr=row_ptr)
    g = torch.randn(BIG_NODES, BIG_F, generator=gen, device=device)
    dmsg = K._segment_max_wide_bwd(msgs, maxv, g, recv, row_ptr, BIG_NODES,
                                   None, False)
    errs["scatter_sum_sorted"] = errs["segment_max_wide_sorted"] = 0.0
    for r0, r1, lo, hi in sample:
        local = recv[lo:hi] - r0
        p_out = K.scatter_sum_sorted_plain(msgs[lo:hi], local, r1 - r0,
                                           weights=w[lo:hi])
        mass = K.scatter_sum_sorted_plain(msgs[lo:hi].float().abs(), local,
                                          r1 - r0, weights=w[lo:hi])
        errs["scatter_sum_sorted"] = max(errs["scatter_sum_sorted"], compare(
            out[r0:r1], p_out, mass, torch.bfloat16,
            f"scatter_sum_sorted past 2**31 elements, rows {r0}..{r1}"))
        p_max = K.segment_max_wide_raw_plain(msgs[lo:hi], local, r1 - r0)
        check(torch.equal(maxv[r0:r1], p_max),
              f"segment_max_wide_sorted past 2**31 elements: rows {r0}..{r1}")
        check(torch.equal(dmsg[lo:hi], K.segment_max_wide_bwd_plain(
            msgs[lo:hi], maxv[r0:r1], g[r0:r1], local, r1 - r0)),
            f"segment_max_wide_bwd past 2**31 elements: slots {lo}..{hi}")
    errs["segment_max_wide_bwd"] = 0.0
    offsets = {k: (sample[-1][3] - 1) * BIG_F for k in errs}
    del msgs, out, maxv, g, dmsg, rows, w
    torch.cuda.empty_cache()

    # K10c's v, [E, H * F] = [2**23 + 4,096, 256].
    heads, f = GAT_ARXIV_HEADS, GAT_ARXIV_DIMS[0]
    d = heads * f
    recv, row_ptr, sample = big_graph(device, gen, BIG_ATTEND_SLOTS,
                                      BIG_ATTEND_NODES)
    send = torch.randint(0, BIG_ATTEND_NODES, (BIG_ATTEND_SLOTS,),
                         generator=gen, device=device, dtype=torch.int32)
    ht, att, gout, _ = attend_inputs(gen, BIG_ATTEND_NODES, heads, f,
                                     torch.bfloat16, BIG_ATTEND_SLOTS, False,
                                     device)
    g3 = (send, recv, row_ptr)
    _, scores, m, l = A.sddmm_stats_agg_sorted(ht, *g3, att)
    rho = A.attend_rho_sorted(gout, scores, m, l, ht, *g3)
    _, _, v = A.attend_recv_bwd_full_sorted(ht, gout, *g3, att, scores, m, l,
                                            rho)
    check(v.numel() > 2**31, "v must pass 2**31 elements")
    errs["attend_recv_bwd_full_sorted"] = 0.0
    for _, _, lo, hi in sample:
        graph = (send[lo:hi], recv[lo:hi], None, None)
        p_v = A.attend_recv_bwd_full_sorted_plain(
            ht, gout, *graph[:3], att, scores[lo:hi], m, l, rho)[2]
        mass = attend_masses(graph, ht, att, gout, None, scores[lo:hi], m, l)
        errs["attend_recv_bwd_full_sorted"] = max(
            errs["attend_recv_bwd_full_sorted"], compare(
                v[lo:hi], p_v, mass["v"], torch.bfloat16,
                f"attend_recv_bwd_full_sorted's v past 2**31 elements, "
                f"slots {lo}..{hi}"))
    offsets["attend_recv_bwd_full_sorted"] = (sample[-1][3] - 1) * d
    del ht, gout, scores, m, l, rho, v
    torch.cuda.empty_cache()
    return {"max_abs_err": errs, "largest_element_offset": offsets,
            "slots": {"spmm": BIG_SLOTS, "attend": BIG_ATTEND_SLOTS}}


def sparse_library_ms(timer, rows_idx, cols_idx, values, shape, dense):
    """Milliseconds of ``torch.sparse.mm(A_csr, dense)``, the one library call
    that computes the same function; None (with the reason) when PyTorch has
    no such product for the dtype. A yardstick only."""
    try:
        a = torch.sparse_coo_tensor(
            torch.stack([rows_idx.long(), cols_idx.long()]), values.float(),
            shape).coalesce().to_sparse_csr()
        a = torch.sparse_csr_tensor(
            a.crow_indices(), a.col_indices(), a.values().to(dense.dtype),
            shape)
        torch.sparse.mm(a, dense)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as exc:
        return None, f"{type(exc).__name__}: {str(exc).splitlines()[0][:120]}"
    return timer.cold_ms(lambda: torch.sparse.mm(a, dense), iters=10), None


def slot_order_walk(msgs, weights, mask, row_ptr):
    """The messages-form scatter of every row of at most one piece's slots
    as a serial walk by torch ops: f32 products rounded, added in slot order
    from 0, rounded once to the messages' type; and those rows' mask."""
    from keras_geometric_tpu_torch.kernels import spmm_cuda as K

    terms = msgs.float()
    if weights is not None:
        terms = terms * weights.float()[:, None]
    if mask is not None:
        terms = torch.where(mask[:, None], terms, torch.zeros_like(terms))
    lengths = row_ptr[1:] - row_ptr[:-1]
    one = lengths <= K.RECV_BWD_PIECE
    acc = torch.zeros(lengths.shape[0], msgs.shape[1], dtype=torch.float32,
                      device=msgs.device)
    for j in range(K.RECV_BWD_PIECE):
        rows = one & (lengths > j)
        acc[rows] = acc[rows] + terms[(row_ptr[:-1][rows] + j).long()]
    return acc.to(msgs.dtype), one


def scatter_f64(msgs, receivers, num_nodes, weights, mask):
    """The messages-form scatter summed in f64 (not rounded)."""
    terms = msgs.double()
    if weights is not None:
        terms = terms * weights.double()[:, None]
    if mask is not None:
        terms = torch.where(mask[:, None], terms, torch.zeros_like(terms))
    return torch.zeros(num_nodes, msgs.shape[1], dtype=torch.float64,
                       device=msgs.device).index_add_(0, receivers.long(),
                                                      terms)


def time_kernel_cases(device, timer, contexts, replaces):
    """Kernel, plain version and library call at the layer-1 and layer-2
    shapes, each with its bound from bytes and operations. ``path`` names the
    training run that gives the kernel that shape, None where none does (the
    arxiv-shaped GCN runs never form messages, so they launch neither the
    messages form nor expand; the composed GATv2 runs launch both, without
    weights: the ``[E, H*F]`` messages and their gradient, and the softmax
    backward's ``[E, H]`` f32 row sums and their expansion; the Cora-shaped
    GraphSAGE (mean) both with the slot mask). The messages form and expand
    also give their work list (the messages form's pieces; expand walks
    none), their times on ``skewed_graph`` with its 20,000-slot hub row and
    without it (``hub_row_ms``) and on the same graph without padded slots
    (``ms_unpadded``), the same bits over two calls, expand its plain
    version's bits, and the messages form the bits of a serial slot-order
    walk on every row of at most one piece at the Cora and CiteSeer shapes
    and an f64 sum's value everywhere."""
    from keras_geometric_tpu_torch.kernels import spmm_cuda as K
    from keras_geometric_tpu_torch.utils.profiling import (
        H100_BYTES_PER_S,
        H100_F32_OPS_PER_S,
    )

    gen = torch.Generator(device=device).manual_seed(2)
    entries = []
    on_arxiv = {"gather_scatter_sum_sorted": "train_arxiv_shape",
                "scatter_sum_sorted": None, "expand_sorted": None}
    composed = {"scatter_sum_sorted": "train_gat_arxiv_shape_composed",
                "expand_sorted": "train_gat_arxiv_shape_composed"}
    composed_cs = {"scatter_sum_sorted": "train_gat_citeseer_shape_composed",
                   "expand_sorted": "train_gat_citeseer_shape_composed"}
    gat_width = [GAT_ARXIV_HEADS * d for d in GAT_ARXIV_DIMS]
    cs_width = [GAT_CITESEER_HEADS * d for d in GAT_CITESEER_DIMS]
    hub_graphs = {"with_hub_row": skewed_graph(device),
                  "without_hub_row": skewed_graph(device, hub=0)}
    unpadded = {}
    for (ctx_name, layer, f, dtype, kernels, weighted,
         masked) in (
        ("arxiv", "layer 1", ARXIV_FEATS, torch.bfloat16, on_arxiv, True,
         False),
        ("arxiv", "layer 2", ARXIV_CLASSES, torch.bfloat16, on_arxiv, True,
         False),
        ("cora", "layer 2", 7, torch.float32,
         {"gather_scatter_sum_sorted": "train_cora_shape"}, True, False),
        ("cora", "layer 1", 16, torch.float32,
         {"scatter_sum_sorted": "train_cora_shape",
          "expand_sorted": "train_cora_shape"}, True, False),
        ("gat_arxiv", "layer 1 messages", gat_width[0], torch.bfloat16,
         composed, False, False),
        ("gat_arxiv", "layer 2 messages", gat_width[1], torch.bfloat16,
         composed, False, False),
        ("gat_arxiv", "softmax row sums", GAT_ARXIV_HEADS, torch.float32,
         composed, False, False),
        ("citeseer", "layer 1 messages", cs_width[0], torch.float32,
         composed_cs, False, False),
        ("citeseer", "layer 2 messages", cs_width[1], torch.float32,
         composed_cs, False, False),
        ("citeseer", "softmax row sums", GAT_CITESEER_HEADS, torch.float32,
         composed_cs, False, False),
        ("sage_cora", "layer 1 messages", 1_433, torch.float32,
         {"scatter_sum_sorted": "train_sage_cora_shape"}, False, True),
        ("sage_cora", "layer 2 messages", 16, torch.float32,
         {"scatter_sum_sorted": "train_sage_cora_shape",
          "expand_sorted": "train_sage_cora_shape"}, False, True),
    ):
        ctx = contexts[ctx_name]
        n, e = ctx.num_nodes, ctx.receivers.shape[0]
        es = 2 if dtype == torch.bfloat16 else 4
        h = torch.randn(n, f, generator=gen, device=device).to(dtype)
        msgs = torch.randn(e, f, generator=gen, device=device).to(dtype)
        w, sw = (ctx.edge_weight if weighted else None), ctx.self_weight
        mask = ctx.edge_mask if masked else None
        ws = 0 if w is None else w.element_size()
        ms_ = 0 if mask is None else 1
        w_abs = None if w is None else w.float().abs()
        w_lib = torch.ones(e, device=device) if w is None else w
        if mask is not None:
            w_lib = w_lib * mask
        edge_ids = torch.arange(e, device=device)
        for name, path in kernels.items():
            piece_walk = None
            extra = {}
            if name == "gather_scatter_sum_sorted":
                # The GCN's operator runs the row walk (ops/csr.py); the
                # piece walk is held and timed beside it.
                kernel = lambda: K.gather_scatter_sum_sorted(
                    h, ctx.senders, ctx.receivers, ctx.row_ptr, n, weights=w,
                    self_weight=sw, pieces=False)
                piece_walk = lambda: K.gather_scatter_sum_sorted(
                    h, ctx.senders, ctx.receivers, ctx.row_ptr, n, weights=w,
                    self_weight=sw)
                plain = lambda: K.gather_scatter_sum_sorted_plain(
                    h, ctx.senders, ctx.receivers, n, weights=w,
                    self_weight=sw)
                mass = K.gather_scatter_sum_sorted_plain(
                    h.float().abs(), ctx.senders, ctx.receivers, n,
                    weights=w.float(),
                    self_weight=None if sw is None else sw.float())
                r_idx, c_idx, vals = ctx.receivers, ctx.senders, w
                if sw is not None:
                    diag = torch.arange(n, device=device, dtype=torch.int32)
                    r_idx = torch.cat([r_idx, diag])
                    c_idx = torch.cat([c_idx, diag])
                    vals = torch.cat([w, sw])
                lib = (r_idx, c_idx, vals, (n, n), h)
                sw_bytes = 0 if sw is None else n * sw.element_size()
                nbytes = (2 * n * f * es + e * (4 + ws) + (n + 1) * 4
                          + sw_bytes)
                no_reuse = nbytes - n * f * es + e * f * es
                ops = 2 * e * f + (0 if sw is None else 2 * n * f)
            elif name == "scatter_sum_sorted":
                kernel = lambda: K.scatter_sum_sorted(
                    msgs, ctx.receivers, n, row_ptr=ctx.row_ptr, weights=w,
                    mask=mask)
                plain = lambda: K.scatter_sum_sorted_plain(
                    msgs, ctx.receivers, n, weights=w, mask=mask)
                mass = K.scatter_sum_sorted_plain(
                    msgs.float().abs(), ctx.receivers, n, weights=w_abs,
                    mask=mask)
                lib = (ctx.receivers, edge_ids, w_lib, (n, e), msgs)
                nbytes = (e * f * es + n * f * es + e * (ws + ms_)
                          + (n + 1) * 4)
                no_reuse = None
                ops = 2 * e * f
                extra = piece_fields(ctx.row_ptr, K.SPLIT_PIECE)
                extra["cuda_kernels"] = ["scatter_messages_kernel"]
            else:
                kernel = lambda: K.expand_sorted(
                    h, ctx.receivers, row_ptr=ctx.row_ptr, weights=w) \
                    if mask is None else K._expand_raw(h, ctx.receivers, w,
                                                       mask)
                plain = lambda: K.expand_sorted_plain(
                    h, ctx.receivers, weights=w, mask=mask)
                mass = None
                lib = (edge_ids, ctx.receivers, w_lib, (e, n), h)
                nbytes = n * f * es + e * f * es + e * (4 + ws + ms_)
                no_reuse = None
                ops = e * f
                extra = {"longest_row": longest_row(ctx.row_ptr),
                         "pieces": None, "split_rows": None,
                         "work_list": "none: threads on the flat (slot, "
                                      "pack) index of the output",
                         "cuda_kernels": ["expand_sorted_kernel"]}
            k_out, p_out = kernel(), plain()
            if mass is None:
                mass = p_out.float().abs()
            err = compare(k_out, p_out, mass, dtype,
                          f"{name} at {ctx_name} {layer}")
            walk_fields = {}
            if piece_walk is not None:
                pieces_out = piece_walk()
                walk_fields = {"mode": "rows",
                               "cuda_kernels": ["scatter_sum_sorted_kernel"]}
                walk_fields["piece_walk"] = piece_walk_fields(name,
                                                              ctx.row_ptr)
                walk_fields["piece_walk"].update(
                    max_abs_err=compare(pieces_out, p_out, mass, dtype,
                                        f"{name} (pieces) at {ctx_name} "
                                        f"{layer}"),
                    one_piece_rows_equal_to_row_walk=(
                        check_one_piece_rows_equal(
                            pieces_out, k_out, ctx.row_ptr,
                            f"{name} at {ctx_name} {layer}")),
                    ms=timer.cold_ms(piece_walk))
                del pieces_out
            else:
                what = f"{name} at {ctx_name} {layer}"
                check(torch.equal(k_out, kernel()),
                      f"{what}: two calls give different bits")
                extra["same_bits_over_two_calls"] = True
                if name == "expand_sorted":
                    check(torch.equal(k_out, p_out),
                          f"{what}: not its plain version's bits")
                else:
                    extra["max_abs_err_against_f64"] = compare(
                        k_out, scatter_f64(msgs, ctx.receivers, n, w,
                                           mask).to(dtype),
                        mass, dtype, f"{what} (against an f64 sum)")
                    if ctx_name in ("cora", "citeseer", "sage_cora"):
                        walk, one = slot_order_walk(msgs, w, mask,
                                                    ctx.row_ptr)
                        check(torch.equal(k_out[one], walk[one]),
                              f"{what}: a row of one piece differs from "
                              f"the serial slot-order walk")
                        extra["one_piece_rows_equal_to_slot_order_walk"] = (
                            int(one.sum()))
                extra.update(time_messages_elsewhere(
                    name, f, dtype, weighted, masked, hub_graphs,
                    unpadded.setdefault(ctx_name, unpadded_context(ctx)),
                    timer, gen))
            del k_out, p_out, mass
            ms = timer.cold_ms(kernel)
            plain_ms = timer.cold_ms(plain, iters=10)
            library_ms, library_note = sparse_library_ms(timer, *lib)
            # The card's published peaks: memory rate, and f32 outside the
            # tensor cores (the kernels multiply-add in f32).
            t_bytes = nbytes / H100_BYTES_PER_S * 1e3
            t_ops = ops / H100_F32_OPS_PER_S * 1e3
            entry = {
                "name": name, "route": "cuda",
                "source": SOURCES[REPLACES[name][0]],
                "replaces": replaces[name], "path": path,
                "shape": f"{ctx_name} {layer}: E={e} N={n} F={f} "
                         f"{str(dtype)[6:]} weights "
                         f"{'none' if w is None else str(w.dtype)[6:]}"
                         f"{' masked' if mask is not None else ''}",
                "launches": 0, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": library_ms,
                "library": "torch.sparse.mm on a CSR tensor",
            }
            if library_note:
                entry["library_note"] = library_note
            if no_reuse is not None:
                entry["bound_ms_if_gather_not_reused"] = (
                    no_reuse / H100_BYTES_PER_S * 1e3)
            if extra:
                extra.update(parent_ms=None, parent=(
                    "not measured here: attend_kernels_ab.py "
                    "--only=messages times a parent copy beside this one"))
            entry.update(walk_fields)
            entry.update(extra)
            entries.append(entry)
        del h, msgs
    return entries


def time_messages_elsewhere(name, f, dtype, weighted, masked, hub_graphs,
                            unpadded, timer, gen):
    """The messages form's or expand's milliseconds at one width on
    ``skewed_graph`` with and without its hub row (``hub_row_ms``), and on
    the entry's graph prepared again without padded slots
    (``ms_unpadded``, with that stream's longest row)."""
    from keras_geometric_tpu_torch.kernels import spmm_cuda as K

    device = unpadded.receivers.device

    def call(recv, row_ptr, n, e, w, mask):
        if name == "scatter_sum_sorted":
            msgs = torch.randn(e, f, generator=gen, device=device).to(dtype)
            return lambda: K.scatter_sum_sorted(
                msgs, recv, n, row_ptr=row_ptr, weights=w, mask=mask)
        rows = torch.randn(n, f, generator=gen, device=device).to(dtype)
        return lambda: K._expand_raw(rows, recv, w, mask)

    hub_ms = {}
    for label, g in hub_graphs.items():
        fn = call(g["recv"], g["row_ptr"], g["n"], g["e"],
                  g["w"] if weighted else None, g["mask"] if masked else None)
        hub_ms[label] = timer.cold_ms(fn, iters=10)
        del fn
    e = unpadded.receivers.shape[0]
    fn = call(unpadded.receivers, unpadded.row_ptr, unpadded.num_nodes, e,
              torch.ones(e, device=device) if weighted else None,
              torch.ones(e, dtype=torch.bool, device=device) if masked
              else None)
    out = {"hub_row_ms": hub_ms, "ms_unpadded": timer.cold_ms(fn),
           "longest_row_unpadded": longest_row(unpadded.row_ptr)}
    del fn
    return out


# ---------------------------------------------------------------------------
# The attention kernels against their plain versions
# ---------------------------------------------------------------------------


def attend_restated(ctx, ht, att, drop_mask=None, negative_slope=0.2,
                    eps=1e-10, ht_send=None, block=None, dtype=None):
    """``GraphContext.attend`` written with differentiable library ops over
    the same edge order, validity mask and dropout mask, f32 inside: autograd
    over this is the oracle for the hand-written backward. ``ht_send``:
    the sender rows of every slot (``ht[senders]``) as a tensor of their
    own, whose gradient is then each slot's sender part apart from the
    receiver part in ``ht``'s. ``block``: ``(r0, r1, lo, hi)`` of
    ``row_blocks``, the rows ``[r0, r1)`` alone from their slots ``[lo,
    hi)`` (each row's terms and order those of the whole graph's); the
    result in ``dtype`` (default ``ht``'s). For comparison only."""
    r0, r1, lo, hi = block or (0, ht.shape[0], 0, ctx.senders.shape[0])
    heads, f = att.shape
    s, r = ctx.senders[lo:hi].long(), ctx.receivers[lo:hi].long() - r0
    e = s.shape[0]
    rows = ht.float()
    hj = (rows.index_select(0, s) if ht_send is None
          else ht_send[lo:hi].float()).view(e, heads, f)
    hi_ = rows[r0:r1].index_select(0, r).view(e, heads, f)
    z = torch.nn.functional.leaky_relu(hi_ + hj, negative_slope)
    alpha = edge_softmax_restated(ctx, (z * att.float()).sum(-1), eps, block)
    if drop_mask is not None:
        alpha = alpha * drop_mask[lo:hi].float()
    out = torch.zeros(r1 - r0, heads * f, device=ht.device).index_add(
        0, r, (alpha[:, :, None] * hj).reshape(e, heads * f))
    return out.to(dtype or ht.dtype)


def edge_softmax_restated(ctx, scores, eps=1e-10, block=None):
    """``GraphContext.edge_softmax`` in differentiable library ops (padded
    slots -inf, max shift held constant, f32 inside), over the rows and
    slots of ``block`` (``attend_restated``'s) when given. For comparison
    only."""
    e, k = scores.shape
    r0, r1, lo, hi = block or (0, ctx.num_nodes, 0, e)
    n = r1 - r0
    r = ctx.receivers[lo:hi].long() - r0
    s = scores.float().masked_fill(~ctx.edge_mask[lo:hi, None], float("-inf"))
    m = torch.full((n, k), float("-inf"), device=s.device).scatter_reduce(
        0, r[:, None].expand(e, k), s.detach(), "amax")
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    ex = torch.exp(s - m.index_select(0, r))
    den = torch.zeros(n, k, device=s.device).index_add(0, r, ex)
    return (ex / (den.index_select(0, r) + eps)).to(scores.dtype)


def attend_masses(graph, ht, att, gout, drop, p_scores, p_m, p_l):
    """Sums of the absolute values of each output element's terms, for the
    tolerance of the module docstring, from the plain forward's scores and
    statistics: ``s`` (a slot's score), ``row_s`` (the row's largest),
    ``amp`` (``1 +`` that: what an error in a score does behind the exp),
    ``out`` (times ``amp``), ``out_terms`` (without), ``rho``, ``dht``
    (receiver part), ``v`` (per slot) and ``datt``; with ``alpha``,
    ``alpha_keep`` and ``keep``."""
    send, recv, _, valid = graph
    n, d = ht.shape
    heads, f = att.shape
    e = send.shape[0]
    r = recv.long()
    dev = ht.device

    def per_row(edge_values):  # [E, H] -> [N, H] sum
        return torch.zeros(n, heads, device=dev).index_add_(0, r, edge_values)

    def widen(per_head):  # [.., H] -> [.., H*F]
        return per_head.repeat_interleave(f, -1)

    hj = ht.float().index_select(0, send.long()).view(e, heads, f).abs()
    hi = ht.float().index_select(0, r).view(e, heads, f).abs()
    g_e = gout.float().index_select(0, r).view(e, heads, f).abs()
    z_abs = hi + hj
    del hi
    s_mass = (z_abs * att.float().abs()).sum(-1)
    if valid is not None:
        s_mass = s_mass * valid[:, None]
    row_s_mass = torch.zeros(n, heads, device=dev).scatter_reduce(
        0, r[:, None].expand(e, heads), s_mass, "amax")
    amp = 1.0 + row_s_mass
    keep = 1.0 if drop is None else drop.float()
    alpha = torch.exp(p_scores - p_m.index_select(0, r)) / (
        p_l.index_select(0, r) + 1e-10)
    alpha_keep = alpha * keep
    out_terms = torch.zeros(n, d, device=dev).index_add_(
        0, r, (alpha_keep[:, :, None] * hj).reshape(e, d))
    dalpha_abs = (g_e * hj).sum(-1)
    rho_abs = per_row(alpha_keep * dalpha_abs)
    amp_e = amp.index_select(0, r)
    ds_mass = alpha * (keep * dalpha_abs + rho_abs.index_select(0, r)) * amp_e
    d_pre_mass = ds_mass[:, :, None] * att.float().abs()
    dht_mass = torch.zeros(n, d, device=dev).index_add_(
        0, r, d_pre_mass.reshape(e, d))
    v_mass = ((alpha_keep * amp_e)[:, :, None] * g_e
              + d_pre_mass).reshape(e, d)
    datt_mass = (z_abs * ds_mass[:, :, None]).sum(0)
    return dict(s=s_mass, row_s=row_s_mass, amp=amp, keep=keep, alpha=alpha,
                alpha_keep=alpha_keep, out=out_terms * widen(amp),
                out_terms=out_terms, rho=rho_abs * amp, rho_abs=rho_abs,
                dht=dht_mass, v=v_mass, datt=datt_mass)


def attend_case(graph, ht, att, gout, drop, what, *, blocks=None,
                emit_v=True, send=None):
    """The attention kernels against their plain versions on one input,
    each element held to the tolerance of the module docstring. The backward
    kernels are fed the plain forward's scores and statistics, so each kernel
    is held alone. ``blocks`` (``row_blocks`` of the stream): the plain
    versions and the masses run block by block, so that no ``[E, H*F]``
    array exists whole (ogbn-products); ``emit_v``: whether the receiver
    backward writes ``v``; ``send``: ``(sender-order graph, valid_ss, its
    blocks or None)``, and the sender backward is held too (no dropout
    mask). Returns each kernel's largest absolute error, and each plain
    version as it ran (a call without arguments), to be timed."""
    from keras_geometric_tpu_torch.kernels import attend_cuda as A

    senders, recv, row_ptr, valid = graph
    n, d = ht.shape
    blocks = blocks or [(0, n, 0, senders.shape[0])]

    def cut(block, *tensors):  # each tensor's slots of the block
        return [None if t is None else t[block[2]:block[3]] for t in tensors]

    def fwd_plain(block):
        s_, r_, valid_, drop_ = cut(block, senders, recv, valid, drop)
        return A.sddmm_stats_agg_sorted_plain(
            ht, s_, r_, None, att, edge_valid=valid_, drop_mask=drop_)

    plain = {"sddmm_stats_agg_sorted": lambda: blocked_plain(
        blocks, fwd_plain, ("rows", "slots", "rows", "rows"))}
    out, scores, m, l = A.sddmm_stats_agg_sorted(
        ht, senders, recv, row_ptr, att, edge_valid=valid, drop_mask=drop)
    p_out, p_scores, p_m, p_l = plain["sddmm_stats_agg_sorted"]()

    # The masses, block by block: per row where a row's slots all lie in
    # its block; datt's and the sender backward's added over the blocks.
    names = ["out", "row_s", "l", "rho", "dht", "s", "datt"]
    kinds = ["rows"] * 5 + ["slots", "sum"]
    if emit_v:
        names, kinds = names + ["v"], kinds + ["slots"]
    if send is not None:
        check(drop is None, f"{what}: the sender backward takes no mask here")
        names, kinds = names + ["send"], kinds + ["sum"]

    def block_masses(block):
        s_, r_, valid_, drop_, scores_ = cut(block, senders, recv, valid,
                                             drop, p_scores)
        mb = attend_masses((s_, r_, None, valid_), ht, att, gout, drop_,
                           scores_, p_m, p_l)
        mb["l"] = p_l * mb["amp"]
        if send is not None:
            mb["send"] = torch.zeros(n, d, device=ht.device).index_add_(
                0, s_.long(), mb["v"])
        return tuple(mb[name] for name in names)

    mass = dict(zip(names, blocked_plain(blocks, block_masses, tuple(kinds))))

    finite = torch.isfinite(p_scores)
    check(bool((torch.isfinite(scores) == finite).all()),
          f"{what}: -inf scores not exactly on the invalid slots")
    if valid is not None:
        check(bool((finite == valid[:, None]).all()),
              f"{what}: plain scores not -inf exactly on the invalid slots")
    zero = torch.zeros_like(scores)
    errs = {}
    errs["sddmm_stats_agg_sorted"] = max(
        compare(out, p_out, mass["out"], out.dtype, f"{what} out"),
        compare(torch.where(finite, scores, zero),
                torch.where(finite, p_scores, zero), mass["s"], scores.dtype,
                f"{what} scores"),
        compare(m, p_m, mass["row_s"], m.dtype, f"{what} m"),
        compare(l, p_l, mass["l"], l.dtype, f"{what} l"))
    del out, p_out, scores, m, l, zero, finite

    graph3 = (senders, recv, row_ptr)

    def rho_plain(block):
        s_, r_, scores_, drop_ = cut(block, senders, recv, p_scores, drop)
        return A.attend_rho_sorted_plain(gout, scores_, p_m, p_l, ht, s_, r_,
                                         None, drop_mask=drop_)

    plain["attend_rho_sorted"] = lambda: blocked_plain(blocks, rho_plain,
                                                       "rows")
    p_rho = plain["attend_rho_sorted"]()
    rho = A.attend_rho_sorted(gout, p_scores, p_m, p_l, ht, *graph3,
                              drop_mask=drop)
    errs["attend_rho_sorted"] = compare(rho, p_rho, mass["rho"], rho.dtype,
                                        f"{what} rho")
    del rho

    def recv_plain(block):  # datt's parts in f32 (att in f32), rounded once
        s_, r_, scores_, valid_, drop_ = cut(block, senders, recv, p_scores,
                                             valid, drop)
        return A.attend_recv_bwd_full_sorted_plain(
            ht, gout, s_, r_, None, att.float(), scores_, p_m, p_l, p_rho,
            drop_mask=drop_, emit_v=emit_v, edge_valid=valid_)

    def recv_whole():
        dht, datt, *v = blocked_plain(
            blocks, recv_plain, ("rows", "sum") + ("slots",) * emit_v)
        return (dht, datt.to(att.dtype), *v)

    plain["attend_recv_bwd_full_sorted"] = recv_whole
    got = A.attend_recv_bwd_full_sorted(
        ht, gout, *graph3, att, p_scores, p_m, p_l, p_rho, drop_mask=drop,
        emit_v=emit_v, edge_valid=valid)
    errs["attend_recv_bwd_full_sorted"] = max(
        compare(k, p, mass[part], k.dtype, f"{what} {part}")
        for k, p, part in zip(got, recv_whole(), ("dht", "datt", "v")))
    if emit_v and valid is not None:
        check(not got[2][~valid].any().item(),
              f"{what}: v must be zero on invalid slots")
    del got

    if send is not None:
        ss, valid_ss, send_blocks = send
        send_blocks = send_blocks or [(0, n, 0, ss[0].shape[0])]

        def send_plain(block):
            r_, s_, valid_ = cut(block, ss[0], ss[1], valid_ss)
            return A.attend_send_bwd_sorted_plain(
                ht, gout, r_, s_, None, att, p_m, p_l, p_rho, valid_ss=valid_)

        plain["attend_send_bwd_sorted"] = lambda: blocked_plain(
            send_blocks, send_plain, "rows")
        errs["attend_send_bwd_sorted"] = compare(
            A.attend_send_bwd_sorted(ht, gout, *ss, att, p_m, p_l, p_rho,
                                     valid_ss=valid_ss),
            plain["attend_send_bwd_sorted"](), mass["send"], ht.dtype,
            f"{what} sender backward")
    return errs, plain


def attend_counts(n, e, heads, f, es, dropped=False):
    """``(bytes, operations, bytes added if no gathered row is reused)`` of
    each attention kernel call at these shapes, keyed as ``modes_case``'s
    errors are (``name`` or ``name(mode)``). Bytes: each node array read
    or written once, the index and validity streams, the keep mask, the
    ``[E, H]`` f32 score cache where it is read or written, ``(m, l,
    rho)`` and ``att``; not reused: every gathered sender row (for the
    sender backward: ``ht[r]``, ``g[r]`` and ``(m, l, rho)[r]`` for every
    slot)."""
    d = heads * f
    stats = 2 * n * heads * 4  # m and l
    drop_bytes = e * heads * es if dropped else 0
    index = e * 4 + (n + 1) * 4
    nodes = n * d * es  # one node array, read or written once
    gathered = e * d * es  # every gathered row from device memory
    scores = e * heads * 4
    fwd = 2 * nodes + index + e + stats + d * es + drop_bytes
    rho = 2 * nodes + index + stats + n * heads * 4 + drop_bytes
    bwd = (3 * nodes + index + e + stats + n * heads * 4 + d * (es + 4)
           + drop_bytes)
    return {
        "sddmm_stats_agg_sorted": (fwd + scores, 8 * e * d, gathered),
        "sddmm_stats_agg_sorted(emit_scores=False)": (fwd, 8 * e * d,
                                                      gathered),
        "attend_rho_sorted": (rho + scores, 2 * e * d, gathered),
        "attend_rho_sorted(scores=None)": (rho + e + d * es, 6 * e * d,
                                           gathered),
        "attend_recv_bwd_full_sorted": (bwd - e + scores + gathered,
                                        12 * e * d, gathered),
        "attend_recv_bwd_full_sorted(scores=None)": (bwd + gathered,
                                                     16 * e * d, gathered),
        "attend_recv_bwd_full_sorted(emit_v=False)": (bwd - e + scores,
                                                      10 * e * d, gathered),
        "attend_recv_bwd_full_sorted(scores=None, emit_v=False)": (
            bwd, 14 * e * d, gathered),
        "attend_send_bwd_sorted": (
            3 * nodes + index + e * 4 + 3 * n * heads * 4 + d * es
            + drop_bytes, 12 * e * d,
            2 * gathered - nodes + e * 3 * heads * 4 - 3 * n * heads * 4),
        "sddmm_stats_sorted": (nodes + index + e + scores + stats + d * es,
                               4 * e * d, gathered),
        "attend_aggregate_sorted": (2 * nodes + index + scores + stats
                                    + drop_bytes, 2 * e * d, gathered),
    }


def attend_inputs(gen, n, heads, f, dtype, num_slots, dropped, device):
    d = heads * f
    ht = (0.5 * torch.randn(n, d, generator=gen, device=device)).to(dtype)
    att = (0.3 * torch.randn(heads, f, generator=gen, device=device)).to(dtype)
    gout = torch.randn(n, d, generator=gen, device=device).to(dtype)
    drop = None
    if dropped:
        u = torch.rand(num_slots, heads, generator=gen, device=device)
        drop = torch.where(u < 0.7, 1.0 / 0.7, 0.0).to(dtype)
    return ht, att, gout, drop


def attend_sweep(device, timer):
    """The attention kernels, every listed (H, F), both types, with and
    without a dropout mask, on the skewed graph; then what its 20,000-edge
    hub row costs (the same graph timed with and without that row), the
    score-and-statistics kernel's too."""
    from keras_geometric_tpu_torch.kernels import attend_cuda as A
    from keras_geometric_tpu_torch.kernels import sddmm_cuda as D

    g = skewed_graph(device)
    n, e = g["n"], g["e"]
    graph = (g["idx"], g["recv"], g["row_ptr"], g["mask"])
    gen = torch.Generator(device=device).manual_seed(5)
    worst = {name: 0.0 for name in A.LAUNCH_COUNTS}
    cases = 0
    for dtype in (torch.bfloat16, torch.float32):
        for heads, f in ATTEND_SHAPES:
            for dropped in (False, True):
                ht, att, gout, drop = attend_inputs(
                    gen, n, heads, f, dtype, e, dropped, device)
                errs, _ = attend_case(
                    graph, ht, att, gout, drop,
                    f"attend {str(dtype)[6:]} H={heads} F={f}"
                    f"{' dropout' if dropped else ''}")
                for name, err in errs.items():
                    worst[name] = max(worst[name], err)
                cases += len(errs)
    torch.cuda.synchronize()
    # Empty rows (every odd row but the last, which holds the padded slots).
    out, _, m, l = A.sddmm_stats_agg_sorted(
        ht, g["idx"], g["recv"], g["row_ptr"], att, edge_valid=g["mask"])
    for name, t in (("out", out), ("m", m), ("l", l)):
        check(not t[1::2][:-1].any().item(), f"empty rows: {name} must be 0")
    try:
        A.sddmm_stats_agg_sorted(ht.double(), g["idx"], g["recv"],
                                 g["row_ptr"], att.double())
    except TypeError:
        pass
    else:
        check(False, "float64 data must be refused on a CUDA tensor")

    hub = {}
    heads, f = GAT_ARXIV_HEADS, GAT_ARXIV_DIMS[0]
    for label, sg in (("with_hub_row", g),
                      ("without_hub_row", skewed_graph(device, hub=0))):
        ht, att, gout, _ = attend_inputs(
            gen, n, heads, f, torch.bfloat16, sg["e"], False, device)
        args = (sg["idx"], sg["recv"], sg["row_ptr"])
        _, scores, m, l = A.sddmm_stats_agg_sorted(
            ht, *args, att, edge_valid=sg["mask"])
        rho = A.attend_rho_sorted(gout, scores, m, l, ht, *args)
        hub[label] = {
            "slots": sg["e"],
            "sddmm_stats_agg_sorted": timer.cold_ms(
                lambda: A.sddmm_stats_agg_sorted(
                    ht, *args, att, edge_valid=sg["mask"]), iters=10),
            "attend_rho_sorted": timer.cold_ms(
                lambda: A.attend_rho_sorted(gout, scores, m, l, ht, *args),
                iters=10),
            "attend_recv_bwd_full_sorted": timer.cold_ms(
                lambda: A.attend_recv_bwd_full_sorted(
                    ht, gout, *args, att, scores, m, l, rho), iters=10),
            "sddmm_stats_sorted": timer.cold_ms(
                lambda: D.sddmm_stats_sorted(ht, *args, att,
                                             edge_valid=sg["mask"]),
                iters=10),
            "attend_aggregate_sorted": timer.cold_ms(
                lambda: A.attend_aggregate_sorted(scores, m, l, ht, *args),
                iters=10),
        }
    return cases, worst, hub


def unpadded_context(ctx):
    """The real slots of an attention context (self-loops included) prepared
    again with ``edge_chunk=1``: the same graph, its stream without a padded
    slot."""
    import keras_geometric_tpu_torch as kgt

    real = ctx.edge_mask
    edges = torch.stack([ctx.senders[real], ctx.receivers[real]])
    return kgt.prepare_graph(edges.cpu().numpy(), ctx.num_nodes,
                             edge_chunk=1, device=ctx.senders.device)


def longest_row(row_ptr) -> int:
    return int((row_ptr[1:] - row_ptr[:-1]).max())


# The kernels that walk the work list of pieces of the receiver-sorted
# stream (spmm_cuda.recv_bwd_work of row_ptr).
PIECE_WALKS = ("sddmm_stats_agg_sorted", "attend_rho_sorted",
               "attend_recv_bwd_full_sorted")


def piece_fields(row_ptr, split_piece=None) -> dict:
    """The work list a piece walk takes over a stream: its longest row, its
    pieces and its rows split into several pieces (``split_piece``: the
    list's, as ``spmm_cuda.recv_bwd_work`` takes it)."""
    from keras_geometric_tpu_torch.kernels import spmm_cuda as K

    work = K.recv_bwd_work(row_ptr, split_piece=split_piece)
    return {"longest_row": longest_row(row_ptr), "pieces": work.num_pieces,
            "split_rows": int(work.fix_rows.shape[0])}


def piece_walk_fields(name, row_ptr) -> dict:
    """``piece_fields`` and the CUDA kernels a call of ``name`` launches
    over that list: its piece walk, and its merge where rows are split."""
    fields = piece_fields(row_ptr)
    walk, merge = PIECE_KERNELS[name]
    fields["cuda_kernels"] = [walk] + ([merge] if fields["split_rows"] else [])
    return fields


def time_attend_cases(device, timer, contexts, replaces, hub, send_hub):
    """The attention kernels and the sender finish (the fused-gather scatter
    reading ``v`` through ``bwd_perm``) at the shapes the GATv2 training runs
    give them: kernel, plain version, bound from bytes and operations. No
    single PyTorch call computes any of the three attention kernels, so their
    ``library_ms`` is null; the sender finish is one ``index_add_``. Each
    entry also gives the stream's longest row (``longest_row``: in sender
    order for the finish) and the kernel's time on the same graph prepared
    without padded slots (``ms_unpadded``): where a padded tail, which
    ``prepare_graph`` puts in the last row, is walked serially, the two
    times differ. Every entry adds the pieces and split rows of the work
    list it walks (the finish: over the sender-sorted stream) and the CUDA
    kernels a call launches; the attention kernels' entries their times on
    ``attend_sweep``'s graph with and without its 20,000-slot hub row
    (``hub_row_ms``), the finish's its times on ``send_skewed_graph`` with
    and without its 20,000-slot hub sender, its time as a row walk
    (``ms_row_walk``) and the rows on which the two walks gave the same
    bits (every row of at most one piece's slots)."""
    from keras_geometric_tpu_torch.kernels import attend_cuda as A
    from keras_geometric_tpu_torch.kernels import spmm_cuda as K
    from keras_geometric_tpu_torch.utils.profiling import (
        H100_BYTES_PER_S,
        H100_F32_OPS_PER_S,
    )

    gen = torch.Generator(device=device).manual_seed(6)
    entries = []
    for ctx_name, path, layer, heads, f, dtype, dropped in (
        ("gat_arxiv", "train_gat_arxiv_shape", "layer 1", GAT_ARXIV_HEADS,
         GAT_ARXIV_DIMS[0], torch.bfloat16, False),
        ("gat_arxiv", "train_gat_arxiv_shape", "layer 2", GAT_ARXIV_HEADS,
         GAT_ARXIV_DIMS[1], torch.bfloat16, False),
        ("citeseer", "train_gat_citeseer_shape", "layer 1",
         GAT_CITESEER_HEADS, GAT_CITESEER_DIMS[0], torch.float32, True),
        ("citeseer", "train_gat_citeseer_shape", "layer 2",
         GAT_CITESEER_HEADS, GAT_CITESEER_DIMS[1], torch.float32, True),
    ):
        ctx = contexts[ctx_name]
        n, e, d = ctx.num_nodes, ctx.senders.shape[0], heads * f
        es = 2 if dtype == torch.bfloat16 else 4
        ht, att, gout, drop = attend_inputs(gen, n, heads, f, dtype, e,
                                            dropped, device)
        graph = (ctx.senders, ctx.receivers, ctx.row_ptr)
        errs, _ = attend_case(
            graph + (ctx.edge_mask,), ht, att, gout, drop,
            f"attend at {ctx_name} {layer}")
        torch.cuda.empty_cache()
        out, scores, m, l = A.sddmm_stats_agg_sorted(
            ht, *graph, att, edge_valid=ctx.edge_mask, drop_mask=drop)
        rho = A.attend_rho_sorted(gout, scores, m, l, ht, *graph,
                                  drop_mask=drop)
        _, _, v = A.attend_recv_bwd_full_sorted(
            ht, gout, *graph, att, scores, m, l, rho, drop_mask=drop)
        del out
        finish_plain = K.gather_scatter_sum_sorted_plain(
            v, ctx.bwd_perm, ctx.senders_sorted, n)
        finish_mass = K.gather_scatter_sum_sorted_plain(
            v.float().abs(), ctx.bwd_perm, ctx.senders_sorted, n)
        finish = K.gather_scatter_sum_sorted(
            v, ctx.bwd_perm, ctx.senders_sorted, ctx.row_ptr_bwd, n)
        errs["gather_scatter_sum_sorted"] = compare(
            finish, finish_plain, finish_mass, dtype,
            f"sender finish at {ctx_name} {layer}")
        finish_rows = lambda: K.gather_scatter_sum_sorted(
            v, ctx.bwd_perm, ctx.senders_sorted, ctx.row_ptr_bwd, n,
            pieces=False)
        one_piece = check_one_piece_rows_equal(
            finish, finish_rows(), ctx.row_ptr_bwd,
            f"sender finish at {ctx_name} {layer}")
        del finish_plain, finish_mass, finish
        senders_long = ctx.senders.long()
        # The same graph and inputs over a stream without padded slots.
        bare = unpadded_context(ctx)
        bare_graph = (bare.senders, bare.receivers, bare.row_ptr)
        bare_drop = None if drop is None else drop[ctx.edge_mask]
        _, b_scores, b_m, b_l = A.sddmm_stats_agg_sorted(
            ht, *bare_graph, att, edge_valid=bare.edge_mask,
            drop_mask=bare_drop)
        b_rho = A.attend_rho_sorted(gout, b_scores, b_m, b_l, ht,
                                    *bare_graph, drop_mask=bare_drop)
        _, _, b_v = A.attend_recv_bwd_full_sorted(
            ht, gout, *bare_graph, att, b_scores, b_m, b_l, b_rho,
            drop_mask=bare_drop)
        unpadded = {
            "sddmm_stats_agg_sorted": lambda: A.sddmm_stats_agg_sorted(
                ht, *bare_graph, att, edge_valid=bare.edge_mask,
                drop_mask=bare_drop),
            "attend_rho_sorted": lambda: A.attend_rho_sorted(
                gout, b_scores, b_m, b_l, ht, *bare_graph,
                drop_mask=bare_drop),
            "attend_recv_bwd_full_sorted": lambda: (
                A.attend_recv_bwd_full_sorted(
                    ht, gout, *bare_graph, att, b_scores, b_m, b_l, b_rho,
                    drop_mask=bare_drop)),
            "gather_scatter_sum_sorted": lambda: K.gather_scatter_sum_sorted(
                b_v, bare.bwd_perm, bare.senders_sorted, bare.row_ptr_bwd,
                n),
        }

        counts = attend_counts(n, e, heads, f, es, dropped)
        index = e * 4 + (n + 1) * 4
        cases = {
            "sddmm_stats_agg_sorted": dict(
                kernel=lambda: A.sddmm_stats_agg_sorted(
                    ht, *graph, att, edge_valid=ctx.edge_mask,
                    drop_mask=drop),
                plain=lambda: A.sddmm_stats_agg_sorted_plain(
                    ht, *graph, att, edge_valid=ctx.edge_mask,
                    drop_mask=drop),
                counts=counts["sddmm_stats_agg_sorted"], library=None),
            "attend_rho_sorted": dict(
                kernel=lambda: A.attend_rho_sorted(
                    gout, scores, m, l, ht, *graph, drop_mask=drop),
                plain=lambda: A.attend_rho_sorted_plain(
                    gout, scores, m, l, ht, *graph, drop_mask=drop),
                counts=counts["attend_rho_sorted"], library=None),
            "attend_recv_bwd_full_sorted": dict(
                kernel=lambda: A.attend_recv_bwd_full_sorted(
                    ht, gout, *graph, att, scores, m, l, rho,
                    drop_mask=drop),
                plain=lambda: A.attend_recv_bwd_full_sorted_plain(
                    ht, gout, *graph, att, scores, m, l, rho,
                    drop_mask=drop),
                counts=counts["attend_recv_bwd_full_sorted"], library=None),
            "gather_scatter_sum_sorted": dict(
                kernel=lambda: K.gather_scatter_sum_sorted(
                    v, ctx.bwd_perm, ctx.senders_sorted, ctx.row_ptr_bwd, n),
                plain=lambda: K.gather_scatter_sum_sorted_plain(
                    v, ctx.bwd_perm, ctx.senders_sorted, n),
                # every row of v read once, the node rows written.
                counts=(e * d * es + n * d * es + index, e * d, None),
                library=lambda: torch.zeros(
                    n, d, dtype=dtype, device=device).index_add_(
                        0, senders_long, v)),
        }
        for name, case in cases.items():
            nbytes, ops, no_reuse = case["counts"]
            ms = timer.cold_ms(case["kernel"], iters=10)
            plain_ms = timer.cold_ms(case["plain"], iters=5, warmup=1)
            library_ms = None
            if case["library"] is not None:
                library_ms = timer.cold_ms(case["library"], iters=10)
            t_bytes = nbytes / H100_BYTES_PER_S * 1e3
            t_ops = ops / H100_F32_OPS_PER_S * 1e3
            entry = {
                "name": name, "route": "cuda",
                "source": SOURCES[REPLACES[name][0]],
                "replaces": replaces[name], "path": path,
                "shape": f"{ctx_name} {layer}: E={e} N={n} H={heads} F={f} "
                         f"{str(dtype)[6:]}"
                         f"{' dropout mask' if dropped else ''}",
                "launches": 0, "max_abs_err": errs[name], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": library_ms,
                "library": ("index_add_" if library_ms is not None else
                            "none: no single PyTorch call computes this"),
            }
            if no_reuse is not None:
                # Every gathered sender row from device memory, none from
                # cache: E more rows than the ideal count.
                entry["bound_ms_if_gather_not_reused"] = (
                    (nbytes + no_reuse) / H100_BYTES_PER_S * 1e3)
            sender_order = name == "gather_scatter_sum_sorted"
            entry.update(piece_walk_fields(
                name, ctx.row_ptr_bwd if sender_order else ctx.row_ptr))
            if name in PIECE_WALKS:
                entry["hub_row_ms"] = {label: times[name]
                                       for label, times in hub.items()}
            else:  # the finish, on the hub sender of send_skewed_graph
                entry["hub_row_ms"] = send_hub[name]
                entry["one_piece_rows_equal_to_row_walk"] = one_piece
                entry["ms_row_walk"] = timer.cold_ms(finish_rows, iters=10)
            entry["padded_slots"] = e - int(ctx.edge_mask.sum())
            entry["ms_unpadded"] = timer.cold_ms(unpadded[name], iters=10)
            entry["longest_row_unpadded"] = longest_row(
                bare.row_ptr_bwd if sender_order else bare.row_ptr)
            entries.append(entry)
        del v, scores, cases, b_v, b_scores, unpadded, bare
        torch.cuda.empty_cache()
    return entries


# ---------------------------------------------------------------------------
# The attention family's other modes, its sender backward and its two-pass
# forward against their plain versions
# ---------------------------------------------------------------------------


def sender_order(send, recv, valid, n):
    """The receiver-sorted stream in sender-sorted order, as ``prepare_graph``
    builds it: ``((receivers_ss, senders_sorted, row_ptr_bwd), valid_ss f32
    or None, perm)`` with ``perm[j]`` the receiver-order slot of ``j``."""
    perm = torch.sort(send.long(), stable=True).indices
    s_ss = send[perm].contiguous()
    r_ss = recv[perm].contiguous()
    ptr = torch.searchsorted(
        s_ss, torch.arange(n + 1, device=send.device, dtype=torch.int32))
    valid_ss = None if valid is None else valid[perm].float()
    return (r_ss, s_ss, ptr.to(torch.int32)), valid_ss, perm


def modes_case(graph, ht, att, gout, drop, what):
    """The three mode branches (the forward without its scores, rho and the
    receiver backward recomputing them, the receiver backward without
    ``v``), the sender backward, the score-and-statistics kernel and the
    aggregation against their plain versions on one input, under the
    tolerance of the module docstring; the kernels are fed the plain
    forward's statistics. Also held bit for bit: each mode against the
    cached one on the kernels' own forward, the score-and-statistics kernel
    against the forward's scores, ``m`` and ``l``, and a second launch of the
    sender backward against the first. Then the permute finish over the same
    sender order against its plain version, and its piece walk against its
    row walk bit for bit on the sender rows of at most one piece. Returns
    each kernel's (and branch's) largest absolute error."""
    from keras_geometric_tpu_torch.kernels import attend_cuda as A
    from keras_geometric_tpu_torch.kernels import sddmm_cuda as D
    from keras_geometric_tpu_torch.kernels import spmm_cuda as K

    send, recv, row_ptr, valid = graph
    n = ht.shape[0]
    g3 = (send, recv, row_ptr)
    ss, valid_ss, perm = sender_order(send, recv, valid, n)
    drop_ss = None if drop is None else drop[perm].contiguous()
    kw = dict(edge_valid=valid, drop_mask=drop)
    _, p_scores, p_m, p_l = A.sddmm_stats_agg_sorted_plain(ht, *g3, att, **kw)
    mass = attend_masses(graph, ht, att, gout, drop, p_scores, p_m, p_l)
    finite = torch.isfinite(p_scores)
    zero = torch.zeros_like(p_scores)
    errs = {}

    # The kernels' own forward, and every mode against it bit for bit.
    out, scores, m, l = A.sddmm_stats_agg_sorted(ht, *g3, att, **kw)
    no_scores = A.sddmm_stats_agg_sorted(ht, *g3, att, emit_scores=False,
                                         **kw)
    check(all(torch.equal(a, b) for a, b in zip(no_scores, (out, m, l))),
          f"{what}: the forward without its scores differs from the cached "
          f"launch")
    # The score-and-statistics kernel walks the forward's pieces with its
    # online step and merges split rows with its merge (ROADMAP D9): scores,
    # m and l agree bit for bit on every row, hubs and the padded tail too.
    stats = D.sddmm_stats_sorted(ht, *g3, att, edge_valid=valid)
    check(all(torch.equal(a, b) for a, b in zip(stats, (scores, m, l))),
          f"{what}: sddmm_stats_sorted differs from the forward's scores, m "
          f"or l")
    rho = A.attend_rho_sorted(gout, scores, m, l, ht, *g3, drop_mask=drop)
    check(torch.equal(rho, A.attend_rho_sorted(
        gout, None, m, l, ht, *g3, drop_mask=drop, att=att,
        edge_valid=valid)), f"{what}: recomputed rho differs from cached")
    cached = A.attend_recv_bwd_full_sorted(ht, gout, *g3, att, scores, m, l,
                                           rho, drop_mask=drop)
    for s_in, emit_v in ((scores, False), (None, True), (None, False)):
        got = A.attend_recv_bwd_full_sorted(
            ht, gout, *g3, att, s_in, m, l, rho, drop_mask=drop,
            emit_v=emit_v, edge_valid=valid)
        check(all(torch.equal(a, b) for a, b in zip(got, cached)),
              f"{what}: receiver backward (scores "
              f"{'cached' if s_in is not None else 'recomputed'}, emit_v="
              f"{emit_v}) differs from the cached launch with v")
    del out, scores, m, l, rho, cached, got, no_scores

    # Against the plain versions.
    errs["sddmm_stats_agg_sorted(emit_scores=False)"] = max(
        compare(k, p, mk, k.dtype, f"{what} {name} (no scores)")
        for k, p, mk, name in zip(
            A.sddmm_stats_agg_sorted(ht, *g3, att, emit_scores=False, **kw),
            A.sddmm_stats_agg_sorted_plain(ht, *g3, att, emit_scores=False,
                                           **kw),
            (mass["out"], mass["row_s"], p_l * mass["amp"]),
            ("out", "m", "l")))
    s8, m8, l8 = D.sddmm_stats_sorted(ht, *g3, att, edge_valid=valid)
    check(bool((torch.isfinite(s8) == finite).all()),
          f"{what}: sddmm_stats_sorted: -inf not exactly on invalid slots")
    errs["sddmm_stats_sorted"] = max(
        compare(torch.where(finite, s8, zero),
                torch.where(finite, p_scores, zero), mass["s"], s8.dtype,
                f"{what} sddmm_stats_sorted scores"),
        compare(m8, p_m, mass["row_s"], m8.dtype,
                f"{what} sddmm_stats_sorted m"),
        compare(l8, p_l, p_l * mass["amp"], l8.dtype,
                f"{what} sddmm_stats_sorted l"))
    del s8, m8, l8
    errs["attend_aggregate_sorted"] = compare(
        A.attend_aggregate_sorted(p_scores, p_m, p_l, ht, *g3,
                                  drop_mask=drop),
        A.attend_aggregate_sorted_plain(p_scores, p_m, p_l, ht, *g3,
                                        drop_mask=drop),
        mass["out_terms"], ht.dtype, f"{what} attend_aggregate_sorted")
    recompute = dict(drop_mask=drop, att=att, edge_valid=valid)
    p_rho = A.attend_rho_sorted_plain(gout, None, p_m, p_l, ht, *g3,
                                      **recompute)
    errs["attend_rho_sorted(scores=None)"] = compare(
        A.attend_rho_sorted(gout, None, p_m, p_l, ht, *g3, **recompute),
        p_rho, mass["rho"], torch.float32, f"{what} rho (scores=None)")
    masses = (mass["dht"], mass["datt"], mass["v"])
    for s_in, emit_v, name in (
            (None, True, "attend_recv_bwd_full_sorted(scores=None)"),
            (p_scores, False, "attend_recv_bwd_full_sorted(emit_v=False)"),
            (None, False,
             "attend_recv_bwd_full_sorted(scores=None, emit_v=False)")):
        args = (ht, gout, *g3, att, s_in, p_m, p_l, p_rho)
        bkw = dict(drop_mask=drop, emit_v=emit_v, edge_valid=valid)
        errs[name] = max(
            compare(k, p, mk, k.dtype, f"{what} {name} {part}")
            for k, p, mk, part in zip(
                A.attend_recv_bwd_full_sorted(*args, **bkw),
                A.attend_recv_bwd_full_sorted_plain(*args, **bkw), masses,
                ("dht", "datt", "v")))
    send_args = (ht, gout, *ss, att, p_m, p_l, p_rho)
    send_kw = dict(valid_ss=valid_ss, drop_ss=drop_ss)
    got = A.attend_send_bwd_sorted(*send_args, **send_kw)
    check(torch.equal(got, A.attend_send_bwd_sorted(*send_args, **send_kw)),
          f"{what}: two launches of attend_send_bwd_sorted differ")
    send_mass = torch.zeros_like(mass["v"][:n]).index_add_(
        0, send.long(), mass["v"])
    errs["attend_send_bwd_sorted"] = compare(
        got, A.attend_send_bwd_sorted_plain(*send_args, **send_kw),
        send_mass, ht.dtype, f"{what} attend_send_bwd_sorted")
    # The permute finish over the same sender order: the fused-gather
    # scatter of the plain receiver backward's v through perm, its piece
    # walk against the plain version and, on every sender row of at most one
    # piece's slots, against its row walk bit for bit.
    p_v = A.attend_recv_bwd_full_sorted_plain(
        ht, gout, *g3, att, p_scores, p_m, p_l, p_rho, drop_mask=drop)[2]
    finish = (p_v, perm.to(torch.int32), ss[1], ss[2], n)
    got = K.gather_scatter_sum_sorted(*finish)
    errs["gather_scatter_sum_sorted(sender finish)"] = compare(
        got, K.gather_scatter_sum_sorted_plain(*finish[:3], n),
        K.gather_scatter_sum_sorted_plain(p_v.float().abs(), *finish[1:3], n),
        ht.dtype, f"{what} sender finish")
    check_one_piece_rows_equal(
        got, K.gather_scatter_sum_sorted(*finish, pieces=False), ss[2],
        f"{what} sender finish")
    return errs


def send_skewed_graph(device, hub=20_000):
    """The skewed graph of the kernel sweep (a 20,000-slot hub receiver row,
    empty receiver rows, padded slots in the last row) with the senders the
    sender backward must also survive: a ``hub``-slot hub sender (row 8),
    the padded slots' senders set to the last row as ``prepare_graph`` sets
    them (so in sender order they pile into that row), an empty sender row
    (``n - 2``), and a sender row whose every slot is invalid (row 10, its
    slots marked padded)."""
    g = dict(skewed_graph(device))
    n = g["n"]
    idx, mask = g["idx"].clone(), g["mask"].clone()
    e_real = int(mask.sum().item())
    idx[20_000:20_000 + hub] = 8
    idx[idx == n - 2] = n - 3
    mask &= idx != 10
    idx[e_real:] = n - 1
    g.update(idx=idx, mask=mask)
    return g


def modes_sweep(device, timer):
    """``modes_case`` at every listed (H, F), both types, with and without
    a dropout mask, on ``send_skewed_graph``; then what its 20,000-slot hub
    sender row costs the sender backward and the permute finish (the same
    graph timed with and without that row, at the arxiv layer-1 width in
    bf16, with each kernel's bound and the finish's plain version's time;
    ``modes_case`` also holds every kernel on the graph without the row)."""
    from keras_geometric_tpu_torch.kernels import attend_cuda as A
    from keras_geometric_tpu_torch.kernels import spmm_cuda as K

    g = send_skewed_graph(device)
    graph = (g["idx"], g["recv"], g["row_ptr"], g["mask"])
    gen = torch.Generator(device=device).manual_seed(13)
    worst, cases = {}, 0
    for dtype in (torch.bfloat16, torch.float32):
        for heads, f in ATTEND_SHAPES:
            for dropped in (False, True):
                ht, att, gout, drop = attend_inputs(
                    gen, g["n"], heads, f, dtype, g["e"], dropped, device)
                errs = modes_case(
                    graph, ht, att, gout, drop,
                    f"modes {str(dtype)[6:]} H={heads} F={f}"
                    f"{' dropout' if dropped else ''}")
                for name, err in errs.items():
                    worst[name] = max(worst.get(name, 0.0), err)
                cases += len(errs)
    torch.cuda.synchronize()
    from keras_geometric_tpu_torch.utils.profiling import (
        H100_BYTES_PER_S,
        H100_F32_OPS_PER_S,
    )

    hub = {"attend_send_bwd_sorted": {"bound_ms": {}},
           "gather_scatter_sum_sorted": {"bound_ms": {}, "plain_ms": {}}}
    heads, f = GAT_ARXIV_HEADS, GAT_ARXIV_DIMS[0]

    def bound_ms(nbytes, ops):
        return max(nbytes / H100_BYTES_PER_S, ops / H100_F32_OPS_PER_S) * 1e3

    for label, sg in (("with_hub_sender", g),
                      ("without_hub_sender", send_skewed_graph(device, 0))):
        ht, att, gout, _ = attend_inputs(gen, sg["n"], heads, f,
                                         torch.bfloat16, sg["e"], False,
                                         device)
        graph = (sg["idx"], sg["recv"], sg["row_ptr"])
        if label == "without_hub_sender":
            errs = modes_case(graph + (sg["mask"],), ht, att, gout, None,
                              f"modes without the hub sender bf16 H={heads} "
                              f"F={f}")
            for name, err in errs.items():
                worst[name] = max(worst.get(name, 0.0), err)
            cases += len(errs)
        _, scores, m, l = A.sddmm_stats_agg_sorted(ht, *graph, att,
                                                   edge_valid=sg["mask"])
        rho = A.attend_rho_sorted(gout, scores, m, l, ht, *graph)
        _, _, v = A.attend_recv_bwd_full_sorted(ht, gout, *graph, att,
                                                scores, m, l, rho)
        ss, valid_ss, perm = sender_order(sg["idx"], sg["recv"], sg["mask"],
                                          sg["n"])
        finish = (v, perm.to(torch.int32), ss[1], ss[2], sg["n"])
        hub["attend_send_bwd_sorted"][label] = timer.cold_ms(
            lambda: A.attend_send_bwd_sorted(ht, gout, *ss, att, m, l, rho,
                                             valid_ss=valid_ss), iters=10)
        hub["gather_scatter_sum_sorted"][label] = timer.cold_ms(
            lambda: K.gather_scatter_sum_sorted(*finish), iters=10)
        hub["gather_scatter_sum_sorted"]["plain_ms"][label] = timer.cold_ms(
            lambda: K.gather_scatter_sum_sorted_plain(v, finish[1], ss[1],
                                                      sg["n"]),
            iters=5, warmup=1)
        # As time_mode_cases and time_attend_cases count them (bf16, no
        # dropout): K10d reads ht, g and (m, l, rho) once and writes its
        # output, with the sender-order index, receivers and validity; the
        # finish reads every row of v once and writes the node rows.
        n, e, d = sg["n"], sg["e"], heads * f
        nodes, index = n * d * 2, e * 4 + (n + 1) * 4
        hub["attend_send_bwd_sorted"]["bound_ms"][label] = bound_ms(
            *attend_counts(n, e, heads, f, 2)["attend_send_bwd_sorted"][:2])
        hub["gather_scatter_sum_sorted"]["bound_ms"][label] = bound_ms(
            e * d * 2 + nodes + index, e * d)
        del v, scores, finish
    return cases, worst, hub


def time_wide_heads(device, timer, ctx):
    """The fused attention kernels (forward, rho, receiver backward) on the
    arxiv-shaped GATv2 graph in bf16 at one head of 256 columns (the widest
    narrow launch) and at the wide heads of ``WIDE_HEAD_SHAPES``, which run
    the slab-walking instantiations: the price of a head wider than 256
    columns, per call and per column, and each call's bound (the bytes the
    fused arxiv rows count, over the card's memory rate)."""
    from keras_geometric_tpu_torch.kernels import attend_cuda as A
    from keras_geometric_tpu_torch.utils.profiling import H100_BYTES_PER_S

    gen = torch.Generator(device=device).manual_seed(25)
    graph = (ctx.senders, ctx.receivers, ctx.row_ptr)
    e = int(ctx.senders.shape[0])
    out = {}
    for heads, f in ((1, 256),) + WIDE_HEAD_SHAPES:
        ht, att, gout, _ = attend_inputs(gen, ctx.num_nodes, heads, f,
                                         torch.bfloat16, e, False, device)
        _, scores, m, l = A.sddmm_stats_agg_sorted(ht, *graph, att,
                                                   edge_valid=ctx.edge_mask)
        rho = A.attend_rho_sorted(gout, scores, m, l, ht, *graph)
        times = {
            "sddmm_stats_agg_sorted": timer.cold_ms(
                lambda: A.sddmm_stats_agg_sorted(
                    ht, *graph, att, edge_valid=ctx.edge_mask), iters=10),
            "attend_rho_sorted": timer.cold_ms(
                lambda: A.attend_rho_sorted(gout, scores, m, l, ht, *graph),
                iters=10),
            "attend_recv_bwd_full_sorted": timer.cold_ms(
                lambda: A.attend_recv_bwd_full_sorted(
                    ht, gout, *graph, att, scores, m, l, rho), iters=10),
        }
        counts = attend_counts(ctx.num_nodes, e, heads, f, 2)  # bf16
        nbytes = {k: counts[k][0] for k in (
            "sddmm_stats_agg_sorted", "attend_rho_sorted",
            "attend_recv_bwd_full_sorted")}
        times["ms_per_1k_columns"] = {
            k: v * 1000 / (heads * f) for k, v in list(times.items())}
        times["bound_ms"] = {k: b / H100_BYTES_PER_S * 1e3
                             for k, b in nbytes.items()}
        times["bound_by"] = "bytes"
        out[f"H={heads} F={f}"] = times
        del ht, att, gout, scores, m, l, rho
    return out


def time_mode_cases(device, timer, contexts, replaces, hub, send_hub):
    """The mode branches, the sender backward and the two-pass forward's
    kernels at the shapes their runs give them: kernel, plain version, bound
    from bytes and operations, and the bound if no gathered row came from
    the cache; for the kernels that walk pieces, the work list and the CUDA
    kernels a call launches, for the sender backward its times on
    ``send_skewed_graph`` with and without its hub sender (``send_hub``),
    and for the two-pass forward's kernels their times on ``attend_sweep``'s
    graph with and without its 20,000-slot hub row (``hub``) and on the same
    graph prepared without padded slots (``ms_unpadded``). No single
    PyTorch call computes any of them (null ``library_ms``)."""
    from keras_geometric_tpu_torch.kernels import attend_cuda as A
    from keras_geometric_tpu_torch.kernels import sddmm_cuda as D
    from keras_geometric_tpu_torch.utils.profiling import (
        H100_BYTES_PER_S,
        H100_F32_OPS_PER_S,
    )

    gen = torch.Generator(device=device).manual_seed(14)
    entries = []
    arxiv = [("gat_arxiv", "layer 1", GAT_ARXIV_HEADS, GAT_ARXIV_DIMS[0],
              torch.bfloat16, False),
             ("gat_arxiv", "layer 2", GAT_ARXIV_HEADS, GAT_ARXIV_DIMS[1],
              torch.bfloat16, False)]
    citeseer = [("citeseer", "layer 1", GAT_CITESEER_HEADS,
                 GAT_CITESEER_DIMS[0], torch.float32, True),
                ("citeseer", "layer 2", GAT_CITESEER_HEADS,
                 GAT_CITESEER_DIMS[1], torch.float32, True)]
    for ctx_name, layer, heads, f, dtype, dropped in arxiv + citeseer:
        ctx = contexts[ctx_name]
        n, e = ctx.num_nodes, ctx.senders.shape[0]
        es = 2 if dtype == torch.bfloat16 else 4
        ht, att, gout, drop = attend_inputs(gen, n, heads, f, dtype, e,
                                            dropped, device)
        graph = (ctx.senders, ctx.receivers, ctx.row_ptr)
        valid = ctx.edge_mask
        ss = (ctx.receivers_ss, ctx.senders_sorted, ctx.row_ptr_bwd)
        drop_ss = (None if drop is None
                   else drop.index_select(0, ctx.bwd_perm.long()))
        errs = modes_case(graph + (valid,), ht, att, gout, drop,
                          f"modes at {ctx_name} {layer}")
        torch.cuda.empty_cache()
        _, scores, m, l = A.sddmm_stats_agg_sorted(
            ht, *graph, att, edge_valid=valid, drop_mask=drop)
        rho = A.attend_rho_sorted(gout, scores, m, l, ht, *graph,
                                  drop_mask=drop)
        counts = attend_counts(n, e, heads, f, es, dropped)
        recompute = dict(att=att, edge_valid=valid, drop_mask=drop)
        recv_kw = dict(drop_mask=drop, edge_valid=valid)
        # name, mode, path, kernel, plain
        cases = [
            ("sddmm_stats_agg_sorted", "emit_scores=False", "nocache",
             lambda: A.sddmm_stats_agg_sorted(
                 ht, *graph, att, edge_valid=valid, drop_mask=drop,
                 emit_scores=False),
             lambda: A.sddmm_stats_agg_sorted_plain(
                 ht, *graph, att, edge_valid=valid, drop_mask=drop,
                 emit_scores=False)),
            ("attend_rho_sorted", "scores=None", "nocache",
             lambda: A.attend_rho_sorted(gout, None, m, l, ht, *graph,
                                         **recompute),
             lambda: A.attend_rho_sorted_plain(gout, None, m, l, ht, *graph,
                                               **recompute)),
            ("attend_recv_bwd_full_sorted", "scores=None", "nocache",
             lambda: A.attend_recv_bwd_full_sorted(
                 ht, gout, *graph, att, None, m, l, rho, **recv_kw),
             lambda: A.attend_recv_bwd_full_sorted_plain(
                 ht, gout, *graph, att, None, m, l, rho, **recv_kw)),
            ("attend_recv_bwd_full_sorted", "emit_v=False", "send",
             lambda: A.attend_recv_bwd_full_sorted(
                 ht, gout, *graph, att, scores, m, l, rho, emit_v=False,
                 **recv_kw),
             lambda: A.attend_recv_bwd_full_sorted_plain(
                 ht, gout, *graph, att, scores, m, l, rho, emit_v=False,
                 **recv_kw)),
            ("attend_recv_bwd_full_sorted", "scores=None, emit_v=False",
             "send_nocache",
             lambda: A.attend_recv_bwd_full_sorted(
                 ht, gout, *graph, att, None, m, l, rho, emit_v=False,
                 **recv_kw),
             lambda: A.attend_recv_bwd_full_sorted_plain(
                 ht, gout, *graph, att, None, m, l, rho, emit_v=False,
                 **recv_kw)),
            ("attend_send_bwd_sorted", None, "send",
             lambda: A.attend_send_bwd_sorted(
                 ht, gout, *ss, att, m, l, rho, valid_ss=ctx.edge_mask_ss,
                 drop_ss=drop_ss),
             lambda: A.attend_send_bwd_sorted_plain(
                 ht, gout, *ss, att, m, l, rho, valid_ss=ctx.edge_mask_ss,
                 drop_ss=drop_ss)),
            ("sddmm_stats_sorted", None, "two_pass",
             lambda: D.sddmm_stats_sorted(ht, *graph, att, edge_valid=valid),
             lambda: D.sddmm_stats_sorted_plain(ht, *graph, att,
                                                edge_valid=valid)),
            ("attend_aggregate_sorted", None, "two_pass",
             lambda: A.attend_aggregate_sorted(scores, m, l, ht, *graph,
                                               drop_mask=drop),
             lambda: A.attend_aggregate_sorted_plain(scores, m, l, ht,
                                                     *graph, drop_mask=drop)),
        ]
        for name, mode, run, kernel, plain in cases:
            if ctx_name == "citeseer" and name != "attend_send_bwd_sorted":
                continue  # the CiteSeer send run launches no other branch
            path = ("attend_two_pass_arxiv_shape" if run == "two_pass" else
                    f"train_gat_{ctx_name.removeprefix('gat_')}_shape_{run}")
            key = name if mode is None else f"{name}({mode})"
            err = errs[key]
            nbytes, ops, no_reuse = counts[key]
            ms = timer.cold_ms(kernel, iters=10)
            plain_ms = timer.cold_ms(plain, iters=5, warmup=1)
            t_bytes = nbytes / H100_BYTES_PER_S * 1e3
            t_ops = ops / H100_F32_OPS_PER_S * 1e3
            entry = {
                "name": name, "route": "cuda",
                "source": SOURCES[REPLACES[name][0]],
                "replaces": replaces[name], "path": path,
                "shape": f"{ctx_name} {layer}: E={e} N={n} H={heads} F={f} "
                         f"{str(dtype)[6:]}"
                         f"{' dropout mask' if dropped else ''}",
                "launches": 0, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None,
                "library": "none: no single PyTorch call computes this",
                "bound_ms_if_gather_not_reused":
                    (nbytes + no_reuse) / H100_BYTES_PER_S * 1e3,
            }
            if mode is not None:
                entry["mode"] = mode
            if name in PIECE_WALKS:
                entry.update(piece_walk_fields(name, ctx.row_ptr))
            elif name == "attend_send_bwd_sorted":
                entry.update(piece_walk_fields(name, ctx.row_ptr_bwd))
                entry["hub_row_ms"] = send_hub[name]
            if run == "two_pass":
                entry.update(piece_walk_fields(name, ctx.row_ptr))
                entry["hub_row_ms"] = {label: times[name]
                                       for label, times in hub.items()}
                # The same graph and inputs over a stream without padded
                # slots: what the padded tail's pieces cost.
                bare = unpadded_context(ctx)
                b_graph = (bare.senders, bare.receivers, bare.row_ptr)
                b_stats = D.sddmm_stats_sorted(ht, *b_graph, att,
                                               edge_valid=bare.edge_mask)
                unpadded = {
                    "sddmm_stats_sorted": lambda: D.sddmm_stats_sorted(
                        ht, *b_graph, att, edge_valid=bare.edge_mask),
                    "attend_aggregate_sorted": lambda: (
                        A.attend_aggregate_sorted(*b_stats, ht, *b_graph)),
                }
                entry["padded_slots"] = e - int(valid.sum())
                entry["ms_unpadded"] = timer.cold_ms(unpadded[name],
                                                     iters=10)
                entry["longest_row_unpadded"] = longest_row(bare.row_ptr)
                del bare, b_graph, b_stats, unpadded
            entries.append(entry)
        del scores, rho, cases
        torch.cuda.empty_cache()
    return entries


def two_pass_phase(device, ctx, timer):
    """``sddmm_stats_sorted`` then ``attend_aggregate_sorted`` at the two
    arxiv-shaped GATv2 layers (random ``ht`` and ``att`` from a seed, bf16),
    against the one-pass forward on the same inputs: scores, ``m`` and ``l``
    bit for bit, the output under the tolerance of the module docstring
    (mass: the sum of the absolute values of its terms), and against the
    aggregation's plain version. The launch counts are read around the
    two-pass calls alone. Then, outside them, the aggregation at layer 1
    with a dropout mask against the one-pass forward and the plain version
    under the same mask, and on ``skewed_graph`` (4 heads of 64, bf16) with
    its 20,000-slot hub row and without it against the plain version (the
    kernels line has its times there). Returns the counts."""
    from keras_geometric_tpu_torch.kernels import attend_cuda as A
    from keras_geometric_tpu_torch.kernels import sddmm_cuda as D

    gen = torch.Generator(device=device).manual_seed(15)
    graph = (ctx.senders, ctx.receivers, ctx.row_ptr)
    e = ctx.senders.shape[0]
    inputs = [attend_inputs(gen, ctx.num_nodes, GAT_ARXIV_HEADS, f,
                            torch.bfloat16, e, False, device)[:2]
              for f in GAT_ARXIV_DIMS]
    torch.cuda.synchronize()
    reset_launch_counts()
    two_pass = []
    for ht, att in inputs:
        scores, m, l = D.sddmm_stats_sorted(ht, *graph, att,
                                            edge_valid=ctx.edge_mask)
        out = A.attend_aggregate_sorted(scores, m, l, ht, *graph)
        two_pass.append((out, scores, m, l))
    torch.cuda.synchronize()
    counts = launch_counts()
    check(counts["sddmm_stats_sorted"] == counts[
        "attend_aggregate_sorted"] == 2 and sum(counts.values()) == 4,
          f"attend_two_pass_arxiv_shape: launch counts {counts}")
    report = {}
    for (ht, att), (out, scores, m, l), layer in zip(
            inputs, two_pass, ("layer 1", "layer 2")):
        fused = A.sddmm_stats_agg_sorted(ht, *graph, att,
                                         edge_valid=ctx.edge_mask)
        check(all(torch.equal(a, b) for a, b in zip(
            (scores, m, l), fused[1:])),
              f"two-pass {layer}: scores, m, l differ from the one-pass "
              f"forward's")
        mass = attend_masses(graph + (ctx.edge_mask,), ht, att, ht, None,
                             scores, m, l)
        err = compare(out, fused[0], mass["out_terms"], out.dtype,
                      f"two-pass {layer} out against the one-pass forward")
        err_plain = compare(
            out, A.attend_aggregate_sorted_plain(scores, m, l, ht, *graph),
            mass["out_terms"], out.dtype,
            f"two-pass {layer} out against the aggregation's plain version")
        check(bool(torch.isfinite(out).all()) and out.shape == ht.shape,
              f"two-pass {layer}: output not finite or of the wrong shape")
        report[layer] = {
            "out_max_abs_err_vs_one_pass": err,
            "out_max_abs_err_vs_plain": err_plain,
            "scores_m_l_equal_bit_for_bit": True,
            "two_pass_ms": timer.cold_ms(lambda: A.attend_aggregate_sorted(
                *D.sddmm_stats_sorted(ht, *graph, att,
                                      edge_valid=ctx.edge_mask), ht,
                *graph), iters=10),
            "one_pass_ms": timer.cold_ms(lambda: A.sddmm_stats_agg_sorted(
                ht, *graph, att, edge_valid=ctx.edge_mask), iters=10),
        }
        del fused, mass

    # Layer 1 with a dropout mask (it scales the numerator only).
    (ht, att), (_, scores, m, l) = inputs[0], two_pass[0]
    u = torch.rand(e, GAT_ARXIV_HEADS, generator=gen, device=device)
    drop = torch.where(u < 0.7, 1.0 / 0.7, 0.0).to(torch.bfloat16)
    out = A.attend_aggregate_sorted(scores, m, l, ht, *graph, drop_mask=drop)
    fused = A.sddmm_stats_agg_sorted(ht, *graph, att,
                                     edge_valid=ctx.edge_mask, drop_mask=drop)
    mass = attend_masses(graph + (ctx.edge_mask,), ht, att, ht, drop,
                         scores, m, l)["out_terms"]
    report["layer 1 dropout mask"] = {
        "out_max_abs_err_vs_one_pass": compare(
            out, fused[0], mass, out.dtype,
            "two-pass layer 1 with a dropout mask against the one-pass "
            "forward"),
        "out_max_abs_err_vs_plain": compare(
            out, A.attend_aggregate_sorted_plain(scores, m, l, ht, *graph,
                                                 drop_mask=drop),
            mass, out.dtype, "two-pass layer 1 with a dropout mask against "
            "the aggregation's plain version")}
    del u, drop, out, fused, mass, two_pass

    # A 20,000-slot hub row: its pieces run side by side.
    for label, hub in (("with_hub_row", 20_000), ("without_hub_row", 0)):
        g = skewed_graph(device, hub=hub)
        ht, att, _, _ = attend_inputs(gen, g["n"], GAT_ARXIV_HEADS,
                                      GAT_ARXIV_DIMS[0], torch.bfloat16,
                                      g["e"], False, device)
        args = (g["idx"], g["recv"], g["row_ptr"])
        stats = D.sddmm_stats_sorted(ht, *args, att, edge_valid=g["mask"])
        out = A.attend_aggregate_sorted(*stats, ht, *args)
        mass = attend_masses(args + (g["mask"],), ht, att, ht, None,
                             *stats)["out_terms"]
        report[f"skewed_graph {label}"] = {
            "slots": g["e"], "longest_row": longest_row(g["row_ptr"]),
            "out_max_abs_err_vs_plain": compare(
                out, A.attend_aggregate_sorted_plain(*stats, ht, *args),
                mass, out.dtype,
                f"two-pass aggregation on skewed_graph {label}")}
        del g, ht, att, stats, out, mass
    emit("attend_two_pass_arxiv_shape", launches=counts, **report)
    return counts


# ---------------------------------------------------------------------------
# The composed attention path's kernels against their plain versions
# ---------------------------------------------------------------------------


def softmax_case(recv, row_ptr, n, scores, out_dtype, what):
    """The statistics and normalisation kernels against their plain versions
    on one input; the normalisation is fed the plain statistics, so each
    kernel is held alone. Returns each kernel's largest absolute error and
    the kernel's ``m``, ``l``."""
    from keras_geometric_tpu_torch.kernels import softmax_cuda as S

    m, l = S.softmax_stats_sorted(scores, recv, row_ptr, n)
    p_m, p_l = S.softmax_stats_sorted_plain(scores, recv, n)
    terms = (row_ptr[1:] - row_ptr[:-1]).float()[:, None]
    l_mass = p_l * (1.0 + terms * 2.0 ** -24 / RTOL_MASS)
    errs = {"softmax_stats_sorted": max(
        compare(m, p_m, p_m.abs(), torch.float32, f"{what} m"),
        compare(l, p_l, l_mass, torch.float32, f"{what} l"))}
    alpha = S.softmax_apply_sorted(scores, p_m, p_l, recv, out_dtype=out_dtype)
    p_alpha = S.softmax_apply_sorted_plain(scores, p_m, p_l, recv,
                                           out_dtype=out_dtype)
    errs["softmax_apply_sorted"] = compare(
        alpha, p_alpha, p_alpha.float(), out_dtype, f"{what} alpha")
    return errs, m, l, alpha


def sddmm_case(recv, row_ptr, ht, hj, att, ds, what):
    """The score kernel and its backward against their plain versions on one
    input, each element held to the tolerance of the module docstring."""
    from keras_geometric_tpu_torch.kernels import sddmm_cuda as D

    e = recv.shape[0]
    heads, f = att.shape
    z_abs = (ht.float().abs().index_select(0, recv.long())
             + hj.float().abs()).view(e, heads, f)
    s_mass = (z_abs * att.float().abs()).sum(-1)
    errs = {"sddmm_scores_sorted": compare(
        D.sddmm_scores_sorted(ht, hj, att, recv, row_ptr=row_ptr),
        D.sddmm_scores_sorted_plain(ht, hj, att, recv), s_mass,
        torch.float32, f"{what} scores")}
    d_pre, datt = D.sddmm_bwd_sorted(ht, hj, att, ds, recv, row_ptr=row_ptr)
    p_d_pre, p_datt = D.sddmm_bwd_sorted_plain(ht, hj, att, ds, recv)
    datt_mass = (z_abs * ds.abs()[:, :, None]).sum(0)
    errs["sddmm_bwd_sorted"] = max(
        compare(d_pre, p_d_pre, p_d_pre.float().abs(), ht.dtype,
                f"{what} d_pre"),
        compare(datt, p_datt, datt_mass, att.dtype, f"{what} datt"))
    # datt is summed in a fixed order (no atomics): a second launch gives
    # the same bits, and so does d_pre.
    again = D.sddmm_bwd_sorted(ht, hj, att, ds, recv, row_ptr=row_ptr)
    check(torch.equal(again[1], datt) and torch.equal(again[0], d_pre),
          f"{what}: a second launch of sddmm_bwd_sorted gave other bits")
    return errs


def sddmm_inputs(gen, n, e, heads, f, dtype, valid, device):
    d = heads * f
    ht = (0.5 * torch.randn(n, d, generator=gen, device=device)).to(dtype)
    hj = (0.5 * torch.randn(e, d, generator=gen, device=device)).to(dtype)
    att = (0.3 * torch.randn(heads, f, generator=gen, device=device)).to(dtype)
    ds = torch.randn(e, heads, generator=gen, device=device)
    ds = ds.masked_fill(~valid[:, None], 0.0)  # alpha = 0 on padded slots
    return ht, hj, att, ds


def masked_scores(gen, e, k, valid, device):
    scores = 3.0 * torch.randn(e, k, generator=gen, device=device)
    return scores.masked_fill(~valid[:, None], float("-inf"))


def composed_sweep(device, timer):
    """The composed path's kernels on the skewed graph: the softmax kernels
    at every K of ``SOFTMAX_HEADS`` (f32 and bf16 alpha) with one row whose
    scores are all -inf, the score kernels at every (H, F) of
    ``ATTEND_SHAPES`` in both types; then each kernel's time with and without
    the 20,000-slot hub row."""
    from keras_geometric_tpu_torch.kernels import sddmm_cuda as D
    from keras_geometric_tpu_torch.kernels import softmax_cuda as S

    g = skewed_graph(device)
    n, e, recv, row_ptr = g["n"], g["e"], g["recv"], g["row_ptr"]
    gen = torch.Generator(device=device).manual_seed(8)
    worst = {name: 0.0 for name in (*S.LAUNCH_COUNTS, *D.LAUNCH_COUNTS)}
    cases = 0
    dead = 8  # a row with slots, every score of which is -inf
    lo, hi = int(row_ptr[dead]), int(row_ptr[dead + 1])
    check(hi > lo, "the skewed graph's row 8 must have slots")
    for k in SOFTMAX_HEADS:
        scores = masked_scores(gen, e, k, g["mask"], device)
        scores[lo:hi] = float("-inf")
        for out_dtype in (torch.float32, torch.bfloat16):
            errs, m, l, alpha = softmax_case(
                recv, row_ptr, n, scores, out_dtype,
                f"softmax K={k} alpha {str(out_dtype)[6:]}")
            for name, err in errs.items():
                worst[name] = max(worst[name], err)
            cases += len(errs)
        torch.cuda.synchronize()
        # Empty rows, the all -inf row and the padded slots: exact zeros.
        for name, t in (("m", m), ("l", l)):
            check(not t[1::2][:-1].any().item() and not t[dead].any().item(),
                  f"softmax K={k}: {name} of rows without a finite score")
        alpha = S.softmax_apply_sorted(scores, m, l, recv)
        check(not alpha[lo:hi].any().item() and
              not alpha[~g["mask"]].any().item(),
              f"softmax K={k}: alpha of -inf slots must be 0")
    for dtype in (torch.bfloat16, torch.float32):
        for heads, f in ATTEND_SHAPES:
            ht, hj, att, ds = sddmm_inputs(gen, n, e, heads, f, dtype,
                                           g["mask"], device)
            errs = sddmm_case(recv, row_ptr, ht, hj, att, ds,
                              f"sddmm {str(dtype)[6:]} H={heads} F={f}")
            for name, err in errs.items():
                worst[name] = max(worst[name], err)
            cases += len(errs)
    torch.cuda.synchronize()
    try:
        D.sddmm_scores_sorted(ht.double(), hj.double(), att, recv,
                              row_ptr=row_ptr)
    except TypeError:
        pass
    else:
        check(False, "float64 data must be refused on a CUDA tensor")
    try:
        D.sddmm_scores_sorted(ht, hj, att, recv)
    except ValueError:
        pass
    else:
        check(False, "the score kernel must refuse a CUDA tensor without "
              "row_ptr")
    try:
        D.sddmm_bwd_sorted(ht, hj, att, ds, recv)
    except ValueError:
        pass
    else:
        check(False, "the score backward must refuse a CUDA tensor without "
              "row_ptr")

    hub = {}
    heads, f = GAT_ARXIV_HEADS, GAT_ARXIV_DIMS[0]
    for label, sg in (("with_hub_row", g),
                      ("without_hub_row", skewed_graph(device, hub=0))):
        sn, se, srecv, sptr = sg["n"], sg["e"], sg["recv"], sg["row_ptr"]
        ht, hj, att, ds = sddmm_inputs(gen, sn, se, heads, f, torch.bfloat16,
                                       sg["mask"], device)
        scores = masked_scores(gen, se, heads, sg["mask"], device)
        m, l = S.softmax_stats_sorted(scores, srecv, sptr, sn)
        hub[label] = {
            "slots": se,
            "softmax_stats_sorted": timer.cold_ms(
                lambda: S.softmax_stats_sorted(scores, srecv, sptr, sn),
                iters=10),
            "softmax_apply_sorted": timer.cold_ms(
                lambda: S.softmax_apply_sorted(scores, m, l, srecv),
                iters=10),
            "sddmm_scores_sorted": timer.cold_ms(
                lambda: D.sddmm_scores_sorted(ht, hj, att, srecv,
                                              row_ptr=sptr), iters=10),
            "sddmm_bwd_sorted": timer.cold_ms(
                lambda: D.sddmm_bwd_sorted(ht, hj, att, ds, srecv,
                                           row_ptr=sptr), iters=10),
        }
    return cases, worst, hub


# The composed path's kernels that walk the pieces of row_ptr: the CUDA
# kernels every call launches, and those it adds where a row is split (K5's
# merge of the split rows; K7b's second launch, the fixed-order sum of
# datt's rows, runs always).
COMPOSED_PIECE_KERNELS = {
    "sddmm_scores_sorted": (("sddmm_scores_kernel",), ()),
    "softmax_stats_sorted": (("softmax_stats_kernel",),
                             ("softmax_stats_finish_kernel",)),
    "sddmm_bwd_sorted": (("sddmm_bwd_kernel", "reduce_partials_kernel"), ()),
}


def time_composed_cases(device, timer, contexts, replaces):
    """The composed path's four kernels at the shapes its GATv2 training runs
    give them: kernel, plain version, bound from bytes and operations. No
    single PyTorch call computes any of them (``torch.segment_reduce`` gives
    a row's max but not its sum of exponentials), so ``library_ms`` is
    null. The normalisation also gives the time of a copy of its ``[E, H]``
    scores (``copy_ms``)."""
    from keras_geometric_tpu_torch.kernels import attend_cuda as A
    from keras_geometric_tpu_torch.kernels import sddmm_cuda as D
    from keras_geometric_tpu_torch.kernels import softmax_cuda as S
    from keras_geometric_tpu_torch.utils.profiling import (
        H100_BYTES_PER_S,
        H100_F32_OPS_PER_S,
    )

    gen = torch.Generator(device=device).manual_seed(9)
    entries = []
    for ctx_name, path, layer, heads, f, dtype in (
        ("gat_arxiv", "train_gat_arxiv_shape_composed", "layer 1",
         GAT_ARXIV_HEADS, GAT_ARXIV_DIMS[0], torch.bfloat16),
        ("gat_arxiv", "train_gat_arxiv_shape_composed", "layer 2",
         GAT_ARXIV_HEADS, GAT_ARXIV_DIMS[1], torch.bfloat16),
        ("citeseer", "train_gat_citeseer_shape_composed", "layer 1",
         GAT_CITESEER_HEADS, GAT_CITESEER_DIMS[0], torch.float32),
        ("citeseer", "train_gat_citeseer_shape_composed", "layer 2",
         GAT_CITESEER_HEADS, GAT_CITESEER_DIMS[1], torch.float32),
    ):
        ctx = contexts[ctx_name]
        n, e, d = ctx.num_nodes, ctx.senders.shape[0], heads * f
        recv, row_ptr, valid = ctx.receivers, ctx.row_ptr, ctx.edge_mask
        es = 2 if dtype == torch.bfloat16 else 4
        ht = (0.5 * torch.randn(n, d, generator=gen, device=device)).to(dtype)
        att = (0.3 * torch.randn(heads, f, generator=gen,
                                 device=device)).to(dtype)
        hj = ht.index_select(0, ctx.senders)  # the gather the path runs
        ds = torch.randn(e, heads, generator=gen, device=device).masked_fill(
            ~valid[:, None], 0.0)
        k7a = D.sddmm_scores_sorted(ht, hj, att, recv, row_ptr=row_ptr)
        # One score function in one lane layout (ROADMAP D9): the composed
        # path's scores are the fused forward's on every valid slot.
        _, k9, k9_m, k9_l = A.sddmm_stats_agg_sorted(
            ht, ctx.senders, recv, row_ptr, att, edge_valid=valid)
        check(torch.equal(k7a[valid], k9[valid]),
              f"sddmm_scores_sorted at {ctx_name} {layer}: the scores differ "
              f"from the fused forward's (K9's) on hj = ht[senders]")
        scores = k7a.masked_fill(~valid[:, None], float("-inf"))
        errs, m, l, _ = softmax_case(recv, row_ptr, n, scores, torch.float32,
                                     f"softmax at {ctx_name} {layer}")
        # One online step in slot order over the same pieces, one merge in
        # piece order (ROADMAP D13): the statistics of these scores are the
        # fused forward's on every row, split rows included.
        check(torch.equal(m, k9_m) and torch.equal(l, k9_l),
              f"softmax_stats_sorted at {ctx_name} {layer}: (m, l) differ "
              f"from the fused forward's (K9's) on its own scores")
        del k9, k9_m, k9_l
        errs.update(sddmm_case(recv, row_ptr, ht, hj, att, ds,
                               f"sddmm at {ctx_name} {layer}"))
        torch.cuda.empty_cache()
        index = e * 4
        score_bytes = e * heads * 4
        stats = 2 * n * heads * 4
        cases = {
            "softmax_stats_sorted": dict(
                kernel=lambda: S.softmax_stats_sorted(scores, recv, row_ptr,
                                                      n),
                plain=lambda: S.softmax_stats_sorted_plain(scores, recv, n),
                # scores read, row_ptr read, m and l written
                nbytes=score_bytes + (n + 1) * 4 + stats,
                no_reuse=None, ops=6 * e * heads),
            "softmax_apply_sorted": dict(
                kernel=lambda: S.softmax_apply_sorted(scores, m, l, recv),
                plain=lambda: S.softmax_apply_sorted_plain(scores, m, l,
                                                           recv),
                # scores and receivers read, m and l read, alpha written
                nbytes=2 * score_bytes + index + stats,
                no_reuse=2 * score_bytes + index + 2 * e * heads * 4,
                ops=3 * e * heads),
            "sddmm_scores_sorted": dict(
                kernel=lambda: D.sddmm_scores_sorted(ht, hj, att, recv,
                                                     row_ptr=row_ptr),
                plain=lambda: D.sddmm_scores_sorted_plain(ht, hj, att, recv),
                # ht and hj read, receivers, att, scores written
                nbytes=n * d * es + e * d * es + index + d * es
                + score_bytes,
                no_reuse=2 * e * d * es + index + d * es + score_bytes,
                ops=4 * e * d),
            "sddmm_bwd_sorted": dict(
                kernel=lambda: D.sddmm_bwd_sorted(ht, hj, att, ds, recv,
                                                  row_ptr=row_ptr),
                plain=lambda: D.sddmm_bwd_sorted_plain(ht, hj, att, ds,
                                                       recv),
                # ht, hj, receivers, att, ds read; d_pre and datt written
                nbytes=n * d * es + 2 * e * d * es + index + d * es
                + score_bytes + d * 4,
                no_reuse=3 * e * d * es + index + d * es + score_bytes
                + d * 4,
                ops=6 * e * d),
        }
        for name, case in cases.items():
            ms = timer.cold_ms(case["kernel"], iters=10)
            plain_ms = timer.cold_ms(case["plain"], iters=5, warmup=1)
            t_bytes = case["nbytes"] / H100_BYTES_PER_S * 1e3
            t_ops = case["ops"] / H100_F32_OPS_PER_S * 1e3
            entry = {
                "name": name, "route": "cuda",
                "source": SOURCES[REPLACES[name][0]],
                "replaces": replaces[name], "path": path,
                "shape": f"{ctx_name} {layer}: E={e} N={n} H={heads} F={f} "
                         f"{str(dtype)[6:]}",
                "launches": 0, "max_abs_err": errs[name], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None,
                "library": "none: no single PyTorch call computes this",
            }
            if case["no_reuse"] is not None:
                # Every row read per slot from device memory, none from
                # cache (ht rows for the score kernels, m and l rows for
                # the normalisation).
                entry["bound_ms_if_gather_not_reused"] = (
                    case["no_reuse"] / H100_BYTES_PER_S * 1e3)
            if name in COMPOSED_PIECE_KERNELS:
                entry.update(piece_fields(
                    row_ptr, D.BWD_SPLIT_PIECE
                    if name == "sddmm_bwd_sorted" else None))
                every, split = COMPOSED_PIECE_KERNELS[name]
                entry.update({
                    "cuda_kernels": list(every) + (
                        list(split) if entry["split_rows"] else []),
                    "parent_ms": None,
                    "parent": "not measured here: attend_kernels_ab.py "
                              "--only=composed times a parent copy beside "
                              "this one",
                })
            if name == "sddmm_scores_sorted":
                entry["valid_slots_equal_to_fused_forward"] = int(valid.sum())
            if name == "softmax_stats_sorted":
                entry["rows_equal_to_fused_forward"] = n
            if name == "softmax_apply_sorted":
                # The [E, H] f32 scores copied into a like tensor behind the
                # same flush: the byte rate the card reaches on a block of
                # this size, the normalisation's realistic floor.
                like = torch.empty_like(scores)
                entry["copy_ms"] = timer.cold_ms(lambda: like.copy_(scores),
                                                 iters=10)
                del like
            entries.append(entry)
        del hj, scores, cases
        torch.cuda.empty_cache()
    return entries


# ---------------------------------------------------------------------------
# The locality tier's kernels against their plain versions
# ---------------------------------------------------------------------------


def band_mass(x, band, base_idx, window, row_block):
    """Sum of ``|band * x|`` over each output element's terms."""
    from keras_geometric_tpu_torch.kernels import band_cuda as B

    return B.band_matmul_plain(x.float().abs(), band.float().abs(), base_idx,
                               window, row_block)


def plan_on(plan, device):
    """A plan (a dataclass of tensors and nested plans) with every tensor on
    ``device``."""
    moved = {}
    for field in dataclasses.fields(plan):
        value = getattr(plan, field.name)
        if isinstance(value, torch.Tensor):
            moved[field.name] = value.to(device)
        elif dataclasses.is_dataclass(value):
            moved[field.name] = plan_on(value, device)
    return dataclasses.replace(plan, **moved)


def window_scatter_f64(v, tab, plan):
    """The window scatter summed in f64 (a serial f32 sum of a hub row's
    thousands of terms drifts; the piece sums do not: ROADMAP D11)."""
    sel = tab >= 0
    out = torch.zeros(plan.num_windows * plan.window, v.shape[1],
                      dtype=torch.float64, device=v.device)
    return out.index_add_(0, tab[sel].long(), v[sel].double())


def window_scatter_mass(v, tab, plan):
    return window_scatter_f64(v.abs(), tab, plan).float()


def window_scatter_checked(v, tab, plan, what):
    """The window scatter's kernel, launched twice (the same bits), and held
    bit for bit against the row walk of the same sender-order list (the
    fused-gather scatter with ``pieces=False``) on every row of at most one
    piece's slots. Returns the first launch's output."""
    from keras_geometric_tpu_torch.kernels import band_cuda as B
    from keras_geometric_tpu_torch.kernels import spmm_cuda as K

    out = B.window_scatter_sum(v, tab, plan)
    check(torch.equal(out, B.window_scatter_sum(v, tab, plan)),
          f"{what}: two launches differ")
    rows = K.gather_scatter_sum_sorted(
        v, plan.scatter_idx, None, plan.scatter_row_ptr,
        plan.num_windows * plan.window, pieces=False)
    check_one_piece_rows_equal(out, rows, plan.scatter_row_ptr, what)
    return out


# Where a band entry's parent time comes from (PERF.md records it).
BAND_PARENT = ("not measured here: attend_kernels_ab.py build/parent . . "
               "build/parent --band times a parent copy beside this one")
BAND_GUARD = 64  # NaN values after a guarded band output's end


def band_guarded(route, x, args, what):
    """The band kernel on ``route`` into an output filled with NaN and
    followed by ``BAND_GUARD`` more NaN values, held against its plain
    version (so every element was written) with the values past its end
    left as they were. The output's rows are contiguous, so the guard shows
    that no column past F of the last row was written; a stray write past F
    of another row lands on the next row's first columns, where the
    comparison catches it only if it lands after the right value. ``x`` is
    read from a copy followed by NaN too, so a read past its end that
    reached the product would show in the comparison. Returns the largest
    error."""
    from keras_geometric_tpu_torch.kernels import band_cuda as B

    n, f = x.shape
    xbuf = torch.full((n * f + BAND_GUARD,), float("nan"), dtype=x.dtype,
                      device=x.device)
    x = xbuf[: n * f].view(n, f).copy_(x)
    buf = torch.full((n * f + BAND_GUARD,), float("nan"), dtype=x.dtype,
                     device=x.device)
    out = B._band_matmul_on(route, x, *args, out=buf[: n * f].view(n, f))
    err = compare(out, B.band_matmul_plain(x, *args), band_mass(x, *args),
                  x.dtype, f"{what} route={route}")
    check(bool(buf[n * f:].isnan().all()),
          f"{what} route={route}: written past the output's end")
    return err


def band_sweep(device):
    """The band kernel at every F of ``BAND_WIDTHS``, both types, every window
    of ``BAND_WINDOWS``, over a symmetric and a directed plan (its transposed
    plan too) of a local graph with one row block whose band is empty; at F
    = 7, 16 and 47, both types, row blocks of 128 and a window of 288 (the
    wmma route in bf16, slabs of 32 in f32) into guarded outputs; the
    window scatter at every F of ``SCATTER_WIDTHS``, both types, with a
    window that no chunk chose, a hub row of thousands of eligible slots and
    an all -1 table, held against its sum in f64, launched twice and against
    the row walk of its list (``window_scatter_checked``). Returns the number
    of comparisons and each kernel's worst error."""
    from keras_geometric_tpu_torch.kernels import band_cuda as B

    rng = np.random.default_rng(12)
    gen = torch.Generator(device=device).manual_seed(12)
    n, half, empty = 8_192, 60_000, 2_048  # rows [2048, 2304) get no edge
    worst = {name: 0.0 for name in B.LAUNCH_COUNTS}
    cases = 0
    for window in BAND_WINDOWS:
        r = rng.integers(0, n, half)
        r = np.where((r >= empty) & (r < empty + 256), r + 256, r)
        s = np.clip(r + rng.integers(-window // 2, window // 2, half), 0,
                    n - 1)
        s = np.where((s >= empty) & (s < empty + 256), s - 256, s)
        w = rng.uniform(0.05, 1.0, half).astype(np.float32)
        sym, _ = B.build_band_plan(np.concatenate([s, r]),
                                   np.concatenate([r, s]),
                                   np.concatenate([w, w]), n, window=window)
        fwd, local = B.build_band_plan(s, r, w, n, window=window)
        bwd, _ = B.build_band_plan(r, s, w, n, window=window)
        check(0 < local.sum() < local.shape[0],
              f"band sweep W={window}: the band must hold some edges")
        last_base = int(sym.base_idx[-1]) * (window // 2)
        check(last_base + window == n,
              f"band sweep W={window}: the last block's window must end at "
              f"n_pad (clamped)")
        for kind, plan in (("symmetric", sym), ("directed", fwd),
                           ("transposed", bwd)):
            base_idx = plan.base_idx.to(device)
            for dtype in (torch.float32, torch.bfloat16):
                band = plan.band.to(device, dtype)
                for f in BAND_WIDTHS:
                    x = torch.randn(n, f, generator=gen, device=device).to(
                        dtype)
                    args = (band, base_idx, window, plan.row_block)
                    out = B.band_matmul(x, *args)
                    ref = B.band_matmul_plain(x, *args)
                    worst["band_spmm"] = max(worst["band_spmm"], compare(
                        out, ref, band_mass(x, *args), dtype,
                        f"band_spmm {kind} W={window} {str(dtype)[6:]} "
                        f"F={f}"))
                    check(not out[empty:empty + 256].any().item(),
                          f"band_spmm W={window}: the empty block's rows")
                    cases += 1
    torch.cuda.synchronize()

    # The shapes the TMA kernel does not take (the wmma route in bf16) and
    # an f32 window that is not a multiple of 64 (slabs of 32 at NC = 16):
    # row blocks of 128 at W = 256, and W = 288, a dense band made here
    # (build_band_plan makes windows of a multiple of 256). Each goes
    # through band_route into a guarded output (band_guarded).
    r = rng.integers(0, n, half)
    s = np.clip(r + rng.integers(-128, 128, half), 0, n - 1)
    rb128, _ = B.build_band_plan(s, r, rng.uniform(0.05, 1.0, half), n,
                                 window=256, row_block=128)
    w288 = 288
    dense = rng.uniform(0.05, 1.0, (n, w288)) * (rng.random((n, w288)) < 0.05)
    base288 = np.clip((np.arange(n // 256) * 256 - 16) // (w288 // 2), 0,
                      (n - w288) // (w288 // 2))
    for band_h, base_h, window, rb in (
            (rb128.band, rb128.base_idx, 256, 128),
            (torch.from_numpy(dense.astype(np.float32)),
             torch.from_numpy(base288.astype(np.int32)), w288, 256)):
        base_idx = base_h.to(device)
        for dtype in (torch.float32, torch.bfloat16):
            band = band_h.to(device, dtype)
            for f in (7, 16, 47):
                route = B.band_route(f, window, rb, dtype)
                tag = f"band_spmm W={window} row_block={rb} " \
                      f"{str(dtype)[6:]} F={f}"
                check(route == ("fma" if dtype == torch.float32 else "wmma"),
                      f"{tag}: route {route}")
                x = torch.randn(n, f, generator=gen, device=device).to(dtype)
                before = B.MODE_LAUNCH_COUNTS[f"band_spmm({route})"]
                worst["band_spmm"] = max(worst["band_spmm"], band_guarded(
                    route, x, (band, base_idx, window, rb), tag))
                check(B.MODE_LAUNCH_COUNTS[f"band_spmm({route})"]
                      == before + 1, f"{tag}: one launch on {route}")
                cases += 1
    torch.cuda.synchronize()

    # Window scatter: senders near their receivers, window 3 never chosen,
    # the receivers of [4900, 5100) all sending from node 5000 (a row of
    # thousands of eligible slots, cut into many pieces).
    window, chunk = ATTEND_WINDOW, 2048
    e = 200_000
    recv = np.sort(rng.integers(0, n, e))
    send = np.clip(recv + rng.integers(-300, 300, e), 0, n - 1)
    far = rng.random(e) < 0.3
    send[far] = rng.integers(0, n, int(far.sum()))
    send = np.where(send // window == 3, send + window, send)
    send[(recv >= 4_900) & (recv < 5_100)] = 5_000
    e_pad = -(-e // chunk) * chunk
    send = np.concatenate([send, np.full(e_pad - e, n - 1)])
    plan, _, tab = B.build_window_scatter_plan(
        send, n, np.arange(e_pad) < e, window=window, edge_chunk=chunk)
    check(plan.work_chunk[plan.work_win == 3].tolist() == [0],
          "window scatter sweep: window 3 must be visited once, to zero it")
    plan = plan_on(plan, device)
    lengths = plan.scatter_row_ptr[1:] - plan.scatter_row_ptr[:-1]
    check(int(lengths.max()) > 1_000 and not lengths[3 * window:4 * window]
          .any().item(), "window scatter sweep: a hub row of more than "
          "1,000 eligible slots and an empty window")
    tab = torch.from_numpy(tab).to(device)
    none = torch.full_like(tab, -1)
    for dtype in (torch.float32, torch.bfloat16):
        for f in SCATTER_WIDTHS:
            v = torch.randn(e_pad, f, generator=gen, device=device).to(dtype)
            tag = f"window_scatter_sum {str(dtype)[6:]} F={f}"
            out = window_scatter_checked(v, tab, plan, tag)
            worst["window_scatter_sum"] = max(
                worst["window_scatter_sum"],
                compare(out, window_scatter_f64(v, tab, plan).to(dtype),
                        window_scatter_mass(v, tab, plan), dtype, tag))
            check(not out[3 * window:4 * window].any().item(),
                  f"{tag}: the unchosen window's rows must be zero")
            check(not B.window_scatter_sum(v, none, plan).any().item(),
                  f"{tag}: an all -1 table must give zeros")
            cases += 1
    torch.cuda.synchronize()
    try:
        B.band_matmul(x.double(), band.double(), base_idx, BAND_WINDOWS[-1],
                      256)
    except TypeError:
        pass
    else:
        check(False, "float64 data must be refused on a CUDA tensor")
    return cases, worst


def time_band_cases(device, timer, contexts, replaces):
    """The band kernel at the banded GCN runs' shapes (layer 1 forward at
    F = 128 and 100, layer 2 forward and backward at F = 40 and 47, bf16;
    and F = 7, which no run gives), each held against its plain version in
    a guarded output (``band_guarded``), a width that is not a multiple of 8
    also timed at the next one on the same route and on the ``wgmma`` one;
    and the window scatter at the banded GATv2 run's (H*F = 256 and 160,
    bf16): kernel, plain version, library call, bound from bytes and
    operations. The band's library call is ``torch.bmm`` over the row
    blocks with the ``x`` windows gathered beforehand (not timed); the
    scatter's is ``index_add_`` over the eligible slots, their rows gathered
    beforehand (not timed). Each entry of a run's shape also times, on the
    same reordered graph, the tier's whole share of the operator (band +
    residual fused gather; window scatter + residual finish) and what it
    replaces on the context without the tier (the fused gather over every
    edge; the finish over ``bwd_perm``)."""
    from keras_geometric_tpu_torch.kernels import band_cuda as B
    from keras_geometric_tpu_torch.utils.profiling import (
        H100_BF16_TENSOR_OPS_PER_S,
        H100_BYTES_PER_S,
        H100_F32_OPS_PER_S,
    )

    gen = torch.Generator(device=device).manual_seed(13)
    entries = []

    def entry(name, path, shape, err, kernel, plain, library, nbytes, ops,
              peak):
        ms = timer.cold_ms(kernel, iters=10)
        plain_ms = timer.cold_ms(plain, iters=5, warmup=1)
        library_ms = timer.cold_ms(library, iters=10)
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = ops / peak * 1e3
        return {
            "name": name, "route": "cuda",
            "source": SOURCES[REPLACES[name][0]],
            "replaces": replaces[name], "path": path, "shape": shape,
            "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
            "library": ("torch.bmm over the row blocks, x windows gathered "
                        "beforehand" if name == "band_spmm" else
                        "index_add_ over the eligible slots, their rows "
                        "gathered beforehand"),
        }

    from keras_geometric_tpu_torch.kernels import spmm_cuda as K

    ctx, plain_ctx = contexts["skewed"], contexts["skewed_plain"]
    plan = ctx.band
    n, window, rb = plan.n_pad, plan.window, plan.row_block
    nb = n // rb
    args = (plan.band, plan.base_idx, window, rb)
    rows = (plan.base_idx.long() * (window // 2))[:, None] + torch.arange(
        window, device=device)
    # The banded GCN's widths at the arxiv shape (x by its tensor map) and
    # at ogbn-products' (x by 1-D copies), then F = 7, which no run gives.
    for layer, f, path in (
            ("layer 1", ARXIV_FEATS, "train_skewed_arxiv_shape"),
            ("layers 2 and backward", ARXIV_CLASSES,
             "train_skewed_arxiv_shape"),
            ("products widths layer 1", PRODUCTS_FEATS,
             "train_skewed_products_widths"),
            ("products widths layer 2 and backward", PRODUCTS_CLASSES,
             "train_skewed_products_widths"),
            ("no run: F = 7", 7, None)):
        x = torch.randn(n, f, generator=gen, device=device).to(torch.bfloat16)
        route = B.band_route(f, window, rb, torch.bfloat16)
        err = band_guarded(route, x, args, f"band_spmm at skewed {layer}")
        windows = x.index_select(0, rows.reshape(-1)).view(nb, window, f)
        band3 = plan.band.view(nb, rb, window)
        entries.append(entry(
            "band_spmm", path,
            f"skewed {layer}: n_pad={n} W={window} F={f} bf16 "
            f"band edges={plan.num_edges} route={route}", err,
            lambda: B.band_matmul(x, *args),
            lambda: B.band_matmul_plain(x, *args),
            lambda: torch.bmm(band3, windows),
            # band once, x once, out once, base_idx
            n * window * 2 + 2 * n * f * 2 + nb * 4,
            2 * n * window * f, H100_BF16_TENSOR_OPS_PER_S))
        entries[-1].update(mode=route, parent_ms=None, parent=BAND_PARENT)
        del windows
        if padded_width(f) != f:
            # What the width costs: the same kernel at the next multiple of
            # 8 columns, and there also the route that reads x by its
            # tensor map.
            wide = torch.zeros(n, padded_width(f), dtype=x.dtype,
                               device=device)
            wide[:, :f] = x
            entries[-1].update(
                padded_width=wide.shape[1],
                ms_at_padded_width=timer.cold_ms(
                    lambda: B._band_matmul_on(route, wide, *args), iters=10),
                ms_at_padded_width_wgmma=timer.cold_ms(
                    lambda: B.band_matmul(wide, *args), iters=10))
            del wide
        if path is None:
            continue

        def residual(c):  # the GCN's operator: the row walk (ops/csr.py)
            return K.gather_scatter_sum_sorted(
                x, c.senders, c.receivers, c.row_ptr, n,
                weights=c.edge_weight, self_weight=c.self_weight,
                pieces=False)

        entries[-1]["tier_ms"] = timer.cold_ms(
            lambda: (B.band_matmul(x, *args), residual(ctx)), iters=10)
        entries[-1]["without_tier_ms"] = timer.cold_ms(
            lambda: residual(plain_ctx), iters=10)
        entries[-1]["without_tier"] = ("the fused gather over every edge of "
                                       "the same graph, no band")
    ctx, plain_ctx = contexts["gat_skewed"], contexts["gat_skewed_plain"]
    plan, tab = ctx.attw_plan, ctx.attw_sender
    sel = tab >= 0
    eligible = int(sel.sum())
    sel_senders = tab[sel].long()
    e = tab.shape[0]
    work = plan.scatter_work
    out_rows = plan.num_windows * plan.window
    split_rows = int(work.fix_rows.shape[0])
    for layer, d in (("layer 1", GAT_ARXIV_HEADS * GAT_ARXIV_DIMS[0]),
                     ("layer 2", GAT_ARXIV_HEADS * GAT_ARXIV_DIMS[1])):
        v = torch.randn(e, d, generator=gen, device=device).to(torch.bfloat16)
        what = f"window_scatter_sum at gat_skewed {layer}"
        err = compare(window_scatter_checked(v, tab, plan, what),
                      window_scatter_f64(v, tab, plan).to(v.dtype),
                      window_scatter_mass(v, tab, plan), torch.bfloat16,
                      what)
        v_sel = v[sel]
        entries.append(entry(
            "window_scatter_sum", "train_gat_skewed_arxiv_shape",
            f"gat_skewed {layer}: E_pad={e} eligible={eligible} "
            f"windows={plan.num_windows} W={plan.window} items="
            f"{plan.num_work} H*F={d} bf16", err,
            lambda: B.window_scatter_sum(v, tab, plan),
            lambda: B.window_scatter_sum_plain(v, tab, plan),
            lambda: torch.zeros(out_rows, d, dtype=v.dtype,
                                device=device).index_add_(0, sel_senders,
                                                          v_sel),
            # eligible rows of v once, sender_tab, out once, the reference's
            # item tables (the same yardstick whatever implements it)
            eligible * d * 2 + e * 4 + out_rows * d * 2
            + (plan.num_windows + 1 + plan.num_work) * 4,
            eligible * d, H100_F32_OPS_PER_S))
        entries[-1].update({
            "longest_row": longest_row(plan.scatter_row_ptr),
            "pieces": work.num_pieces, "split_rows": split_rows,
            "cuda_kernels": ["window_scatter_kernel"]
            + (["window_scatter_merge_kernel"] if split_rows else []),
            # What the kernel reads beside the bound's count: the
            # sender-order slot list, its row pointer, the pieces and the
            # split rows' tables.
            "table_bytes": (eligible + out_rows + 1) * 4
            + work.num_pieces * 16 + (2 * split_rows + 1) * 4,
            "ms_row_walk": timer.cold_ms(
                lambda: K.gather_scatter_sum_sorted(
                    v, plan.scatter_idx, None, plan.scatter_row_ptr,
                    out_rows, pieces=False), iters=10),
            "row_walk": "the fused-gather scatter's row walk over the same "
                        "sender-order list",
            "parent_ms": None,
            "parent": "not measured here: attend_kernels_ab.py "
                      "--only=window times a parent copy beside this one",
        })
        # v over the plain context's slots (same count up to the padding).
        v_plain = v[: plain_ctx.senders.shape[0]]
        entries[-1]["tier_ms"] = timer.cold_ms(
            lambda: (B.window_scatter_sum(v, tab, plan),
                     K.gather_scatter_sum_sorted(
                         v, ctx.attw_perm_res, ctx.attw_senders_res,
                         ctx.attw_res_row_ptr, ctx.num_nodes,
                         weights=ctx.attw_res_weight)), iters=10)
        entries[-1]["without_tier_ms"] = timer.cold_ms(
            lambda: K.gather_scatter_sum_sorted(
                v_plain, plain_ctx.bwd_perm, plain_ctx.senders_sorted,
                plain_ctx.row_ptr_bwd, plain_ctx.num_nodes), iters=10)
        entries[-1]["without_tier"] = ("the sender finish over bwd_perm on "
                                       "the same graph, no window tables")
        del v, v_sel, v_plain
    torch.cuda.empty_cache()
    return entries


def band_autograd_phase(device):
    """``GraphContext.spmm`` on a symmetric (densified) and a directed band
    context, and ``GraphContext.attend`` on an ``attend_window`` context, each
    against autograd over the plain versions (the band's plain product
    differentiated by autograd, so the transposed plan is not used there)."""
    import keras_geometric_tpu_torch as kgt
    from keras_geometric_tpu_torch.data.datasets import community_graph
    from keras_geometric_tpu_torch.ops import reorder

    n = 20_000
    ei = community_graph(n, 240_000, community_size=256, seed=3)
    s, r = ei[0].astype(np.int64), ei[1].astype(np.int64)
    inv = reorder.invert_order(reorder.cluster_order(s, r, n))
    sym = np.stack([inv[s], inv[r]])
    directed = sym[:, : sym.shape[1] // 2]  # one direction of each pair
    contexts = {
        "symmetric": kgt.prepare_graph(
            sym, n, add_self_loops=True, gcn_normalize=True, symmetric=True,
            densify_self_loops=True, pad_nodes=True, band_window=BAND_WINDOW,
            attend_full_stream=False, device=device),
        "directed": kgt.prepare_graph(
            directed, n, add_self_loops=True, gcn_normalize=True,
            pad_nodes=True, band_window=512, attend_full_stream=False,
            device=device),
    }
    gen = torch.Generator(device=device).manual_seed(14)
    results = {}
    for kind, ctx in contexts.items():
        check(ctx.num_band_edges > ctx.num_real_edges,
              f"band autograd ({kind}): the band must hold most edges")
        for dtype, f in ((torch.float32, 40), (torch.bfloat16, 128)):
            g_tol = 2e-4 if dtype == torch.float32 else 5e-2
            c = ctx.with_weight_dtype(dtype)
            h = torch.randn(c.num_nodes, f, generator=gen,
                            device=device).to(dtype)
            k_out, k_grad = grad_of(c.spmm, h)
            p_out, p_grad = grad_of(PlainContext(c).spmm, h)
            tag = f"band spmm/{kind}/{str(dtype)[6:]}/F{f}"
            for what, k, p in (("value", k_out, p_out),
                               ("gradient", k_grad, p_grad)):
                scale = max(p.float().abs().max().item(), 1e-6)
                err = (k.float() - p.float()).abs().max().item()
                check(math.isfinite(err) and err <= g_tol * scale,
                      f"{what} of {tag}: max abs err {err:.3e} against "
                      f"scale {scale:.3e}")
                results[f"{tag}/{what}"] = err / scale
    ctx = kgt.prepare_graph(sym, n, add_self_loops=True, pad_nodes=True,
                            attend_window=ATTEND_WINDOW, edge_chunk=512,
                            device=device)
    check(2 * ctx.attw_plan.num_band_edges > ctx.num_real_edges,
          "attend_window context: most slots must be window-eligible")
    e = ctx.senders.shape[0]
    for dtype, heads, f in ((torch.float32, 4, 40), (torch.bfloat16, 4, 64)):
        g_tol = 2e-4 if dtype == torch.float32 else 5e-2
        ht, att, gout, _ = attend_inputs(gen, ctx.num_nodes, heads, f, dtype,
                                         e, False, device)
        grads = []
        for fn in (ctx.attend, PlainContext(ctx).attend):
            a = ht.detach().clone().requires_grad_(True)
            b = att.detach().clone().requires_grad_(True)
            out = fn(a, b)
            out.backward(gout)
            grads.append((out.detach(), a.grad, b.grad))
        tag = f"attend_window/{str(dtype)[6:]}/H{heads}F{f}"
        for what, k, p in zip(("value", "d ht", "d att"), *grads):
            scale = max(p.float().abs().max().item(), 1e-6)
            err = (k.float() - p.float()).abs().max().item()
            check(math.isfinite(err) and err <= g_tol * scale,
                  f"{what} of {tag}: max abs err {err:.3e} against scale "
                  f"{scale:.3e}")
            results[f"{tag}/{what}"] = err / scale
    torch.cuda.synchronize()
    return results


# ---------------------------------------------------------------------------
# The segment max kernels against their plain versions
# ---------------------------------------------------------------------------


def tied_messages(gen, e, f, dtype, device):
    """ReLU'd messages rounded to halves: values repeat within rows, and a
    row whose messages are all <= 0 is tied at 0 in every column."""
    m = torch.randn(e, f, generator=gen, device=device) - 0.3
    return (torch.round(torch.relu(m) * 2) / 2).to(dtype)


def segment_max_sweep(device):
    """The narrow segment max at every K of ``SEGMENT_MAX_HEADS`` and the wide
    one, forward and both tie rules of its backward, at every F of
    ``SEGMENT_MAX_WIDTHS``, in bf16 and f32, with and without the slot mask,
    on the skewed graph (hub row, empty rows, padded slots). Forwards are
    held bit for bit (a max is order-free); the backward under the tolerance
    of the module docstring with the row's cotangent as mass. The wide inputs
    are tied (``tied_messages``), and the two rules must differ on them."""
    from keras_geometric_tpu_torch.kernels import spmm_cuda as K

    g = skewed_graph(device)
    n, e, recv, row_ptr = g["n"], g["e"], g["recv"], g["row_ptr"]
    gen = torch.Generator(device=device).manual_seed(17)
    worst = {"segment_max_sorted": 0.0, "segment_max_wide_sorted": 0.0,
             "segment_max_wide_bwd": 0.0}
    cases = 0
    empty = torch.zeros(n, dtype=torch.bool, device=device)
    empty[1:-1:2] = True  # every odd row but the last is empty
    for dtype in (torch.bfloat16, torch.float32):
        for mask in (None, g["mask"]):
            what = f"{str(dtype)[6:]}{' masked' if mask is not None else ''}"
            for k in SEGMENT_MAX_HEADS:
                for off in (0, 1):  # off: one element past an aligned start
                    flat = torch.randn(e * k + off, generator=gen,
                                       device=device).to(dtype)
                    scores = flat[off:].view(e, k)
                    got = K.segment_max_sorted(scores, recv, n,
                                               row_ptr=row_ptr, mask=mask)
                    check(torch.equal(got, K.segment_max_sorted_plain(
                        scores, recv, n, mask=mask)),
                        f"segment_max_sorted K={k} offset {off} {what}: "
                        f"differs from its plain version")
                    check(bool(torch.isinf(got[empty]).all()),
                          f"segment_max_sorted K={k} {what}: empty rows not "
                          f"-inf")
                    cases += 1
            for f in SEGMENT_MAX_WIDTHS:
                msgs = tied_messages(gen, e, f, dtype, device)
                gout = torch.randn(n, f, generator=gen, device=device)
                for empty_to_zero in (True, False):
                    fwd = K._segment_max_wide_fwd(msgs, recv, row_ptr, n,
                                                  mask, empty_to_zero)
                    want = K.segment_max_wide_raw_plain(
                        msgs, recv, n, mask=mask, empty_to_zero=empty_to_zero)
                    check(torch.equal(fwd, want),
                          f"segment_max_wide_sorted F={f} {what} "
                          f"empty_to_zero={empty_to_zero}: differs from its "
                          f"plain version")
                    cases += 1
                check(bool((want[empty] == K.NEG_SENTINEL).all()),
                      f"segment_max_wide F={f} {what}: empty rows not at the "
                      f"sentinel")
                mass = gout.abs().index_select(0, recv.long())
                grads = []
                for ties_split in (False, True):
                    got = K._segment_max_wide_bwd(msgs, want, gout, recv,
                                                  row_ptr, n, mask,
                                                  ties_split)
                    plain = K.segment_max_wide_bwd_plain(
                        msgs, want, gout, recv, n, mask=mask,
                        ties_split=ties_split)
                    worst["segment_max_wide_bwd"] = max(
                        worst["segment_max_wide_bwd"],
                        compare(got, plain, mass, dtype,
                                f"segment_max_wide_bwd F={f} {what} "
                                f"ties_split={ties_split}"))
                    grads.append(got)
                    cases += 1
                check(not torch.equal(*grads),
                      f"segment_max_wide F={f} {what}: the inputs hold no tie")
    torch.cuda.synchronize()
    return cases, worst


def time_segment_max_cases(device, timer, contexts, replaces):
    """The segment max kernels at the shapes their paths give them, on the
    arxiv-shaped GATv2 graph (1,505,280 slots, the GraphSAGE / GIN runs'
    context): the narrow one over ``[E, 4]`` scores in bf16 and f32
    (``segment_max_narrow_arxiv_shape``; with its work list and its times on
    ``skewed_graph`` with and without the 20,000-slot hub row,
    ``hub_row_ms``), the wide forward and its backward
    with the ties split over the two layers' bf16 messages (``[E, 128]``,
    ``[E, 256]``) of ``train_sage_pool_arxiv_shape``. Bound: every input
    byte read once and every output byte written once, over the memory
    rate; ``bound_ms_if_not_reused``: the backward's second read of the
    messages (it counts a row's ties first) from device memory too.
    ``library_ms``: ``torch.segment_reduce(data, "max", lengths=...)``, the
    one PyTorch call computing the forward (no mask); ``scatter_reduce_ms``:
    ``scatter_reduce("amax")`` into ``-inf`` rows. For the backward,
    ``library_ms`` is aten's backward of that call
    (``torch.ops.aten._segment_reduce_backward``, the cotangent in the
    messages' type, no mask), where it splits a tied row's cotangent evenly
    among its tied elements as the kernel does (``library_splits_ties``,
    checked here on the card: ``library_tie_check``); otherwise it computes
    another function and is left out (``None``). ``ms_ties_whole``: the same
    backward with every tied element given the whole cotangent (the public
    function's rule, one walk of the row fewer), on the same inputs: what
    counting the ties costs."""
    from keras_geometric_tpu_torch.kernels import spmm_cuda as K
    from keras_geometric_tpu_torch.utils.profiling import (
        H100_BYTES_PER_S,
        H100_F32_OPS_PER_S,
    )

    ctx = contexts["gat_arxiv"]
    n, e = ctx.num_nodes, int(ctx.receivers.shape[0])
    recv, row_ptr, mask = ctx.receivers, ctx.row_ptr, ctx.edge_mask
    lengths = (row_ptr[1:] - row_ptr[:-1]).long()
    index = recv.long()[:, None]
    gen = torch.Generator(device=device).manual_seed(21)
    entries = []
    index_bytes = e + (n + 1) * 4  # the mask and the row pointers
    # The narrow kernel on skewed_graph with its 20,000-slot hub row and
    # without it, [E, 4] scores with the slot mask.
    hub_ms = {"bfloat16": {}, "float32": {}}
    for label, hub in (("with_hub_row", 20_000), ("without_hub_row", 0)):
        g = skewed_graph(device, hub=hub)
        for dtype in (torch.bfloat16, torch.float32):
            sc = torch.randn(g["e"], GAT_ARXIV_HEADS, generator=gen,
                             device=device).to(dtype)
            hub_ms[str(dtype)[6:]][label] = {
                "slots": g["e"], "ms": timer.cold_ms(
                    lambda: K.segment_max_sorted(
                        sc, g["recv"], g["n"], row_ptr=g["row_ptr"],
                        mask=g["mask"]))}
        del g, sc

    def entry(name, path, shape, err, kernel, plain, library, scatter,
              nbytes, ops, not_reused=None,
              library_name='torch.segment_reduce(data, "max", lengths=...)'):
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = ops / H100_F32_OPS_PER_S * 1e3
        out = {
            "name": name, "route": "cuda",
            "source": SOURCES[REPLACES[name][0]],
            "replaces": replaces[name], "path": path, "shape": shape,
            "launches": 0, "max_abs_err": err, "ms": timer.cold_ms(kernel),
            "plain_ms": timer.cold_ms(plain, iters=10),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": (None if library is None
                           else timer.cold_ms(library, iters=10)),
            "library": None if library is None else library_name,
            "scatter_reduce_ms": (None if scatter is None
                                  else timer.cold_ms(scatter, iters=10)),
        }
        if not_reused is not None:
            out["bound_ms_if_not_reused"] = not_reused / H100_BYTES_PER_S * 1e3
        entries.append(out)

    for dtype in (torch.bfloat16, torch.float32):
        es = 2 if dtype == torch.bfloat16 else 4
        k = GAT_ARXIV_HEADS
        scores = torch.randn(e, k, generator=gen, device=device).to(dtype)
        got = K.segment_max_sorted(scores, recv, n, row_ptr=row_ptr,
                                   mask=mask)
        check(torch.equal(got, K.segment_max_sorted_plain(
            scores, recv, n, mask=mask)),
            "segment_max_sorted at the arxiv shape differs from its plain "
            "version")
        entry("segment_max_sorted", "segment_max_narrow_arxiv_shape",
              f"gat_arxiv scores: E={e} N={n} K={k} {str(dtype)[6:]} masked",
              0.0,
              lambda: K.segment_max_sorted(scores, recv, n, row_ptr=row_ptr,
                                           mask=mask),
              lambda: K.segment_max_sorted_plain(scores, recv, n, mask=mask),
              lambda: torch.segment_reduce(scores, "max", lengths=lengths,
                                           unsafe=True),
              lambda: torch.full((n, k), float("-inf"), dtype=dtype,
                                 device=device).scatter_reduce_(
                  0, index.expand(e, k), scores, "amax"),
              e * k * es + n * k * es + index_bytes, e * k)
        entries[-1].update(piece_fields(row_ptr, K.SPLIT_PIECE))
        entries[-1]["cuda_kernels"] = ["segment_max_sorted_kernel"]
        entries[-1]["hub_row_ms"] = hub_ms[str(dtype)[6:]]
        del scores, got
    aten_bwd = torch.ops.aten._segment_reduce_backward
    tie_check = library_max_backward_tie_check(device, recv, n, lengths, gen)
    for layer, f in (("layer 1", ARXIV_FEATS), ("layer 2", HIDDEN)):
        msgs = tied_messages(gen, e, f, torch.bfloat16, device)
        gout = torch.randn(n, f, generator=gen, device=device)
        fwd = K._segment_max_wide_fwd(msgs, recv, row_ptr, n, mask, True)
        check(torch.equal(fwd, K.segment_max_wide_raw_plain(
            msgs, recv, n, mask=mask, empty_to_zero=True)),
            f"segment_max_wide_sorted at arxiv {layer} differs from its "
            f"plain version")
        shape = (f"sage pooling arxiv {layer}: E={e} N={n} F={f} bfloat16 "
                 f"masked, tied")
        entry("segment_max_wide_sorted", "train_sage_pool_arxiv_shape",
              shape, 0.0,
              lambda: K._segment_max_wide_fwd(msgs, recv, row_ptr, n, mask,
                                              True),
              lambda: K.segment_max_wide_raw_plain(msgs, recv, n, mask=mask,
                                                   empty_to_zero=True),
              lambda: torch.segment_reduce(msgs, "max", lengths=lengths,
                                           unsafe=True),
              lambda: torch.full((n, f), float("-inf"), dtype=msgs.dtype,
                                 device=device).scatter_reduce_(
                  0, index.expand(e, f), msgs, "amax"),
              e * f * 2 + n * f * 4 + index_bytes, e * f)
        got = K._segment_max_wide_bwd(msgs, fwd, gout, recv, row_ptr, n, mask,
                                      True)
        plain = K.segment_max_wide_bwd_plain(msgs, fwd, gout, recv, n,
                                             mask=mask, ties_split=True)
        err = compare(got, plain, gout.abs().index_select(0, recv.long()),
                      msgs.dtype, f"segment_max_wide_bwd at arxiv {layer}")
        del got, plain
        nbytes = 2 * e * f * 2 + 2 * n * f * 4 + index_bytes
        lib_out = torch.segment_reduce(msgs, "max", lengths=lengths,
                                       unsafe=True)
        lib_gout = gout.to(msgs.dtype)
        aten_call = lambda: aten_bwd(lib_gout, lib_out, msgs, "max",
                                     lengths=lengths)
        entry("segment_max_wide_bwd", "train_sage_pool_arxiv_shape",
              shape + ", ties split", err,
              lambda: K._segment_max_wide_bwd(msgs, fwd, gout, recv, row_ptr,
                                              n, mask, True),
              lambda: K.segment_max_wide_bwd_plain(
                  msgs, fwd, gout, recv, n, mask=mask, ties_split=True),
              aten_call if tie_check["splits_ties"] else None,
              None, nbytes, 3 * e * f, not_reused=nbytes + e * f * 2,
              library_name="torch.ops.aten._segment_reduce_backward(g, "
                           'out, data, "max", lengths=...)')
        entries[-1]["library_splits_ties"] = tie_check["splits_ties"]
        entries[-1]["library_tie_check"] = tie_check
        # aten's backward timed all the same: where it does not split the
        # ties it computes another function, so it is no library_ms.
        entries[-1]["aten_segment_reduce_backward_ms"] = timer.cold_ms(
            aten_call, iters=10)
        del lib_out, lib_gout, aten_call
        entries[-1]["ms_ties_whole"] = timer.cold_ms(
            lambda: K._segment_max_wide_bwd(msgs, fwd, gout, recv, row_ptr, n,
                                            mask, False))
        del msgs, gout, fwd
    return entries


def library_max_backward_tie_check(device, recv, n, lengths, gen):
    """Whether aten's backward of ``torch.segment_reduce(..., "max")`` splits
    a tied row's cotangent evenly among its tied elements, per column, as
    K4's split rule does (ROADMAP F5), here on the card: on rows tied two,
    three and four ways under cotangents of +1 and of -1 (each share exact),
    and on tied messages at the arxiv GraphSAGE graph's rows (no mask,
    cotangents of both signs) against the kernel's plain version with the
    ties split, to one bf16 unit of its largest entry."""
    from keras_geometric_tpu_torch.kernels import spmm_cuda as K

    aten_bwd = torch.ops.aten._segment_reduce_backward
    data = torch.tensor([[1.0, 2.0], [1.0, 3.0], [0.0, 3.0], [5.0, 5.0],
                         [2.0, 2.0], [2.0, 2.0], [2.0, 1.0], [2.0, 2.0]],
                        device=device)
    small_lengths = torch.tensor([3, 1, 4], device=device)
    share = torch.tensor([[0.5, 0.0], [0.5, 0.5], [0.0, 0.5], [1.0, 1.0],
                          [0.25, 1 / 3], [0.25, 1 / 3], [0.25, 0.0],
                          [0.25, 1 / 3]], device=device)
    out = torch.segment_reduce(data, "max", lengths=small_lengths, unsafe=True)
    small_err = {}
    for sign in (1.0, -1.0):
        got = aten_bwd(torch.full_like(out, sign), out, data, "max",
                       lengths=small_lengths)
        small_err[f"{sign:+.0f}"] = (got - sign * share).abs().max().item()
    msgs = tied_messages(gen, int(recv.shape[0]), 64, torch.bfloat16, device)
    g = torch.randn(n, 64, generator=gen, device=device).to(torch.bfloat16)
    out = torch.segment_reduce(msgs, "max", lengths=lengths, unsafe=True)
    got = aten_bwd(g, out, msgs, "max", lengths=lengths).float()
    fwd = K.segment_max_wide_raw_plain(msgs, recv, n, empty_to_zero=True)
    plain = K.segment_max_wide_bwd_plain(msgs, fwd, g.float(), recv, n,
                                         ties_split=True).float()
    scale = plain.abs().max().item()
    err = (got - plain).abs().max().item()
    splits = (max(small_err.values()) <= 1e-6
              and err <= 2.0 ** -7 * scale)
    return {"splits_ties": splits, "small_rows_max_abs_err": small_err,
            "arxiv_rows_max_abs_err": err, "arxiv_rows_largest": scale}


def segment_max_narrow_phase(device, ctx, timer):
    """The narrow segment max over random ``[E, 4]`` scores (seed 19, bf16 and
    f32) on the arxiv-shaped GATv2 graph, with its slot mask: no module of
    either package calls it, so this phase is its path. The launch counts
    are read around those two calls alone. Each result is held bit for bit
    against the plain version, and on the rows with an unmasked slot against
    the softmax statistics kernel's ``m`` over the same scores (masked slots
    at ``-inf``). Then, outside those calls, the same on ``skewed_graph``
    with its 20,000-slot hub row and without it (empty rows, a masked padded
    tail): bit for bit against the plain version (the kernels line has its
    times there). Returns the counts."""
    from keras_geometric_tpu_torch.kernels import softmax_cuda as S
    from keras_geometric_tpu_torch.kernels import spmm_cuda as K

    gen = torch.Generator(device=device).manual_seed(19)
    n, e = ctx.num_nodes, int(ctx.receivers.shape[0])
    recv, row_ptr, mask = ctx.receivers, ctx.row_ptr, ctx.edge_mask
    inputs = [torch.randn(e, GAT_ARXIV_HEADS, generator=gen,
                          device=device).to(dtype)
              for dtype in (torch.bfloat16, torch.float32)]
    torch.cuda.synchronize()
    reset_launch_counts()
    outs = [K.segment_max_sorted(s, recv, n, row_ptr=row_ptr, mask=mask)
            for s in inputs]
    torch.cuda.synchronize()
    counts = launch_counts()
    check(counts["segment_max_sorted"] == 2 and sum(counts.values()) == 2,
          f"segment_max_narrow_arxiv_shape: launch counts {counts}")
    report = {}
    for scores, out in zip(inputs, outs):
        dtype = str(scores.dtype)[6:]
        check(out.shape == (n, GAT_ARXIV_HEADS) and out.dtype == scores.dtype,
              f"segment_max_narrow {dtype}: wrong shape or type")
        check(torch.equal(out, K.segment_max_sorted_plain(
            scores, recv, n, mask=mask)),
            f"segment_max_narrow {dtype}: differs from its plain version")
        s32 = scores.float().masked_fill(~mask[:, None], float("-inf"))
        m, _ = S.softmax_stats_sorted(s32, recv, row_ptr, n)
        rows = torch.isfinite(out.float()).all(1)
        check(torch.equal(out.float()[rows], m[rows]),
              f"segment_max_narrow {dtype}: differs from the softmax "
              f"statistics kernel's m on the rows with an unmasked slot")
        report[dtype] = {
            "rows_with_a_slot": int(rows.sum().item()),
            "equal_to_plain_and_to_softmax_m": True,
            "ms": timer.cold_ms(lambda: K.segment_max_sorted(
                scores, recv, n, row_ptr=row_ptr, mask=mask), iters=10)}
    for label, hub in (("with_hub_row", 20_000), ("without_hub_row", 0)):
        g = skewed_graph(device, hub=hub)
        for dtype in (torch.bfloat16, torch.float32):
            scores = torch.randn(g["e"], GAT_ARXIV_HEADS, generator=gen,
                                 device=device).to(dtype)
            args = (g["recv"], g["n"])
            kw = dict(row_ptr=g["row_ptr"], mask=g["mask"])
            out = K.segment_max_sorted(scores, *args, **kw)
            check(torch.equal(out, K.segment_max_sorted_plain(
                scores, *args, mask=g["mask"])),
                f"segment_max_narrow on skewed_graph {label} "
                f"{str(dtype)[6:]}: differs from its plain version")
            report[f"skewed_graph {label} {str(dtype)[6:]}"] = {
                "slots": g["e"], "longest_row": longest_row(g["row_ptr"]),
                "equal_to_plain": True}
        del g, scores, out
    emit("segment_max_narrow_arxiv_shape", launches=counts, slots=e,
         nodes=n, **report)
    return counts


# ---------------------------------------------------------------------------
# Plain contexts: the same operators through the kernels' plain versions,
# differentiated by autograd over PyTorch's own ops. For comparison only.
# ---------------------------------------------------------------------------


def row_blocks(row_ptr, block_slots):
    """``[(r0, r1, lo, hi)]``: the rows of a sorted stream (``row_ptr``
    ``[N + 1]``) cut into runs of whole rows ``[r0, r1)`` whose slots ``[lo,
    hi)`` number at most ``block_slots`` (a longer row makes a block of its
    own), in order, covering every row."""
    rp = row_ptr.cpu().numpy().astype(np.int64)
    n, blocks, r0 = rp.shape[0] - 1, [], 0
    while r0 < n:
        r1 = int(np.searchsorted(rp, rp[r0] + block_slots, side="right")) - 1
        r1 = min(max(r1, r0 + 1), n)
        blocks.append((r0, r1, int(rp[r0]), int(rp[r1])))
        r0 = r1
    return blocks


def blocked_plain(blocks, fn, kinds, checkpointed=False):
    """A plain version over a stream's blocks (``row_blocks``): ``fn(block)``
    returns its outputs from the block's slots alone. ``kinds`` says of each
    output whether it is per row (``"rows"``: the block's rows ``[r0, r1)``,
    cut out where ``fn`` gives every row), per slot (``"slots"``) or summed
    over the slots (``"sum"``: the blocks' parts added); one kind, one
    output. ``checkpointed``: each block under ``torch.utils.checkpoint``,
    so that the backward keeps no block's ``[slots, F]`` intermediates."""
    from torch.utils.checkpoint import checkpoint

    single = isinstance(kinds, str)
    kinds = (kinds,) if single else kinds

    def run(block):
        r0, r1 = block[:2]
        outs = fn(block)
        return tuple(
            out[r0:r1].clone() if kind == "rows" and out.shape[0] != r1 - r0
            else out for out, kind in zip((outs,) if single else outs, kinds))

    parts = [[] for _ in kinds]
    for block in blocks:
        outs = (checkpoint(run, block, use_reentrant=False) if checkpointed
                else run(block))
        for part, kind, out in zip(parts, kinds, outs):
            if kind == "sum" and part:
                part[0] = part[0] + out
            else:
                part.append(out)
    result = tuple(part[0] if kind == "sum" else torch.cat(part)
                   for part, kind in zip(parts, kinds))
    return result[0] if single else result


def spmm_rows(h, ctx, block, weights, self_weight, dtype):
    """Rows ``[r0, r1)`` of the plain ``spmm`` in ``dtype``:
    ``gather_scatter_sum_sorted_plain`` on the block's slots alone, then the
    rows' self term, added in f32 before the one rounding as the whole call
    adds it (the same terms in the same order into each row). ``h`` is the
    source in f32, so that the blocks' gradients add in f32 and are rounded
    once."""
    from keras_geometric_tpu_torch.kernels import spmm_cuda as K

    r0, r1, lo, hi = block
    out = K.gather_scatter_sum_sorted_plain(
        h.float(), ctx.senders[lo:hi], ctx.receivers[lo:hi] - r0, r1 - r0,
        weights=None if weights is None else weights[lo:hi])
    if self_weight is not None:
        out = out + h.float()[r0:r1] * self_weight[r0:r1].float()[:, None]
    return out.to(dtype)


class PlainContext:
    """The context's ops through the kernels' plain versions (library ops,
    differentiated by autograd), for step 1 against the kernels.

    ``block_slots``: ``spmm`` and ``attend`` run block by block over runs of
    whole receiver rows of at most that many slots (``row_blocks``), each
    block under ``torch.utils.checkpoint``, so that no ``[E, F]`` array
    exists whole in the forward or in the backward (ogbn-products' gather
    at F = 100 alone is 24.7 GB). Each row's arithmetic is the unblocked
    version's; the gradients add the blocks' parts in another order."""

    def __init__(self, ctx, block_slots=None):
        self.ctx = ctx
        self.self_weight = ctx.self_weight
        self.senders = ctx.senders
        self.bwd_perm = ctx.bwd_perm
        self.has_unit_weights = ctx.has_unit_weights
        self.block_slots = block_slots
        self.blocks = {}  # id of a stream's row_ptr -> its blocks

    def blockwise(self, stream, fn):
        """``fn(block)``, the block's rows, over every block of ``stream``'s
        rows under checkpoints, concatenated."""
        key = id(stream.row_ptr)
        if key not in self.blocks:
            self.blocks[key] = row_blocks(stream.row_ptr, self.block_slots)
        return blocked_plain(self.blocks[key], fn, "rows", checkpointed=True)

    # The per-edge stream's receivers, mask and node count (what a layer
    # reads from ``full_stream()`` for its library aggregators).
    @property
    def receivers(self):
        return self.ctx.full_stream().receivers

    @property
    def edge_mask(self):
        return self.ctx.full_stream().edge_mask

    @property
    def num_nodes(self):
        return self.ctx.full_stream().num_nodes

    def full_stream(self):
        return self

    def attend(self, ht, att, *, negative_slope=0.2, eps=1e-10,
               drop_mask=None, drop_mask_ss=None):
        # The same function in every mode: the sender-order twin of the
        # mask changes only how the kernels' backward is computed.
        del drop_mask_ss
        if self.block_slots is not None:
            stream = self.ctx.full_stream()
            ht32, att32 = ht.float(), att.float()
            return self.blockwise(stream, lambda block: attend_restated(
                stream, ht32, att32, drop_mask, negative_slope, eps,
                block=block, dtype=ht.dtype))
        return attend_restated(self.ctx.full_stream(), ht, att, drop_mask,
                               negative_slope, eps)

    def spmm(self, h):
        from keras_geometric_tpu_torch.kernels import band_cuda as B
        from keras_geometric_tpu_torch.kernels import spmm_cuda as K

        c = self.ctx
        if self.block_slots is not None:
            check(c.band is None, "the blocked plain spmm takes no band")
            h32 = h.float()
            return self.blockwise(c, lambda block: spmm_rows(
                h32, c, block, c.edge_weight, c.self_weight, h.dtype))
        out = K.gather_scatter_sum_sorted_plain(
            h, c.senders, c.receivers, c.num_nodes, weights=c.edge_weight,
            self_weight=c.self_weight)
        if c.band is not None:  # the band's product, differentiated by autograd
            out = out + B.band_matmul_plain(
                h, c.band.band, c.band.base_idx, c.band.window,
                c.band.row_block)
        return out

    def gather(self, h):
        # f64 inside: autograd's index_select backward sums in the data's
        # type, serially in effect (atomics), and an f32 serial sum of a hub
        # row's equal cotangents drifts by units where the kernel's sum in
        # pieces does not
        return h.double().index_select(0, self.ctx.senders).to(h.dtype)

    def sddmm_scores(self, ht, hj, att, *, negative_slope=0.2):
        from keras_geometric_tpu_torch.kernels import sddmm_cuda as D

        return D.sddmm_scores_sorted_plain(
            ht, hj, att, self.ctx.full_stream().receivers,
            negative_slope=negative_slope)

    def edge_softmax(self, scores, *, eps=1e-10):
        return edge_softmax_restated(self.ctx.full_stream(), scores, eps)

    def scatter(self, messages, *, masked=False):
        from keras_geometric_tpu_torch.kernels import spmm_cuda as K

        c = self.ctx
        return K.scatter_sum_sorted_plain(
            messages, c.receivers, c.num_nodes,
            mask=c.edge_mask if masked else None)

    def scatter_weighted(self, messages):
        from keras_geometric_tpu_torch.kernels import spmm_cuda as K

        c = self.ctx
        return K.scatter_sum_sorted_plain(
            messages, c.receivers, c.num_nodes, weights=c.edge_weight)

    def spmm_mean(self, h):
        deg = self.ctx.in_degree.clamp_min(1e-8).to(h.dtype)
        return self.spmm(h) / deg[:, None]

    def scatter_mean(self, messages, *, masked=True):
        deg = self.ctx.in_degree.clamp_min(1e-8)
        total = self.scatter(messages, masked=masked)
        return total / deg.to(total.dtype)[:, None]

    def scatter_max(self, messages):
        # PyTorch's scatter_reduce("amax"), whose gradient splits a tied
        # row's cotangent as the kernel's split rule does; f32 inside.
        from keras_geometric_tpu_torch.ops import segment

        c = self.ctx.full_stream()
        return segment.segment_max(messages.float(), c.receivers,
                                   c.num_nodes, mask=c.edge_mask).to(
            messages.dtype)


def grad_of(fn, arg):
    arg = arg.detach().clone().requires_grad_(True)
    out = fn(arg)
    (torch.tanh(out.float()) * 0.5).sum().backward()
    return out.detach(), arg.grad


def autograd_phase(device):
    import keras_geometric_tpu_torch as kgt

    rng = np.random.default_rng(3)
    n, half = 20_000, 60_000
    # Skewed degrees: one endpoint drawn from a heavy-tailed distribution.
    a = np.minimum(rng.zipf(1.6, half) - 1, n - 1)
    b = rng.integers(0, n, half)
    sym = np.stack([np.concatenate([a, b]), np.concatenate([b, a])])
    contexts = {
        "symmetric": kgt.prepare_graph(
            sym, n, add_self_loops=True, gcn_normalize=True, symmetric=True,
            densify_self_loops=True, pad_nodes=True, device=device),
        "general": kgt.prepare_graph(
            np.stack([a, b]), n, add_self_loops=True, gcn_normalize=True,
            device=device),
    }
    gen = torch.Generator(device=device).manual_seed(4)
    results = {}
    for dtype, f in ((torch.float32, 40), (torch.bfloat16, 128),
                     (torch.float32, 7)):
        g_tol = 2e-4 if dtype == torch.float32 else 5e-2
        for kind, ctx in contexts.items():
            if dtype == torch.bfloat16:
                ctx = ctx.with_weight_dtype(dtype)
            plain = PlainContext(ctx)
            h = torch.randn(ctx.num_nodes, f, generator=gen,
                            device=device).to(dtype)
            ops = [("spmm", ctx.spmm, plain.spmm, h)]
            if kind == "general" and dtype == torch.float32:
                # (autograd's own index_select backward accumulates in the
                # data's type, so bf16 has no trustworthy plain gradient)
                m = torch.randn(ctx.receivers.shape[0], f, generator=gen,
                                device=device).to(dtype)
                ops += [
                    ("gather", ctx.gather, plain.gather, h),
                    ("scatter_weighted", ctx.scatter_weighted,
                     plain.scatter_weighted, m),
                ]
            for op, kernel_fn, plain_fn, arg in ops:
                k_out, k_grad = grad_of(kernel_fn, arg)
                p_out, p_grad = grad_of(plain_fn, arg)
                scale = p_grad.float().abs().max().item()
                err = (k_grad.float() - p_grad.float()).abs().max().item()
                check(math.isfinite(err) and err <= g_tol * max(scale, 1e-6),
                      f"gradient of {op} ({kind}, {dtype}, F={f}): max abs "
                      f"err {err:.3e} against scale {scale:.3e}")
                o_scale = p_out.float().abs().max().item()
                o_err = (k_out.float() - p_out.float()).abs().max().item()
                check(o_err <= g_tol * max(o_scale, 1e-6),
                      f"value of {op} ({kind}, {dtype}, F={f})")
                results[f"{op}/{kind}/{str(dtype)[6:]}/F{f}"] = err / max(
                    scale, 1e-6)
    # GraphContext.attend: the hand-written backward (rho, receiver backward
    # and the sender finish) against autograd over the restatement, in every
    # combination of the two module constants; with dropout in send mode
    # with the sender-order mask (the sender backward runs) and without it
    # (the permute finish runs). The restatement computes in f32 from the
    # same (bf16-rounded) inputs, so its gradients are trustworthy in both
    # types.
    from keras_geometric_tpu_torch.kernels import attend_cuda

    ctx = contexts["general"]
    e = ctx.senders.shape[0]
    check(ctx.edge_mask_ss is not None, "autograd: the stream has no pads")
    for dtype, heads, f in ((torch.float32, 4, 40), (torch.bfloat16, 4, 64),
                            (torch.float32, 8, 6)):
        g_tol = 2e-4 if dtype == torch.float32 else 5e-2
        for dropped in (False, True):
            ht, att, gout, drop = attend_inputs(gen, ctx.num_nodes, heads, f,
                                                dtype, e, dropped, device)
            drop_ss = (None if drop is None
                       else drop.index_select(0, ctx.bwd_perm.long()))

            def value_and_grads(fn, **kw):
                a = ht.detach().clone().requires_grad_(True)
                b = att.detach().clone().requires_grad_(True)
                out = fn(a, b, drop_mask=drop, **kw)
                out.backward(gout)
                return out.detach(), a.grad, b.grad

            plain = value_and_grads(PlainContext(ctx).attend)
            combos = [(mode, cache, drop_ss)
                      for mode in ("permute", "send")
                      for cache in (True, False)]
            if dropped:  # the fallback: a mask without its twin
                combos.append(("send", True, None))
            for mode, cache, twin in combos:
                with attend_modes(mode, cache):
                    before = attend_cuda.LAUNCH_COUNTS[
                        "attend_send_bwd_sorted"]
                    got = value_and_grads(ctx.attend, drop_mask_ss=twin)
                    sent = attend_cuda.LAUNCH_COUNTS[
                        "attend_send_bwd_sorted"] - before
                use_send = mode == "send" and (drop is None
                                               or twin is not None)
                check(sent == int(use_send),
                      f"attend ({mode}, cache={cache}): the sender backward "
                      f"ran {sent} times")
                tag = (f"attend/{mode}/{'cache' if cache else 'nocache'}/"
                       f"{str(dtype)[6:]}/H{heads}F{f}"
                       f"{'/dropout' if dropped else ''}"
                       f"{'/no_twin' if dropped and twin is None else ''}")
                for what, k, p in zip(("value", "d ht", "d att"), got,
                                      plain):
                    scale = max(p.float().abs().max().item(), 1e-6)
                    err = (k.float() - p.float()).abs().max().item()
                    check(math.isfinite(err) and err <= g_tol * scale,
                          f"{what} of {tag}: max abs err {err:.3e} against "
                          f"scale {scale:.3e}")
                    results[f"{tag}/{what}"] = err / scale
    torch.cuda.synchronize()
    return results


def composed_autograd_phase(device, citeseer):
    """``GraphContext.sddmm_scores`` (d ht, d hj, d att) and
    ``GraphContext.edge_softmax`` through the kernels against autograd over
    their restatements in library ops; then ``return_attention=True`` on the
    CiteSeer-shaped context: alpha is 0 on padded slots, sums to 1 on every
    row with an edge, and ``out`` is the fused path's."""
    import keras_geometric_tpu_torch as kgt

    rng = np.random.default_rng(10)
    n = 20_000
    edges = np.stack([np.minimum(rng.zipf(1.6, 120_000) - 1, n - 1),
                      rng.integers(0, n, 120_000)])
    ctx = kgt.prepare_graph(edges, n, add_self_loops=True, device=device)
    plain = PlainContext(ctx)
    e = ctx.senders.shape[0]
    gen = torch.Generator(device=device).manual_seed(11)
    results = {}
    for dtype, heads, f in ((torch.float32, 4, 40), (torch.bfloat16, 4, 64),
                            (torch.float32, 8, 6)):
        g_tol = 2e-4 if dtype == torch.float32 else 5e-2
        ht, hj, att, _ = sddmm_inputs(gen, n, e, heads, f, dtype,
                                      ctx.edge_mask, device)
        grads = []
        for fn in (ctx.sddmm_scores, plain.sddmm_scores):
            args = [t.detach().clone().requires_grad_(True)
                    for t in (ht, hj, att)]
            out = fn(*args)
            (torch.tanh(out.float()) * 0.5).sum().backward()
            grads.append((out.detach(), *(a.grad for a in args)))
        tag = f"sddmm_scores/{str(dtype)[6:]}/H{heads}F{f}"
        for what, k, p in zip(("value", "d ht", "d hj", "d att"), *grads):
            scale = max(p.float().abs().max().item(), 1e-6)
            err = (k.float() - p.float()).abs().max().item()
            check(math.isfinite(err) and err <= g_tol * scale,
                  f"{what} of {tag}: max abs err {err:.3e} against scale "
                  f"{scale:.3e}")
            results[f"{tag}/{what}"] = err / scale
    for k in SOFTMAX_HEADS:
        scores = masked_scores(gen, e, k, ctx.edge_mask, device)
        k_out, k_grad = grad_of(ctx.edge_softmax, scores)
        p_out, p_grad = grad_of(plain.edge_softmax, scores)
        for what, a, b in (("value", k_out, p_out), ("d scores", k_grad,
                                                     p_grad)):
            scale = max(b.abs().max().item(), 1e-6)
            err = (a - b).abs().max().item()
            check(math.isfinite(err) and err <= 2e-4 * scale,
                  f"{what} of edge_softmax K={k}: max abs err {err:.3e} "
                  f"against scale {scale:.3e}")
            results[f"edge_softmax/K{k}/{what}"] = err / scale

    ctx, x = citeseer[0], citeseer[1]
    layer = kgt.GATv2Conv.for_context(
        GAT_CITESEER_DIMS[0], input_dim=CITESEER["feats"],
        heads=GAT_CITESEER_HEADS,
        generator=torch.Generator(device=device).manual_seed(0),
        device=device).eval()
    with torch.no_grad():
        fused = layer(x, context=ctx)
        out, alpha = layer(x, context=ctx, return_attention=True)
    check(alpha.shape == (ctx.senders.shape[0], GAT_CITESEER_HEADS) and
          alpha.dtype == torch.float32, "return_attention: alpha's shape")
    check(not alpha[~ctx.edge_mask].any().item(),
          "return_attention: alpha must be 0 on padded slots")
    sums = torch.zeros(ctx.num_nodes, GAT_CITESEER_HEADS,
                       device=device).index_add_(0, ctx.receivers.long(),
                                                 alpha)
    rows = ctx.in_degree > 0
    sum_err = (sums[rows] - 1.0).abs().max().item()
    check(sum_err <= 1e-5, f"return_attention: rows sum to 1 within "
          f"{sum_err:.3e}")
    scale = fused.abs().max().item()
    out_err = (out - fused).abs().max().item()
    check(out_err <= 2e-4 * scale, f"return_attention: out differs from the "
          f"fused path's by {out_err:.3e} (scale {scale:.3e})")
    results["return_attention/row_sum_err"] = sum_err
    results["return_attention/out_vs_fused"] = out_err / scale
    torch.cuda.synchronize()
    return results


def gin_sage_autograd_phase(device):
    """``GINConv`` (sum, mean, max) and ``SAGEConv`` (all six aggregators) on
    a CUDA context, forward and gradients (parameters and features), against
    the same layer on ``PlainContext`` (the plain versions, differentiated by
    autograd over library ops), in f32 and bf16, on tied inputs: ReLU'd
    features rounded to halves, and pooling biases shifted down so that
    whole rows of pooled messages are 0. The max, min and pooling layers
    must have launched the wide segment max and its backward with the ties
    split. Then ``GATv2Conv`` with two heads of 320 columns on a context (the
    attention kernels' wide instantiations) against the plain path the same
    way. Tolerances: outputs 1e-4 (f32) / 2e-2 (bf16) and gradients 2e-4 /
    5e-2 of their largest entry."""
    import keras_geometric_tpu_torch as kgt
    from keras_geometric_tpu_torch.kernels import spmm_cuda as K

    rng = np.random.default_rng(23)
    n, e, f_in, f_out = 3_000, 24_000, 48, 40
    edges = np.stack([rng.integers(0, n, e), rng.integers(0, n - 50, e)])
    edges[1, :3_000] = 7  # a hub row
    ctx = kgt.prepare_graph(edges.astype(np.int32), n, device=device)
    x_np = np.round(np.maximum(rng.standard_normal((n, f_in)), 0) * 2) / 2
    results = {}

    def run(layer, x, context):
        layer.zero_grad(set_to_none=True)
        x = x.detach().clone().requires_grad_(True)
        out = layer(x, context=context)
        (torch.tanh(out.float()) * 0.5).sum().backward()
        return out.detach(), x.grad, {k: p.grad.detach().clone()
                                      for k, p in layer.named_parameters()}

    def held(name, layer, x, dtype, max_path, context):
        K.reset_launch_counts()
        got = run(layer, x, context)
        torch.cuda.synchronize()
        counts = dict(K.LAUNCH_COUNTS)
        want = run(layer, x, PlainContext(context))
        o_tol, g_tol = ((1e-4, 2e-4) if dtype == torch.float32
                        else (2e-2, 5e-2))
        worst = 0.0
        pairs = [("out", got[0], want[0], o_tol), ("d x", got[1], want[1],
                                                   g_tol)]
        pairs += [(f"d {k}", got[2][k], want[2][k], g_tol) for k in got[2]]
        for what, a, b, tol in pairs:
            # The std's square root has a NaN gradient where a row's
            # variance is 0 (a tie), in both packages: the same places.
            a, b = a.float(), b.float()
            check(torch.equal(torch.isnan(a), torch.isnan(b)),
                  f"{name}: {what} NaN at other places than the plain path's")
            a, b = torch.nan_to_num(a), torch.nan_to_num(b)
            scale = b.abs().max().item()
            err = (a - b).abs().max().item()
            check(math.isfinite(err) and err <= tol * max(scale, 1e-12),
                  f"{name}: {what} err {err:.3e} against scale {scale:.3e}")
            worst = max(worst, err / max(scale, 1e-12))
        if max_path:
            check(counts["segment_max_wide_sorted"] >= 1 and
                  counts["segment_max_wide_bwd"] >= 1 and
                  K.MODE_LAUNCH_COUNTS["segment_max_wide_bwd(ties_split)"]
                  >= 1, f"{name}: the segment max kernels did not run "
                        f"({counts})")
        results[name] = worst

    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(x_np.astype(np.float32)).to(device).to(dtype)
        tag = str(dtype)[6:]
        for agg in ("sum", "mean", "max"):
            gen = torch.Generator(device=device).manual_seed(1)
            layer = kgt.GINConv(f_out, input_dim=f_in, mlp_hidden=(32,),
                                aggregator=agg, train_eps=True,
                                generator=gen, device=device).to(dtype)
            held(f"GINConv {agg} {tag}", layer, x, dtype, agg == "max", ctx)
        for agg in ("mean", "max", "sum", "min", "std", "pooling"):
            gen = torch.Generator(device=device).manual_seed(2)
            layer = kgt.SAGEConv(f_out, input_dim=f_in, aggregator=agg,
                                 generator=gen, device=device)
            if agg == "pooling":
                with torch.no_grad():
                    layer.pool_mlp.bias.fill_(-0.4)
            held(f"SAGEConv {agg} {tag}", layer.to(dtype), x, dtype,
                 agg in ("max", "min", "pooling"), ctx)
        gen = torch.Generator(device=device).manual_seed(3)
        gat_ctx = kgt.prepare_graph(edges.astype(np.int32), n,
                                    add_self_loops=True, device=device)
        layer = kgt.GATv2Conv(320, input_dim=f_in, heads=2,
                              add_self_loops=False, generator=gen,
                              device=device).to(dtype)
        held(f"GATv2Conv heads=2 F=320 {tag}", layer, x, dtype, False,
             gat_ctx)
    return results


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def arxiv_arrays(symmetric: bool):
    """The uniform arxiv-shaped graph's features, edges and labels, rebuilt
    with numpy from seed 0."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((ARXIV_NODES, ARXIV_FEATS)).astype(np.float32)
    half = ARXIV_EDGES // 2
    a = rng.integers(0, ARXIV_NODES, half).astype(np.int32)
    b = rng.integers(0, ARXIV_NODES, half).astype(np.int32)
    y = rng.integers(0, ARXIV_CLASSES, ARXIV_NODES).astype(np.int64)
    if symmetric:
        edges = np.stack([np.concatenate([a, b]), np.concatenate([b, a])])
    else:  # same edge count, direction kept: A != A^T
        c = rng.integers(0, ARXIV_NODES, half).astype(np.int32)
        d = rng.integers(0, ARXIV_NODES, half).astype(np.int32)
        edges = np.stack([np.concatenate([a, c]), np.concatenate([b, d])])
    return x, edges, y


def arxiv_workload(device, symmetric: bool):
    """The uniform arxiv-shaped workload, rebuilt with numpy from seed 0."""
    import keras_geometric_tpu_torch as kgt

    x, edges, y = arxiv_arrays(symmetric)
    start = time.perf_counter()
    ctx = kgt.prepare_graph(
        edges, ARXIV_NODES, add_self_loops=True, gcn_normalize=True,
        symmetric=symmetric, densify_self_loops=True, pad_nodes=True,
        device=device,
    )
    prepare_s = time.perf_counter() - start
    n_pad = ctx.num_nodes
    x = np.pad(x, ((0, n_pad - ARXIV_NODES), (0, 0)))
    y = np.pad(y, (0, n_pad - ARXIV_NODES))
    mask = np.arange(n_pad) < ARXIV_NODES
    dev = lambda arr: torch.from_numpy(arr).to(device)
    return ctx.with_weight_dtype(torch.bfloat16), dev(x), dev(y), dev(mask), \
        prepare_s


class CoraGCN(torch.nn.Module):
    """The canonical example's model: dropout on the first layer only."""

    def __init__(self, in_dim, hidden, classes, dropout, generator, device):
        from keras_geometric_tpu_torch import GCNConv

        super().__init__()
        self.conv1 = GCNConv.for_context(
            hidden, input_dim=in_dim, dropout_rate=dropout,
            generator=generator, device=device)
        self.conv2 = GCNConv.for_context(
            classes, input_dim=hidden, generator=generator, device=device)

    def forward(self, x, edge_index=None, *, context=None, generator=None):
        h = self.conv1(x, context=context, generator=generator)
        return self.conv2(torch.relu(h), context=context)


def cora_workload(device, gcn=True):
    """The Cora-shaped graph; ``gcn``: with the GCN's self-loops and
    normalisation folded into the context (otherwise the plain edges, as
    GraphSAGE takes them)."""
    import keras_geometric_tpu_torch as kgt

    rng = np.random.default_rng(0)
    n, pairs, feats, classes = 2_708, 5_278, 1_433, 7
    a = rng.integers(0, n, pairs)
    b = rng.integers(0, n, pairs)
    edges = np.stack([np.concatenate([a, b]), np.concatenate([b, a])])
    x = (rng.random((n, feats)) < 0.02).astype(np.float32)  # sparse bag of words
    y = (x @ rng.standard_normal((feats, classes))).argmax(1).astype(np.int64)
    mask = rng.random(n) < 0.5
    ctx = kgt.prepare_graph(edges, n, add_self_loops=gcn, gcn_normalize=gcn,
                            device=device)
    dev = lambda arr: torch.from_numpy(arr).to(device)
    return ctx, dev(x), dev(y), dev(mask)


def gat_arxiv_arrays():
    """The reference suite's arxiv-sized GATv2 graph (random directed edges;
    the self-loops are added at preparation), rebuilt with numpy from seed
    0: features, edges, labels."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((ARXIV_NODES, ARXIV_FEATS)).astype(np.float32)
    edges = np.stack([rng.integers(0, ARXIV_NODES, GAT_ARXIV_EDGES),
                      rng.integers(0, ARXIV_NODES, GAT_ARXIV_EDGES)])
    y = rng.integers(0, ARXIV_CLASSES, ARXIV_NODES).astype(np.int64)
    return x, edges.astype(np.int32), y


def gat_arxiv_workload(device):
    """The reference suite's arxiv-sized GATv2 workload: random directed
    edges plus one self-loop per node."""
    import keras_geometric_tpu_torch as kgt

    x, edges, y = gat_arxiv_arrays()
    start = time.perf_counter()
    ctx = kgt.prepare_graph(edges, ARXIV_NODES,
                            add_self_loops=True, device=device)
    prepare_s = time.perf_counter() - start
    dev = lambda arr: torch.from_numpy(arr).to(device)
    mask = np.ones(ARXIV_NODES, bool)
    return ctx, dev(x), dev(y), dev(mask), prepare_s


def skewed_graph_edges():
    """bench.py's skewed workload, rebuilt with numpy from seed 0: a
    scrambled community graph of arxiv's size, relabelled by the LPA cluster
    order, with features and labels following the relabelling."""
    from keras_geometric_tpu_torch.data.datasets import community_graph
    from keras_geometric_tpu_torch.ops import reorder

    rng = np.random.default_rng(0)
    x = rng.standard_normal((ARXIV_NODES, ARXIV_FEATS)).astype(np.float32)
    start = time.perf_counter()
    ei = community_graph(ARXIV_NODES, SKEWED_EDGES, seed=0)
    generate_s = time.perf_counter() - start
    s, r = ei[0].astype(np.int64), ei[1].astype(np.int64)
    start = time.perf_counter()
    order = reorder.cluster_order(s, r, ARXIV_NODES)
    order_s = time.perf_counter() - start
    inv = reorder.invert_order(order)
    y = rng.integers(0, ARXIV_CLASSES, ARXIV_NODES).astype(np.int64)
    edges = np.stack([inv[s], inv[r]])
    return dict(edges=edges, x=x[order], y=y[order], generate_s=generate_s,
                cluster_order_s=order_s,
                coverage=reorder.band_coverage(edges[0], edges[1],
                                               windows=(BAND_WINDOW,)),
                coverage_scrambled=reorder.band_coverage(
                    s, r, windows=(BAND_WINDOW,)))


def prepared_on(device, graph, **kwargs):
    """``prepare_graph`` over the skewed graph, with its host seconds, and
    the features, labels and loss mask padded to the context's node count."""
    import keras_geometric_tpu_torch as kgt

    start = time.perf_counter()
    ctx = kgt.prepare_graph(graph["edges"], ARXIV_NODES, device=device,
                            **kwargs)
    prepare_s = time.perf_counter() - start
    n_pad = ctx.num_nodes
    x = np.pad(graph["x"], ((0, n_pad - ARXIV_NODES), (0, 0)))
    y = np.pad(graph["y"], (0, n_pad - ARXIV_NODES))
    mask = np.arange(n_pad) < ARXIV_NODES
    dev = lambda arr: torch.from_numpy(arr).to(device)
    return ctx, dev(x), dev(y), dev(mask), prepare_s


def products_widths_on(prepared):
    """A skewed-graph context with random features of ogbn-products' width
    and labels of its classes (numpy, seed 0) on its padded rows, and its
    loss mask."""
    ctx, x, _, mask = prepared[:4]
    rng = np.random.default_rng(0)
    feats = np.zeros((ctx.num_nodes, PRODUCTS_FEATS), np.float32)
    feats[:ARXIV_NODES] = rng.standard_normal((ARXIV_NODES, PRODUCTS_FEATS))
    labels = np.zeros(ctx.num_nodes, np.int64)
    labels[:ARXIV_NODES] = rng.integers(0, PRODUCTS_CLASSES, ARXIV_NODES)
    dev = lambda arr: torch.from_numpy(arr).to(x.device)
    return ctx, dev(feats), dev(labels), mask


def citeseer_workload(device):
    """The canonical attention example's shape: a symmetric citation-sized
    graph, sparse bag-of-words features, planted labels."""
    import keras_geometric_tpu_torch as kgt

    rng = np.random.default_rng(0)
    n, pairs = CITESEER["nodes"], CITESEER["pairs"]
    feats, classes = CITESEER["feats"], CITESEER["classes"]
    a = rng.integers(0, n, pairs)
    b = rng.integers(0, n, pairs)
    edges = np.stack([np.concatenate([a, b]), np.concatenate([b, a])])
    x = (rng.random((n, feats)) < 0.01).astype(np.float32)
    y = (x @ rng.standard_normal((feats, classes))).argmax(1).astype(np.int64)
    mask = rng.random(n) < 0.5
    ctx = kgt.prepare_graph(edges, n, add_self_loops=True, device=device)
    dev = lambda arr: torch.from_numpy(arr).to(device)
    return ctx, dev(x), dev(y), dev(mask)


class MeanHeadsGAT(torch.nn.Module):
    """A hand-composed GATv2 whose last layer averages its heads
    (``concat=False``), as the attention paper's output layer does."""

    def __init__(self, in_dim, hidden, classes, heads, dropout, generator,
                 device):
        from keras_geometric_tpu_torch import GATv2Conv

        super().__init__()
        self.conv1 = GATv2Conv.for_context(
            hidden, input_dim=in_dim, heads=heads, dropout=dropout,
            generator=generator, device=device)
        self.conv2 = GATv2Conv.for_context(
            classes, input_dim=heads * hidden, heads=heads, concat=False,
            dropout=dropout, generator=generator, device=device)

    def forward(self, x, edge_index=None, *, context=None, generator=None):
        h = self.conv1(x, context=context, generator=generator)
        return self.conv2(torch.relu(h), context=context,
                          generator=generator)


def first_step(make_model, make_gen, ctx, x, y, mask, compute_dtype):
    """Loss and gradients of step 1 through the training entry point, with an
    optimizer that leaves the parameters where they are."""
    from keras_geometric_tpu_torch.training import make_node_classification_step

    model = make_model()
    opt = torch.optim.SGD(model.parameters(), lr=0.0)
    step = make_node_classification_step(
        model, opt, compute_dtype=compute_dtype, generator=make_gen())
    loss = step(x, None, y, mask, context=ctx).item()
    return loss, {k: p.grad.detach().clone()
                  for k, p in model.named_parameters()}


def train_phase(name, device, ctx, x, y, mask, make_model, make_optimizer,
                compute_dtype, steps, per_step, timed_iters=20,
                falling=lambda l: l[-1] < l[0], same_as=None,
                same_graph=None, extra=None, per_step_modes=None,
                against_default_modes=False, profile=False,
                plain_block_slots=None):
    """``same_as``: a model that computes the same function by another path
    (built with the same initial parameters); its step-1 loss is held to the
    same tolerance as the plain path's. ``same_graph``: ``(ctx, x, y,
    mask)`` of the same graph prepared another way (without the locality
    tier); step 1 there is held to the same tolerances, loss and gradients,
    and its steps are timed after the run that counts. ``extra``: fields
    added to the phase's line. ``per_step_modes``: the attention kernels'
    launches per step in their other modes and the band kernel's by route
    (none by default). ``profile``: after the run that counts, trace a few
    more steps and add the device's busy time per step, its idle share and
    the kernels that take most of it.
    ``against_default_modes``: step 1 is also taken with the attention's
    module constants at their defaults; the loss must be the same (the
    forward is the same kernel's), the gradients within the tolerance of
    the plain path's. ``plain_block_slots``: the plain path runs its
    ``spmm`` and ``attend`` in blocks of at most that many slots
    (``PlainContext``), for a graph whose ``[E, F]`` arrays do not fit.
    Returns the run's launch counts and mode counts."""
    from keras_geometric_tpu_torch.training import make_node_classification_step
    from keras_geometric_tpu_torch.utils import timed_steps

    make_gen = lambda: torch.Generator(device=device).manual_seed(7)
    # Step 1 through the kernels against step 1 through the plain versions.
    k_loss, k_grads = first_step(make_model, make_gen, ctx, x, y, mask,
                                 compute_dtype)
    p_loss, p_grads = first_step(
        make_model, make_gen, PlainContext(ctx, plain_block_slots), x, y,
        mask, compute_dtype)
    l_tol, g_tol = (1e-4, 2e-4) if compute_dtype is None else (2e-2, 5e-2)
    check(math.isfinite(k_loss) and abs(k_loss - p_loss) <= l_tol,
          f"{name}: step-1 loss {k_loss} vs plain {p_loss}")
    other_loss = same_graph_loss = None
    if same_graph is not None:
        same_graph_loss, s_grads = first_step(make_model, make_gen,
                                              *same_graph, compute_dtype)
        check(abs(k_loss - same_graph_loss) <= l_tol,
              f"{name}: step-1 loss {k_loss} vs the same graph's without "
              f"the locality tier {same_graph_loss}")
        for key, sg in s_grads.items():
            scale = sg.abs().max().item()
            err = (k_grads[key] - sg).abs().max().item()
            check(math.isfinite(err) and err <= g_tol * max(scale, 1e-12),
                  f"{name}: step-1 gradient of {key} vs the same graph's "
                  f"without the locality tier: err {err:.3e} against scale "
                  f"{scale:.3e}")
        del s_grads
    if same_as is not None:
        other_loss, _ = first_step(same_as, make_gen, ctx, x, y, mask,
                                   compute_dtype)
        check(abs(k_loss - other_loss) <= l_tol,
              f"{name}: step-1 loss {k_loss} vs the other path's "
              f"{other_loss}")
    default_loss = default_grad_err = None
    if against_default_modes:
        with attend_modes():
            default_loss, d_grads = first_step(make_model, make_gen, ctx, x,
                                               y, mask, compute_dtype)
        check(k_loss == default_loss,
              f"{name}: step-1 loss {k_loss} vs the default modes' "
              f"{default_loss}")
        default_grad_err = 0.0
        for key, dg in d_grads.items():
            scale = dg.abs().max().item()
            err = (k_grads[key] - dg).abs().max().item()
            check(math.isfinite(err) and err <= g_tol * max(scale, 1e-12),
                  f"{name}: step-1 gradient of {key} vs the default modes': "
                  f"err {err:.3e} against scale {scale:.3e}")
            default_grad_err = max(default_grad_err,
                                   err / max(scale, 1e-12))
        del d_grads
    grad_err = 0.0
    for key, pg in p_grads.items():
        scale = pg.abs().max().item()
        err = (k_grads[key] - pg).abs().max().item()
        check(math.isfinite(err) and err <= g_tol * max(scale, 1e-12),
              f"{name}: step-1 gradient of {key}: err {err:.3e} against "
              f"scale {scale:.3e}")
        grad_err = max(grad_err, err / max(scale, 1e-12))

    # The run that counts: launch counts are zeroed just before it and read
    # just after; nothing else launches kernels in between.
    model = make_model()
    optimizer = make_optimizer(model)
    step = make_node_classification_step(
        model, optimizer, compute_dtype=compute_dtype, generator=make_gen())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses = [step(x, None, y, mask, context=ctx) for _ in range(steps)]
    timing = dict(k_lo=2, k_hi=2 + timed_iters, trials=2)
    timed = []  # the steps timed_steps takes count like the others

    def timed_step():
        timed.append(1)
        return step(x, None, y, mask, context=ctx)

    step_ms = 1e3 * timed_steps(timed_step, **timing)
    torch.cuda.synchronize()
    counts, modes = launch_counts(), mode_launch_counts()
    total_steps = steps + len(timed)
    losses = [l.item() for l in losses]
    check(all(math.isfinite(l) for l in losses), f"{name}: loss not finite")
    check(falling(losses), f"{name}: loss did not fall: {losses}")
    expected = {k: per_step.get(k, 0) * total_steps for k in counts}
    check(counts == expected,
          f"{name}: launch counts {counts}, expected {expected}")
    per_step_modes = per_step_modes or {}
    expected = {k: per_step_modes.get(k, 0) * total_steps for k in modes}
    check(modes == expected,
          f"{name}: mode launch counts {modes}, expected {expected}")
    logits_ok = all(torch.isfinite(p).all().item() for p in model.parameters())
    check(logits_ok, f"{name}: parameters not finite after training")
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    traced = {}
    if profile:
        traced = {"profile": profile_steps(
            lambda: step(x, None, y, mask, context=ctx), iters=5, top=8)}
    same_graph_ms = same_graph_peak_mb = None
    if same_graph is not None:
        del model, optimizer, step
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = make_model()
        step = make_node_classification_step(
            model, make_optimizer(model), compute_dtype=compute_dtype,
            generator=make_gen())
        s_ctx, s_x, s_y, s_mask = same_graph
        same_graph_ms = 1e3 * timed_steps(
            lambda: step(s_x, None, s_y, s_mask, context=s_ctx), **timing)
        same_graph_peak_mb = torch.cuda.max_memory_allocated() / 2**20
    emit(name, steps=total_steps, losses=losses, step1_loss=k_loss,
         step1_loss_plain=p_loss, step1_loss_other_path=other_loss,
         step1_loss_without_locality_tier=same_graph_loss,
         step1_loss_default_modes=default_loss,
         step1_grad_rel_err_vs_default_modes=default_grad_err,
         step1_grad_rel_err=grad_err,
         launches_per_step=per_step, launches=counts,
         mode_launches_per_step=per_step_modes, mode_launches=modes,
         step_ms=step_ms,
         stream_edges_per_s=ctx.num_real_edges / step_ms * 1e3,
         step_ms_without_locality_tier=same_graph_ms,
         peak_memory_mb=peak_mb,
         peak_memory_mb_without_locality_tier=same_graph_peak_mb,
         nodes=ctx.num_nodes, stream_edges=ctx.num_real_edges,
         compute_dtype=str(compute_dtype or torch.float32)[6:],
         **traced, **(extra or {}))
    return counts, modes


def profile_steps(step_fn, iters=10, top=14):
    """Device time by kernel over a short steady window of training steps
    (``torch.profiler``), and the share of the window the device sat idle."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        step_fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(iters):
            step_fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3

    rows = device_time_rows(prof)
    busy_ms = sum(r[0] for r in rows) / 1e3
    check(busy_ms > 0, "profiler recorded no device time")
    return {
        "steps": iters, "wall_ms_per_step": wall_ms / iters,
        "device_busy_ms_per_step": busy_ms / iters,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "kernels_per_step": sum(r[2] for r in rows) / iters,
        "top": [{"name": k[:80], "ms_per_step": us / 1e3 / iters,
                 "calls_per_step": c / iters} for us, k, c in rows[:top]],
    }


# ---------------------------------------------------------------------------
# The data tier: ogbn-arxiv from the repository's cache
# ---------------------------------------------------------------------------

OGBN_ARXIV_EDGES = 2_332_486  # the cache's symmetrized edges
SAGE_FANOUTS, SAGE_BATCH, SAGE_BATCHES = (25, 10), 512, 20
SAGE_VALID_NODES = 4_096


def ogbn_data(name="ogbn-arxiv", root=None, **dataset_kw):
    """An OGB cache as host arrays: the memory maps copied once.
    ``root``: the cache's parent (default the tracked ``data/``);
    ``dataset_kw``: ``OGBNodeDataset``'s, e.g. ``synthetic=True`` to write
    the size-faithful stand-in there when the cache is missing.
    ``dataset_s`` is the dataset's construction (the generation and the
    writing, where the cache was missing), ``load_s`` everything."""
    from keras_geometric_tpu_torch.data.datasets import OGBNodeDataset

    root = pathlib.Path(root or ROOT / "data")
    cached = (root / name.replace("-", "_") / "meta.json").exists()
    start = time.perf_counter()
    ds = OGBNodeDataset(name, root=str(root), **dataset_kw)
    dataset_s = time.perf_counter() - start
    senders, receivers = ds.edges()
    data = dict(
        dataset=ds, edges=np.stack([np.array(senders), np.array(receivers)]),
        x=np.array(ds.x), y=np.array(ds.y), split=ds.split_idx(),
        cache_reused=cached, dataset_s=dataset_s)
    data["load_s"] = time.perf_counter() - start
    return data


def ogbn_gcn_workload(device, data):
    """``train_arxiv_shape``'s preparation of an OGB dataset's own graph,
    with its train split as the loss mask."""
    import keras_geometric_tpu_torch as kgt

    ds = data["dataset"]
    start = time.perf_counter()
    ctx = kgt.prepare_graph(
        data["edges"], ds.num_nodes, add_self_loops=True, gcn_normalize=True,
        symmetric=True, densify_self_loops=True, pad_nodes=True,
        device=device)
    prepare_s = time.perf_counter() - start
    return (ctx.with_weight_dtype(torch.bfloat16),
            *ogbn_node_tensors(device, data, ctx.num_nodes), prepare_s)


def ogbn_gat_workload(device, data):
    """``train_gat_arxiv_shape``'s preparation (one self-loop a node, in the
    stream) of an OGB dataset's own graph, with its train split as the loss
    mask."""
    import keras_geometric_tpu_torch as kgt

    ds = data["dataset"]
    start = time.perf_counter()
    ctx = kgt.prepare_graph(data["edges"], ds.num_nodes, add_self_loops=True,
                            device=device)
    prepare_s = time.perf_counter() - start
    return (ctx, *ogbn_node_tensors(device, data, ctx.num_nodes), prepare_s)


def ogbn_node_tensors(device, data, n_pad):
    """Features, labels and the train split's mask, padded to ``n_pad``
    rows, on ``device``."""
    n = data["dataset"].num_nodes
    x = np.pad(data["x"], ((0, n_pad - n), (0, 0)))
    y = np.pad(data["y"].astype(np.int64), (0, n_pad - n))
    mask = np.zeros(n_pad, bool)
    mask[data["split"]["train"]] = True
    dev = lambda arr: torch.from_numpy(arr).to(device)
    return dev(x), dev(y), dev(mask)


def host_peak_rss_gib() -> float:
    """The process's peak resident set so far (``getrusage``), in GiB."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


# ---------------------------------------------------------------------------
# ogbn-products (BASELINE.json's north star, config 5) on one card
# ---------------------------------------------------------------------------

PRODUCTS_NODES, PRODUCTS_EDGES = 2_449_029, 123_718_280
PRODUCTS_FEATS, PRODUCTS_CLASSES = 100, 47
PRODUCTS_N_PAD = 2_449_152  # the GCN context's padded node count
PRODUCTS_GAT_DIMS = (64, PRODUCTS_CLASSES)
# Slots of a block of the plain versions at products (PlainContext): the
# GCN's gather at F = 100 f32 is 3.4 GB a block; the attention's [E, 256]
# f32 arrays 2.1 GB each a block, several alive in its backward.
PLAIN_GCN_BLOCK_SLOTS, PLAIN_GAT_BLOCK_SLOTS = 2**23, 2**21
PRODUCTS_STEPS, PRODUCTS_TIMED = 5, 5  # counted steps; timed_steps' k_hi - 2


def products_gcn_entries(timer, replaces, path, ctx, x, gen):
    """K1's row walk at the products GCN's two widths (layer 1 at F = 100
    on the features, layer 2 at F = 47 on random rows), against the plain
    version in blocks of ``PLAIN_GCN_BLOCK_SLOTS`` slots, with
    ``torch.sparse.mm``'s time beside it."""
    from keras_geometric_tpu_torch.kernels import spmm_cuda as K

    n, e = ctx.num_nodes, ctx.senders.shape[0]
    w, sw = ctx.edge_weight, ctx.self_weight
    blocks = row_blocks(ctx.row_ptr, PLAIN_GCN_BLOCK_SLOTS)
    diag = torch.arange(n, device=x.device, dtype=torch.int32)
    lib = (torch.cat([ctx.receivers, diag]), torch.cat([ctx.senders, diag]),
           torch.cat([w, sw]))
    entries = []
    for label, h in (
            ("layer 1", x.to(torch.bfloat16)),
            ("layer 2", torch.randn(n, PRODUCTS_CLASSES, generator=gen,
                                    device=x.device).to(torch.bfloat16))):
        f, es = h.shape[1], h.element_size()
        kernel = lambda: K.gather_scatter_sum_sorted(
            h, ctx.senders, ctx.receivers, ctx.row_ptr, n, weights=w,
            self_weight=sw, pieces=False)
        plain = lambda: blocked_plain(blocks, lambda block: spmm_rows(
            h, ctx, block, w, sw, h.dtype), "rows")
        h_abs, w_abs, sw_abs = h.float().abs(), w.float().abs(), sw.abs()
        mass = blocked_plain(blocks, lambda block: spmm_rows(
            h_abs, ctx, block, w_abs, sw_abs, torch.float32), "rows")
        del h_abs, w_abs, sw_abs
        err = compare(kernel(), plain(), mass, h.dtype,
                      f"{path} {label} row walk")
        del mass
        library_ms, note = sparse_library_ms(timer, *lib, (n, n), h)
        nbytes = 2 * n * f * es + e * (4 + w.element_size()) + \
            (n + 1) * 4 + n * sw.element_size()
        entry = kernel_entry(
            timer, replaces, "gather_scatter_sum_sorted", path,
            f"products {label}: E={e} (real {ctx.num_real_edges}) N={n} "
            f"F={f} bf16", kernel, plain, err, nbytes,
            2 * e * f + 2 * n * f, mode="rows",
            library=("torch.sparse.mm on a CSR tensor", library_ms),
            plain_iters=1, no_reuse_bytes=nbytes + e * f * es,
            extra={"plain_blocks": len(blocks),
                   "plain_block_slots": PLAIN_GCN_BLOCK_SLOTS,
                   **({"library_note": note} if note else {}),
                   "longest_row": longest_row(ctx.row_ptr)})
        # What the width costs: the same walk at the next multiple of 8
        # columns, whose 16-byte rows take the widest packs.
        wide = torch.zeros(n, padded_width(f), dtype=h.dtype, device=h.device)
        wide[:, :f] = h
        entry.update(padded_width=wide.shape[1], ms_at_padded_width=(
            timer.cold_ms(lambda: K.gather_scatter_sum_sorted(
                wide, ctx.senders, ctx.receivers, ctx.row_ptr, n, weights=w,
                self_weight=sw, pieces=False), iters=10)))
        del wide
        entries.append(entry)
        torch.cuda.empty_cache()
    return entries


def padded_width(f):
    """The next multiple of 8 columns: a bf16 row of it is a whole number
    of 16-byte packs."""
    return -(-f // 8) * 8


def padded_width_ms(timer, ctx, heads, f, gen):
    """Each send-mode attention kernel's time at ``padded_width(f)`` columns
    a head on the same graph and random inputs (what a width that is not a
    multiple of 8 costs: its narrower packs); empty where ``f`` is one."""
    from keras_geometric_tpu_torch.kernels import attend_cuda as A

    fp = padded_width(f)
    if fp == f:
        return {}
    s, r, rp, valid = ctx.senders, ctx.receivers, ctx.row_ptr, ctx.edge_mask
    ss = (ctx.receivers_ss, ctx.senders_sorted, ctx.row_ptr_bwd)
    ht, att, gout, _ = attend_inputs(gen, ctx.num_nodes, heads, fp,
                                     torch.bfloat16, s.shape[0], False,
                                     s.device)
    _, scores, m, l = A.sddmm_stats_agg_sorted(ht, s, r, rp, att,
                                               edge_valid=valid)
    rho = A.attend_rho_sorted(gout, scores, m, l, ht, s, r, rp)
    out = {
        "sddmm_stats_agg_sorted": lambda: A.sddmm_stats_agg_sorted(
            ht, s, r, rp, att, edge_valid=valid),
        "attend_rho_sorted": lambda: A.attend_rho_sorted(
            gout, scores, m, l, ht, s, r, rp),
        "attend_recv_bwd_full_sorted": lambda: A.attend_recv_bwd_full_sorted(
            ht, gout, s, r, rp, att, scores, m, l, rho, emit_v=False,
            edge_valid=valid),
        "attend_send_bwd_sorted": lambda: A.attend_send_bwd_sorted(
            ht, gout, *ss, att, m, l, rho, valid_ss=ctx.edge_mask_ss)}
    out = {name: timer.cold_ms(fn, iters=10) for name, fn in out.items()}
    del ht, att, gout, scores, m, l, rho
    torch.cuda.empty_cache()
    return out


def products_attend_entries(timer, replaces, path, ctx, gen):
    """The send-mode attention kernels (K9, K10b, K10c without ``v``, K10d)
    at the products GATv2's two layers (H = 4, F = 64 and 47, bf16, random
    ``ht``, ``att`` and cotangent), each held by ``attend_case`` against its
    plain version in blocks of ``PLAIN_GAT_BLOCK_SLOTS`` slots (receiver
    rows; K10d's sender rows)."""
    from keras_geometric_tpu_torch.kernels import attend_cuda as A

    n, e = ctx.num_nodes, ctx.senders.shape[0]
    s, r, rp, valid = ctx.senders, ctx.receivers, ctx.row_ptr, ctx.edge_mask
    ss = (ctx.receivers_ss, ctx.senders_sorted, ctx.row_ptr_bwd)
    valid_ss = ctx.edge_mask_ss
    blocks = row_blocks(rp, PLAIN_GAT_BLOCK_SLOTS)
    send_blocks = row_blocks(ctx.row_ptr_bwd, PLAIN_GAT_BLOCK_SLOTS)
    entries = []
    for label, f in (("layer 1", PRODUCTS_GAT_DIMS[0]),
                     ("layer 2", PRODUCTS_GAT_DIMS[1])):
        heads = GAT_ARXIV_HEADS
        ht, att, gout, _ = attend_inputs(gen, n, heads, f, torch.bfloat16, e,
                                         False, s.device)
        errs, plain = attend_case(
            (s, r, rp, valid), ht, att, gout, None, f"{path} {label}",
            blocks=blocks, emit_v=False, send=(ss, valid_ss, send_blocks))
        # The kernels timed on their own forward's scores and statistics.
        _, scores, m, l = A.sddmm_stats_agg_sorted(ht, s, r, rp, att,
                                                   edge_valid=valid)
        rho = A.attend_rho_sorted(gout, scores, m, l, ht, s, r, rp)
        kernels = {
            "sddmm_stats_agg_sorted": lambda: A.sddmm_stats_agg_sorted(
                ht, s, r, rp, att, edge_valid=valid),
            "attend_rho_sorted": lambda: A.attend_rho_sorted(
                gout, scores, m, l, ht, s, r, rp),
            "attend_recv_bwd_full_sorted": lambda: (
                A.attend_recv_bwd_full_sorted(
                    ht, gout, s, r, rp, att, scores, m, l, rho,
                    emit_v=False, edge_valid=valid)),
            "attend_send_bwd_sorted": lambda: A.attend_send_bwd_sorted(
                ht, gout, *ss, att, m, l, rho, valid_ss=valid_ss)}
        counts = attend_counts(n, e, heads, f, 2)  # bf16
        padded = padded_width_ms(timer, ctx, heads, f, gen)
        for name, kernel in kernels.items():
            mode = "emit_v=False" if name == "attend_recv_bwd_full_sorted" \
                else None
            nbytes, ops, no_reuse = counts[
                name if mode is None else f"{name}({mode})"]
            sender_order = name == "attend_send_bwd_sorted"
            entry = kernel_entry(
                timer, replaces, name, path,
                f"products {label}: E={e} N={n} H={heads} F={f} bf16",
                kernel, plain[name], errs[name], nbytes, ops, mode=mode,
                plain_iters=1, no_reuse_bytes=nbytes + no_reuse,
                extra={**piece_walk_fields(
                    name, ctx.row_ptr_bwd if sender_order else rp),
                    "plain_blocks": len(send_blocks if sender_order
                                        else blocks),
                    "plain_block_slots": PLAIN_GAT_BLOCK_SLOTS})
            if padded:
                entry.update(padded_width=padded_width(f),
                             ms_at_padded_width=padded[name])
            entries.append(entry)
        del ht, att, gout, scores, m, l, rho, kernels, plain
        torch.cuda.empty_cache()
    return entries


def device_time_rows(prof) -> list:
    """``(self device us, name, calls)`` of every kernel and copy a
    ``torch.profiler`` run recorded, largest first."""
    def self_device_us(ev):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(ev, attr):
                return getattr(ev, attr)
        return 0.0

    # Kernels and copies only: host-side operator events and device-side
    # annotation ranges repeat the time of the kernels under them.
    on_device = torch.autograd.DeviceType.CUDA
    rows = sorted(((self_device_us(ev), ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == on_device
                   and not getattr(ev, "is_user_annotation", False)),
                  reverse=True)
    return [r for r in rows if r[0] > 0]


def sage_minibatch_phase(device, data) -> dict:
    """Neighbour-sampled GraphSAGE minibatch training on ogbn-arxiv, as the
    reference's example runs it (``examples/sage_minibatch.py``: fanouts
    (25, 10), batch 512, 256 hidden, Adam 1e-3). Returns the launch counts
    of the run that counts (all 0: no hand-written kernel on this path)."""
    import itertools

    from torch.profiler import ProfilerActivity, profile

    from keras_geometric_tpu_torch import SAGEConv, native
    from keras_geometric_tpu_torch.data.sampling import (
        NeighborSampler,
        prefetch,
    )
    from keras_geometric_tpu_torch.training import (
        TrainState,
        restore_checkpoint,
        save_checkpoint,
    )
    from keras_geometric_tpu_torch.training.sage_minibatch import (
        make_sage_minibatch_step,
        subgraph_to_arrays,
    )
    from keras_geometric_tpu_torch.utils import timed_steps

    name = "train_sage_minibatch_ogbn_arxiv"
    ds = data["dataset"]
    n, feats, classes = ds.num_nodes, ds.num_feats, ds.num_classes
    check((n, feats, classes) == (ARXIV_NODES, ARXIV_FEATS, ARXIV_CLASSES)
          and data["edges"].shape[1] == OGBN_ARXIV_EDGES,
          f"{name}: the dataset has the wrong size")
    branch = "native" if native.available() else "numpy"
    start = time.perf_counter()
    make_sampler = lambda seed=0: NeighborSampler(data["edges"], n,
                                                  SAGE_FANOUTS, seed=seed)
    sampler = make_sampler()
    sampler_build_s = time.perf_counter() - start
    x_dev = torch.from_numpy(data["x"]).to(device)
    y_dev = torch.from_numpy(data["y"]).to(device)
    train_nodes = data["split"]["train"]

    # Host time a batch, on a sampler of its own (the run's stream stays
    # the example's): sampling, then the bucket's gather on the card.
    timing_sampler = make_sampler(seed=1)
    sample_s, to_arrays_s = [], []
    for sub_seeds in np.split(train_nodes[:3 * SAGE_BATCH], 3):
        start = time.perf_counter()
        sub = timing_sampler.sample(sub_seeds, batch_size=SAGE_BATCH)
        sample_s.append(time.perf_counter() - start)
        start = time.perf_counter()
        subgraph_to_arrays(sub, x_dev, y_dev)
        torch.cuda.synchronize()
        to_arrays_s.append(time.perf_counter() - start)

    def make_layers(dev, gen):
        return torch.nn.ModuleList([
            SAGEConv(HIDDEN, input_dim=feats, generator=gen, device=dev),
            SAGEConv(classes, input_dim=HIDDEN, activation=None,
                     generator=gen, device=dev)])

    def make_run(dev, seed=0, optimizer=None):
        gen = torch.Generator(device=dev).manual_seed(seed)
        layers = make_layers(dev, gen)
        opt = (optimizer or (lambda p: torch.optim.Adam(p, lr=1e-3)))(
            layers.parameters())
        step, infer = make_sage_minibatch_step(tuple(layers), classes, opt,
                                               generator=gen)
        return TrainState(layers, opt, generator=gen), step, infer

    def grads_of(layers):
        return {k: p.grad.detach().clone()
                for k, p in layers.named_parameters()}

    # Step 1 on the card against the same bucket's step on the CPU: the
    # run's first bucket (a sampler of the same seed draws it), the same
    # initial weights, an optimizer that leaves them where they are.
    first = next(make_sampler().epoch(train_nodes, SAGE_BATCH))
    sgd = lambda p: torch.optim.SGD(p, lr=0.0)
    card, card_step, _ = make_run(device, optimizer=sgd)
    host, host_step, _ = make_run("cpu", optimizer=sgd)
    host.model.load_state_dict({k: v.cpu() for k, v in
                                card.model.state_dict().items()})
    card_loss = card_step(subgraph_to_arrays(first, x_dev, y_dev)).item()
    host_loss = host_step(subgraph_to_arrays(first, data["x"], data["y"],
                                             device="cpu")).item()
    check(math.isfinite(card_loss) and abs(card_loss - host_loss) <= 1e-4,
          f"{name}: step-1 loss {card_loss} vs the CPU path's {host_loss}")
    grad_err = 0.0
    host_grads = grads_of(host.model)
    for key, g in grads_of(card.model).items():
        scale = host_grads[key].abs().max().item()
        err = (g.cpu() - host_grads[key]).abs().max().item()
        check(math.isfinite(err) and err <= 2e-4 * max(scale, 1e-12),
              f"{name}: step-1 gradient of {key}: err {err:.3e} against "
              f"scale {scale:.3e}")
        grad_err = max(grad_err, err / max(scale, 1e-12))
    del card, host, host_grads

    # The run that counts: 20 batches through prefetch (the worker samples
    # on the host; copies and launches happen here), traced for the
    # device's idle share; then the same 20 again untraced for wall time.
    state, step, infer = make_run(device)
    real_rows, real_edges = [], [[] for _ in SAGE_FANOUTS]

    def batches(seed=None):
        s = sampler if seed is None else make_sampler(seed)
        return prefetch(itertools.islice(s.epoch(train_nodes, SAGE_BATCH),
                                         SAGE_BATCHES), depth=2)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for sub in batches():
            real_rows.append(int(sub.node_mask.sum()))
            for k, (_, _, emask) in enumerate(sub.layers):
                real_edges[k].append(int(emask.sum()))
            losses.append(step(subgraph_to_arrays(sub, x_dev, y_dev)))
            state.step += 1
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - start) * 1e3
    counts, modes = launch_counts(), mode_launch_counts()
    check(not any(counts.values()) and not any(modes.values()),
          f"{name}: hand-written kernels launched on the minibatch path: "
          f"{counts} {modes}")
    check(len(losses) == SAGE_BATCHES, f"{name}: {len(losses)} batches")
    losses = [l.item() for l in losses]
    check(all(math.isfinite(l) for l in losses), f"{name}: loss not finite")
    check(abs(losses[0] - card_loss) <= 1e-4,
          f"{name}: the run's step-1 loss {losses[0]} vs {card_loss}")
    check(sum(losses[-5:]) < sum(losses[:5]),
          f"{name}: loss did not fall: {losses}")
    busy_ms = sum(r[0] for r in device_time_rows(prof)) / 1e3
    check(busy_ms > 0, f"{name}: the profiler recorded no device time")
    peak_mb = torch.cuda.max_memory_allocated() / 2**20

    untimed = make_run(device)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for sub in batches(seed=2):
        untimed[1](subgraph_to_arrays(sub, x_dev, y_dev))
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - start) * 1e3 / SAGE_BATCHES
    del untimed

    # Save, restore into a fresh model, optimizer and generator, and take
    # the next step both ways: the same loss and weights, bit for bit
    # (deterministic index_add_ on the card, for both steps).
    ckpt = pathlib.Path(__file__).resolve().parent / "build" / "ckpt_sage"
    nxt = subgraph_to_arrays(next(make_sampler(seed=3).epoch(
        train_nodes, SAGE_BATCH)), x_dev, y_dev)
    save_checkpoint(str(ckpt), state, config={"fanouts": SAGE_FANOUTS})
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        loss_on = step(nxt)
        fresh, fresh_step, _ = make_run(device, seed=11)
        restore_checkpoint(str(ckpt), fresh)
        loss_restored = fresh_step(nxt)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    check(fresh.step == SAGE_BATCHES and torch.equal(loss_on, loss_restored)
          and all(torch.equal(a, b) for a, b in zip(
              state.model.state_dict().values(),
              fresh.model.state_dict().values())),
          f"{name}: the restored run's next step differs from the "
          f"uninterrupted one")
    del fresh, fresh_step

    # Device time of one step on one fixed bucket.
    step_ms = 1e3 * timed_steps(lambda: step(nxt), k_lo=2, k_hi=12,
                                trials=2)

    # Sampled validation accuracy, as the example measures it.
    correct = total = 0
    for sub in sampler.epoch(data["split"]["valid"][:SAGE_VALID_NODES],
                             SAGE_BATCH):
        batch = subgraph_to_arrays(sub, x_dev, y_dev)
        pred = infer(batch)[:SAGE_BATCH].argmax(-1)
        hit = (pred == batch["y_seed"]) & batch["seed_mask"]
        correct += int(hit.sum())
        total += int(batch["seed_mask"].sum())
    check(total == SAGE_VALID_NODES, f"{name}: {total} validation nodes")

    caps = [SAGE_BATCH]
    for f in SAGE_FANOUTS:
        caps.append(caps[-1] * f)
    emit(name, is_synthetic=ds.is_synthetic, sampler_branch=branch,
         nodes=n, edges=int(data["edges"].shape[1]),
         fanouts=list(SAGE_FANOUTS), batch_size=SAGE_BATCH,
         batches=SAGE_BATCHES, losses=losses, step1_loss=card_loss,
         step1_loss_cpu=host_loss, step1_grad_rel_err=grad_err,
         checkpoint_resumed_bit_for_bit=True,
         valid_accuracy_sampled=correct / total,
         host_ms_per_batch={
             "sample": 1e3 * sum(sample_s) / len(sample_s),
             "subgraph_to_arrays": 1e3 * sum(to_arrays_s) / len(to_arrays_s)},
         step_ms=step_ms, wall_ms_per_batch=wall_ms,
         wall_ms_per_batch_traced=traced_ms / SAGE_BATCHES,
         device_busy_ms_per_batch=busy_ms / SAGE_BATCHES,
         device_idle_share=max(0.0, 1.0 - busy_ms / traced_ms),
         rows={"real_mean": sum(real_rows) / len(real_rows),
               "padded": sum(caps)},
         edge_slots={f"layer_{k}": {"real_mean": sum(v) / len(v),
                                    "padded": caps[k] * SAGE_FANOUTS[k]}
                     for k, v in enumerate(real_edges)},
         peak_memory_mb=peak_mb, launches_per_step=0,
         launches_per_step_why="the aggregations are library ops "
         "(ops/segment.py), as the reference's are XLA segment ops",
         load_seconds=data["load_s"], sampler_build_seconds=sampler_build_s,
         x_on_card_mb=x_dev.numel() * 4 / 2**20)
    return counts


# ---------------------------------------------------------------------------
# Graph classification (BASELINE.json config 3), the readouts, the examples
# ---------------------------------------------------------------------------

ROOT = pathlib.Path(__file__).resolve().parent
GC_GRAPHS, GC_CLASSES, GC_BATCH, GC_HIDDEN = 200, 3, 32, 32
GC_TRAIN, GC_EPOCHS, GC_SHORT_STEPS = 160, 30, 11  # short runs: step 1 + 10
READOUT_NODES, READOUT_FEATS = 100_000, 128
# The twins of examples/ at the fewest epochs their flags allow.
EXAMPLE_RUNS = (
    ("graph_classification.py", ("--epochs", "1")),
    ("pooling_readouts.py", ()),
    ("node_classification.py", ("--epochs", "1")),
    ("node_classification.py", ("--epochs", "1", "--dataset", "pubmed")),
    ("gatv2_attention.py", ("--epochs", "1")),
    ("locality_banded_gcn.py", ("--epochs", "1")),
    ("sage_minibatch.py", ("--epochs", "1")),
    ("simple_gcn.py", ()),
    ("simple_gin.py", ()),
    ("simple_gatv2.py", ()),
    ("simple_sage.py", ()),
)
EXAMPLES_SECONDS = 180
# The twins whose path runs hand-written kernels, driven in process: steps of
# each counted run, and each kernel's launches per step (as the same model's
# training phases launch them: node classification as train_cora_shape, its
# first layer's dropout on the edge messages; the banded GCN's four spmm
# calls, both layers forward and backward, each one band product and one row
# walk over the residual edges, f32 on the band kernel's FMA route).
TWIN_STEPS = 10
TWIN_LAUNCHES = {
    "node_classification": (
        {"scatter_sum_sorted": 1, "expand_sorted": 1,
         "gather_scatter_sum_sorted": 3},
        {"gather_scatter_sum_sorted(rows)": 2}),
    "locality_banded_gcn": (
        {"band_spmm": 4, "gather_scatter_sum_sorted": 4},
        {"band_spmm(fma)": 4, "gather_scatter_sum_sorted(rows)": 4}),
}


def example_module(name: str):
    """A twin of ``examples/`` loaded as a module: its functions, not its
    ``main``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def relative_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest difference over the largest entry of ``want`` (on the host)."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    scale = max(want.abs().max().item(), 1e-12)
    return (got - want).abs().max().item() / scale


def gc_batches(graphs, count):
    """The example's batches: each epoch a shuffle of the 160 training
    graphs (numpy, seed 0) cut into 5 batches of 32; the first ``count``."""
    rng, order, out = np.random.default_rng(0), np.arange(GC_TRAIN), []
    while len(out) < count:
        rng.shuffle(order)
        for i in range(0, GC_TRAIN - GC_BATCH + 1, GC_BATCH):
            out.append([graphs[j] for j in order[i:i + GC_BATCH]])
    return out[:count]


def graph_classification_phase(device) -> dict:
    """GIN graph classification as ``examples_torch/graph_classification.py``
    builds it: 200 synthetic graphs of 10-23 nodes (seed 0), buckets of 768
    nodes and 6,144 edges holding 32 graphs and the dummy, the 5-layer GIN
    at width 32 and Adam 1e-3, f32. Readout ``sum`` for the example's 30
    epochs and its test accuracy; ``mean`` and ``max`` for 11 steps. Returns
    the launch counts of the runs (all 0: no hand-written kernel lies on
    this path)."""
    from torch.profiler import ProfilerActivity, profile

    from keras_geometric_tpu_torch.utils import timed_steps

    name = "train_gin_graph_classification"
    gc = example_module("graph_classification")
    graphs, _, classes = gc.make_dataset(GC_GRAPHS, GC_CLASSES, seed=0)
    num_graphs = GC_BATCH + 1
    sizes = [g.num_nodes for g in graphs]
    check(classes == GC_CLASSES and len(graphs) == GC_GRAPHS
          and min(sizes) >= 10 and max(sizes) <= 23,
          f"{name}: the dataset has the wrong size")

    def make_run(dev, readout):
        gen = torch.Generator(device=dev).manual_seed(0)
        model = gc.make_model(GC_HIDDEN, classes, readout, device=dev,
                              generator=gen)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        return model, gc.make_train_step(model, opt, num_graphs)

    reset_launch_counts()
    runs = {}
    for readout, steps in (("sum", GC_EPOCHS * GC_TRAIN // GC_BATCH),
                           ("mean", GC_SHORT_STEPS), ("max", GC_SHORT_STEPS)):
        what = f"{name} ({readout})"
        batches = gc_batches(graphs, steps)
        model, step = make_run(device, readout)
        host, host_step = make_run("cpu", readout)
        host.load_state_dict({k: v.cpu() for k, v in
                              model.state_dict().items()})

        # Step 1 on the card against the same step on the CPU path, then
        # the run goes on from the card's step 1.
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        g, y, _ = gc.batch_to_arrays(batches[0], GC_BATCH, device)
        card_loss = step(g, y).item()
        g_cpu, y_cpu, _ = gc.batch_to_arrays(batches[0], GC_BATCH, "cpu")
        host_loss = host_step(g_cpu, y_cpu).item()
        # The loss within 1e-4 of its magnitude: the first losses run to the
        # thousands (5 layers of sum aggregation at random weights).
        check(math.isfinite(card_loss) and abs(card_loss - host_loss)
              <= 1e-4 * max(1.0, abs(host_loss)),
              f"{what}: step-1 loss {card_loss} vs the CPU path's {host_loss}")
        host_grads = dict(host.named_parameters())
        grad_err = 0.0
        for key, p in model.named_parameters():
            err = relative_err(p.grad, host_grads[key].grad)
            check(math.isfinite(err) and err <= 2e-4,
                  f"{what}: step-1 gradient of {key}: {err:.3e} of its "
                  f"largest entry")
            grad_err = max(grad_err, err)
        del host, host_step, host_grads

        losses = [torch.tensor(card_loss)]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            start = time.perf_counter()
            for chunk in batches[1:]:
                g, y, _ = gc.batch_to_arrays(chunk, GC_BATCH, device)
                losses.append(step(g, y))
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - start) * 1e3
        losses = [float(l) for l in losses]
        check(len(losses) == steps and all(map(math.isfinite, losses)),
              f"{what}: {len(losses)} losses, or one not finite")
        first5, last5 = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
        check(last5 < first5, f"{what}: the mean loss of the last 5 steps "
              f"{last5} is not below the first 5's {first5}")
        rows = device_time_rows(prof)
        busy_ms = sum(r[0] for r in rows) / 1e3
        check(busy_ms > 0, f"{what}: the profiler recorded no device time")
        run = dict(steps=steps, step1_loss=card_loss,
                   step1_loss_cpu=host_loss, step1_grad_rel_err=grad_err,
                   loss_first5_mean=first5, loss_last5_mean=last5,
                   losses=losses if steps <= GC_SHORT_STEPS else
                   losses[:5] + losses[-5:],
                   wall_ms_per_step_traced=traced_ms / (steps - 1),
                   device_busy_ms_per_step=busy_ms / (steps - 1),
                   device_idle_share=max(0.0, 1.0 - busy_ms / traced_ms),
                   kernels_per_step=sum(r[2] for r in rows) / (steps - 1),
                   top=[{"name": k[:60], "ms_per_step": us / 1e3 / (steps - 1)}
                        for us, k, _ in rows[:5]],
                   peak_memory_mb=torch.cuda.max_memory_allocated() / 2**20)
        if readout == "sum":  # the example's test accuracy, graphs 160-191
            predict = gc.make_predict(model, num_graphs)
            correct = total = 0
            for i in range(GC_TRAIN, GC_GRAPHS - GC_BATCH + 1, GC_BATCH):
                g, y, _ = gc.batch_to_arrays(graphs[i:i + GC_BATCH],
                                             GC_BATCH, device)
                valid = y >= 0
                correct += int(((predict(g) == y) & valid).sum())
                total += int(valid.sum())
            check(total == GC_BATCH, f"{what}: {total} test graphs")
            run["test_accuracy"] = correct / total
        # Device time of one step on one fixed bucket (more Adam steps).
        g, y, _ = gc.batch_to_arrays(batches[0], GC_BATCH, device)
        run["step_ms"] = 1e3 * timed_steps(lambda: step(g, y), k_lo=2,
                                           k_hi=12, trials=2)
        runs[readout] = run
        del model, step

    counts, modes = launch_counts(), mode_launch_counts()
    check(not any(counts.values()) and not any(modes.values()),
          f"{name}: hand-written kernels launched on the graph "
          f"classification path: {counts} {modes}")
    emit(name, graphs=GC_GRAPHS, batch_size=GC_BATCH,
         node_bucket=24 * GC_BATCH, edge_bucket=24 * 8 * GC_BATCH,
         graph_slots=num_graphs, model=f"GraphClassifier(GIN(({GC_HIDDEN},) "
         f"* 5, mlp_hidden=({GC_HIDDEN},)), {classes})", runs=runs,
         launches_per_step=0, launches_per_step_why="the edge-list GIN "
         "aggregates and the readout pools with library segment ops "
         "(ops/segment.py), as the reference's run XLA's")
    return counts


def readout_errors(got, ref) -> list:
    """Errors of ``(out, d x, parameter gradients)`` against ``ref``: the
    first two each over its own largest entry in ``ref``, the gradients over
    the largest entry of them all (0 for a module without parameters)."""
    errs = [relative_err(a, b) for a, b in zip(got[:2], ref[:2])]
    grads = 0.0
    if ref[2]:
        scale = max(b.abs().max().item() for b in ref[2])
        grads = max((a - b).abs().max().item()
                    for a, b in zip(got[2], ref[2])) / max(scale, 1e-12)
    return [e if math.isfinite(e) else math.inf for e in errs + [grads]]


# The readouts' limits: the largest error of the card's result against the
# same computation in f64 on the CPU, of the largest entry. One limit for
# each type, wider for two kinds of case where the f32 or bf16 result itself,
# on the CPU path as on the card, lies near the type's limit (readings on an
# NVIDIA H100 80GB HBM3, 700.00 W):
# - a serial f32 sum of 100,000 rows into one graph (``index_add``), whose
#   rounding grows with the count: the card read 1.1e-5-1.5e-5, the CPU
#   path 6.0e-6-1.1e-5;
# - ``Set2Set`` in bf16, three LSTM steps and attentions rounded in turn:
#   the card read 1.3e-2-1.6e-2, the CPU path 1.3e-2-1.8e-2.
# A wrong result lies further: the bf16 sums and means read 2.2e-3 or more
# against the f32 limit, and with the mask left out the sums, means and
# attentions read 3.7e-2 or more.
READOUT_LIMITS = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
READOUT_WIDER_LIMITS = {
    ("BatchGlobalPooling(sum)", "large", torch.float32): 5e-5,
    ("BatchGlobalPooling(mean)", "large", torch.float32): 5e-5,
    ("Set2Set", "batch", torch.bfloat16): 4e-2,
    ("Set2Set", "large", torch.bfloat16): 4e-2,
}


def readout_limit(label: str, which: str, dtype) -> float:
    return READOUT_WIDER_LIMITS.get((label, which, dtype),
                                    READOUT_LIMITS[dtype])


def readouts_phase(device, timer) -> dict:
    """Every readout forward and backward on the card, in f32 and bf16, held
    against the same computation in f64 on the CPU (the inputs and weights
    of each type, widened) at a fixed limit (``readout_limit``); the CPU
    path in the same type is read against the f64 result too, and card
    against CPU is reported beside. Each error is of the largest entry (the
    parameters' gradients: of the largest entry of them all), for the
    output, the input's gradient and the parameters' gradients apart. A
    control reads each masked case on the card with its mask left out
    against the masked f64 result: how far a wrong result lies.
    Inputs: the encoder's output on one padded batch of the graph
    classification (its graph ids and node mask), scaled to a root mean
    square of 1 (at random weights it reaches 1e3, where the attention's
    ``tanh`` saturates and a one-unit change of an input moves the
    gradients by up to their whole size); and one graph of 100,000 nodes x
    128 features (a long softmax and long sums over the node axis). Rows 3
    and 7 tie every column's max, and the masks keep them."""
    import keras_geometric_tpu_torch as kgt

    name = "readouts_on_card"
    gc = example_module("graph_classification")
    graphs, _, classes = gc.make_dataset(GC_GRAPHS, GC_CLASSES, seed=0)
    model = gc.make_model(GC_HIDDEN, classes, device=device,
                          generator=torch.Generator(device).manual_seed(0))
    g, _, num_graphs = gc.batch_to_arrays(graphs[:GC_BATCH], GC_BATCH, device)
    with torch.no_grad():
        h = model.encoder(g.x, g.edge_index, edge_mask=g.edge_mask)
    encoder_abs_max = h.abs().max().item()
    h = h / h.pow(2).mean().sqrt()
    h[[3, 7]] = h.max(0).values + 1.0  # rows of graph 0 (10 nodes or more)
    rng = np.random.default_rng(23)
    big = rng.standard_normal((READOUT_NODES, READOUT_FEATS)).astype(
        np.float32)
    big[[3, 7]] = big.max(0) + 1.0
    big_mask = rng.random(READOUT_NODES) < 0.9
    big_mask[[3, 7]] = True
    inputs = {
        "batch": (h, g.node_mask, g.batch, num_graphs),
        "large": (torch.from_numpy(big).to(device),
                  torch.from_numpy(big_mask).to(device),
                  torch.zeros(READOUT_NODES, dtype=torch.int32,
                              device=device), 1),
    }
    gen = torch.Generator(device).manual_seed(1)
    reset_launch_counts()
    results, worst, failed = [], {}, []
    for which, (x, mask, batch, n_graphs) in inputs.items():
        feats = x.shape[1]
        for dtype in (torch.float32, torch.bfloat16):
            kind = str(dtype)[6:]
            cases = []
            for masked in (False, True):
                for pooling in ("mean", "max", "sum"):
                    cases += [
                        (f"GlobalPooling({pooling})", masked,
                         kgt.GlobalPooling(pooling), False),
                        (f"BatchGlobalPooling({pooling})", masked,
                         kgt.BatchGlobalPooling(pooling), True)]
                cases += [
                    ("AttentionPooling", masked, kgt.AttentionPooling(
                        input_dim=feats, generator=gen, device=device),
                     False),
                    ("Set2Set", masked, kgt.Set2Set(
                        8, processing_steps=3, input_dim=feats,
                        generator=gen, device=device), False)]
            xd = x.to(dtype)
            for label, masked, module, batched in cases:
                module = module.to(dtype).eval()
                cot = []

                def copy_to(dev, dt):
                    if not list(module.parameters()):
                        return module
                    out = type(module).from_config(
                        module.get_config(), input_dim=feats, device=dev,
                        dtype=dt).eval()
                    out.load_state_dict({k: v.to(dev, dt) for k, v in
                                         module.state_dict().items()})
                    return out

                def fwd_bwd(mod, v, masked=masked, batched=batched):
                    dev = v.device
                    v = v.detach().clone().requires_grad_()
                    nm = mask.to(dev) if masked else None
                    if batched:
                        out = mod(v, batch.to(dev), n_graphs, node_mask=nm)
                    else:
                        out = mod(v, node_mask=nm)
                    if not cot:
                        cot.append(torch.from_numpy(rng.standard_normal(
                            tuple(out.shape))).to(dtype))
                    out.backward(cot[0].to(dev, out.dtype))
                    grads = [p.grad for p in mod.parameters()]
                    for p in mod.parameters():
                        p.grad = None
                    return out.detach(), v.grad, grads

                def on_host(result):
                    out, dx, grads = result
                    return (out.double().cpu(), dx.double().cpu(),
                            [g.double().cpu() for g in grads])

                x_cpu = xd.cpu()
                card = on_host(fwd_bwd(module, xd))
                host = on_host(fwd_bwd(copy_to("cpu", dtype), x_cpu))
                ref = on_host(fwd_bwd(copy_to("cpu", torch.float64),
                                      x_cpu.double()))
                errs = {"card_vs_f64": readout_errors(card, ref),
                        "cpu_vs_f64": readout_errors(host, ref),
                        "card_vs_cpu": readout_errors(card, host)}
                if masked:
                    errs["mask_dropped_vs_f64"] = readout_errors(on_host(
                        fwd_bwd(module, xd, masked=False)), ref)
                limit = readout_limit(label, which, dtype)
                what = (f"{label} on {which}, {kind}, "
                        f"{'masked' if masked else 'no mask'}")
                if not max(errs["card_vs_f64"]) <= limit:
                    failed.append(f"{what}: {max(errs['card_vs_f64']):.3e}")
                entry = dict(readout=label, input=which, dtype=kind,
                             masked=masked, limit=limit,
                             **{k: max(v) for k, v in errs.items()},
                             by_part={k: dict(zip(("out", "dx", "params"), v))
                                      for k, v in errs.items()})
                if which == "large" and masked:
                    entry["ms_fwd_bwd"] = timer.cold_ms(
                        lambda: fwd_bwd(module, xd), iters=10)
                results.append(entry)
                key = f"{label}/{kind}"
                worst[key] = {k: max(entry[k], worst.get(key, {}).get(k, 0.0))
                              for k in errs}
    counts = launch_counts()
    emit(name, comparisons=len(results), worst=worst, cases=results,
         card_vs_cpu_within={str(d)[6:]: sum(
             e["card_vs_cpu"] <= READOUT_LIMITS[d] for e in results
             if e["dtype"] == str(d)[6:]) for d in READOUT_LIMITS},
         batch_shape=list(h.shape), encoder_abs_max=encoder_abs_max,
         batch_abs_max=h.abs().max().item(),
         large_shape=[READOUT_NODES, READOUT_FEATS])
    check(not failed, f"{name}: the card's result is past its limit against "
          f"f64 (of the largest entry): {failed}")
    check(not any(counts.values()), f"{name}: hand-written kernels "
          f"launched by the readouts: {counts}")
    return counts


def step1_of(model, step) -> tuple:
    """Loss and gradients (on the host) of one step of ``step``."""
    loss = step().item()
    return loss, {k: p.grad.detach().double().cpu()
                  for k, p in model.named_parameters()}


def step1_held(what, got, want) -> dict:
    """Step 1 against step 1 by another path: the loss within 1e-4 of its
    magnitude, every gradient within 2e-4 of its largest entry."""
    (loss, grads), (want_loss, want_grads) = got, want
    check(math.isfinite(loss) and abs(loss - want_loss)
          <= 1e-4 * max(1.0, abs(want_loss)),
          f"{what}: step-1 loss {loss} vs {want_loss}")
    grad_err = 0.0
    for key, want_grad in want_grads.items():
        err = relative_err(grads[key], want_grad)
        check(math.isfinite(err) and err <= 2e-4,
              f"{what}: step-1 gradient of {key}: {err:.3e} of its largest "
              f"entry")
        grad_err = max(grad_err, err)
    return dict(loss=loss, loss_other=want_loss, grad_rel_err=grad_err)


def counted_twin_run(what, twin, step, per_step) -> dict:
    """``TWIN_STEPS`` steps of a twin's training run on the card, its launch
    counts zeroed just before and read just after; each kernel launched
    ``per_step`` times a step, the losses finite and falling."""
    expected, expected_modes = per_step
    torch.cuda.synchronize()
    reset_launch_counts()
    losses = [step() for _ in range(TWIN_STEPS)]
    torch.cuda.synchronize()
    counts, modes = launch_counts(), mode_launch_counts()
    losses = [float(l) for l in losses]
    check(counts == {k: expected.get(k, 0) * TWIN_STEPS for k in counts},
          f"{what}: launch counts {counts}, expected {expected} a step")
    check(modes == {k: expected_modes.get(k, 0) * TWIN_STEPS for k in modes},
          f"{what}: mode launch counts {modes}, expected {expected_modes} "
          f"a step")
    check(all(map(math.isfinite, losses)) and
          sum(losses[-3:]) < sum(losses[:3]),
          f"{what}: losses not finite or not falling: {losses}")
    return dict(twin=twin, steps=TWIN_STEPS, losses=losses,
                launches=counts, mode_launches=modes)


def time_twin_band_cases(device, timer, ctx) -> list:
    """The band kernel on its f32 (FMA) route at the banded twin's shapes:
    its band, layer 1 at F = 64 and layer 2 at F = 16, held against its
    plain version in a guarded output (``band_guarded``) and timed as the
    kernels line times the bf16 routes (kernel, plain version, ``torch.bmm``
    over the row blocks with the ``x`` windows gathered beforehand, the
    bound from bytes and f32 operations)."""
    from keras_geometric_tpu_torch.kernels import band_cuda as B
    from keras_geometric_tpu_torch.utils.profiling import (
        H100_BYTES_PER_S,
        H100_F32_OPS_PER_S,
    )

    replaces = replaced_tpu_kernels()
    plan = ctx.band
    n, window, rb = plan.n_pad, plan.window, plan.row_block
    nb = n // rb
    args = (plan.band, plan.base_idx, window, rb)
    gen = torch.Generator(device=device).manual_seed(13)
    entries = []
    for layer, f in (("layer 1", 64), ("layer 2", 16)):
        x = torch.randn(n, f, generator=gen, device=device)
        route = B.band_route(f, window, rb, x.dtype)
        what = (f"banded twin {layer}: n_pad={n} W={window} F={f} f32 "
                f"band edges={plan.num_edges} route={route}")
        err = band_guarded(route, x, args, what)
        rows = (plan.base_idx.long() * (window // 2))[:, None] + torch.arange(
            window, device=device)
        windows = x.index_select(0, rows.reshape(-1)).view(nb, window, f)
        band3 = plan.band.view(nb, rb, window)
        # band once, x once, out once, base_idx; f32 operations
        t_bytes = (n * window * 4 + 2 * n * f * 4 + nb * 4) \
            / H100_BYTES_PER_S * 1e3
        t_ops = 2 * n * window * f / H100_F32_OPS_PER_S * 1e3
        entries.append({
            "name": "band_spmm", "route": "cuda",
            "source": SOURCES[REPLACES["band_spmm"][0]],
            "replaces": replaces["band_spmm"], "path": "examples_torch",
            "shape": what, "mode": route, "launches": 0,
            "max_abs_err": err,
            "ms": timer.cold_ms(lambda: B.band_matmul(x, *args), iters=10),
            "plain_ms": timer.cold_ms(lambda: B.band_matmul_plain(x, *args),
                                      iters=5, warmup=1),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": timer.cold_ms(lambda: torch.bmm(band3, windows),
                                        iters=10),
            "library": "torch.bmm over the row blocks, x windows gathered "
                       "beforehand",
            "parent_ms": None, "parent": BAND_PARENT})
        del windows
    return entries


def twins_on_card(device, timer) -> tuple:
    """The twins whose path runs hand-written kernels, in process through
    their own functions: ``node_classification.py`` on Cora and on PubMed
    (K1, K2), ``locality_banded_gcn.py`` at its 20,000 nodes (K11 on its
    f32 route, K1). For each: step 1 through the kernels against step 1
    through their plain versions on the card (the same weights and dropout
    draws), step 1 on the card against the same step on the CPU path (the
    same weights, dropout off: the twin's CPU path takes the edge list, the
    banded twin a context on the CPU), then a counted run of the twin's own
    configuration; last, the band kernel timed at the banded twin's shapes.
    Returns the counted runs' summed launch and mode counts and the band
    kernel's entries for the kernels line."""
    cpu = torch.device("cpu")
    runs, counts, modes = [], {}, {}

    def add(run):
        runs.append(run)
        for total, part in ((counts, run["launches"]),
                            (modes, run["mode_launches"])):
            for k, v in part.items():
                total[k] = total.get(k, 0) + v

    nc = example_module("node_classification")
    for dataset in ("cora", "pubmed"):
        what = f"examples_torch: node_classification.py --dataset {dataset}"
        args = nc.parse_args(["--dataset", dataset])
        graph, classes = nc.load_graph(dataset)
        on_card, on_cpu = (nc.graph_tensors(graph, device),
                           nc.graph_tensors(graph, cpu))
        ctx = nc.prepare_context(graph, device)
        check(ctx is not None, f"{what}: no context on the card")
        in_dim = on_card["x"].shape[1]

        def build(dev, t, context, dropout, optimizer=None):
            gen = torch.Generator(device=dev).manual_seed(0)
            model = nc.make_model(in_dim, args.hidden, classes, dropout,
                                  context=context is not None, device=dev,
                                  generator=gen)
            forward = nc.make_forward(model, t["x"], t["edge_index"],
                                      context, gen)
            opt = (optimizer or (lambda m: torch.optim.SGD(
                m.parameters(), lr=0.0)))(model)
            return model, nc.make_train_step(model, forward, t["y"],
                                             t["train_mask"], opt)

        vs_plain = step1_held(
            f"{what}: kernels vs their plain versions",
            step1_of(*build(device, on_card, ctx, args.dropout)),
            step1_of(*build(device, on_card, PlainContext(ctx),
                            args.dropout)))
        card = build(device, on_card, ctx, 0.0)
        host = build(cpu, on_cpu, None, 0.0)
        host[0].load_state_dict({k: v.cpu() for k, v in
                                 card[0].state_dict().items()})
        vs_cpu = step1_held(f"{what}: card vs the CPU path",
                            step1_of(*card), step1_of(*host))
        del card, host
        _, step = build(device, on_card, ctx, args.dropout,
                        lambda m: torch.optim.AdamW(
                            m.parameters(), lr=args.lr,
                            weight_decay=args.weight_decay))
        run = counted_twin_run(what, "node_classification.py", step,
                               TWIN_LAUNCHES["node_classification"])
        add(dict(run, args=["--dataset", dataset],
                 nodes=int(on_card["x"].shape[0]),
                 edges=int(on_card["edge_index"].shape[1]), features=in_dim,
                 stream_edges=ctx.num_real_edges,
                 step1_vs_plain=vs_plain, step1_vs_cpu=vs_cpu))

    lb = example_module("locality_banded_gcn")
    what = "examples_torch: locality_banded_gcn.py"
    args = lb.parse_args([])
    graph = lb.make_graph(args.nodes)
    ctx, x, y, mask = lb.prepare(graph, device)
    ctx_cpu, x_cpu, y_cpu, mask_cpu = lb.prepare(graph, cpu)
    check(ctx.num_band_edges > 0 and ctx.band.band.dtype == torch.float32,
          f"{what}: no f32 band on the card")

    def build_banded(dev, context, xs, ys, ms, optimizer=None):
        enc = lb.make_encoder(dev, torch.Generator(device=dev).manual_seed(0))
        opt = (optimizer or (lambda m: torch.optim.SGD(
            m.parameters(), lr=0.0)))(enc)
        return enc, lb.make_train_step(enc, opt, context, xs, ys, ms)

    vs_plain = step1_held(
        f"{what}: kernels vs their plain versions",
        step1_of(*build_banded(device, ctx, x, y, mask)),
        step1_of(*build_banded(device, PlainContext(ctx), x, y, mask)))
    card = build_banded(device, ctx, x, y, mask)
    host = build_banded(cpu, ctx_cpu, x_cpu, y_cpu, mask_cpu)
    host[0].load_state_dict({k: v.cpu() for k, v in
                             card[0].state_dict().items()})
    vs_cpu = step1_held(f"{what}: card vs the CPU path", step1_of(*card),
                        step1_of(*host))
    del card, host, ctx_cpu
    _, step = build_banded(device, ctx, x, y, mask, lambda m: torch.optim.Adam(
        m.parameters(), lr=1e-2))
    run = counted_twin_run(what, "locality_banded_gcn.py", step,
                           TWIN_LAUNCHES["locality_banded_gcn"])
    add(dict(run, args=[], nodes=args.nodes, padded_nodes=ctx.num_nodes,
             band_edges=ctx.num_band_edges, residual_edges=ctx.num_real_edges,
             features=int(x.shape[1]), step1_vs_plain=vs_plain,
             step1_vs_cpu=vs_cpu))
    entries = time_twin_band_cases(device, timer, ctx)
    emit("examples_torch_in_process", runs=runs, band_kernel=entries)
    return counts, modes, entries


def examples_phase() -> dict:
    """Each twin of ``examples/`` as a subprocess on the card (four at a
    time), at the fewest epochs its flags allow; every exit code 0, the
    whole phase under three minutes."""
    from concurrent.futures import ThreadPoolExecutor

    name = "examples_torch"
    env = {**os.environ, "PYTHONPATH": str(ROOT)}

    def run(script, args):
        start = time.perf_counter()
        try:  # a child past its time is killed, and the phase fails
            proc = subprocess.run(
                [sys.executable, str(ROOT / "examples_torch" / script),
                 *args], cwd=ROOT, env=env, capture_output=True, text=True,
                timeout=EXAMPLES_SECONDS)
        except subprocess.TimeoutExpired:
            code, out, err = "timeout", "", ""
        else:
            code, out, err = proc.returncode, proc.stdout, proc.stderr
        return {"script": script, "args": list(args), "exit_code": code,
                "seconds": time.perf_counter() - start,
                "last_lines": out.strip().splitlines()[-3:],
                "stderr_tail": err.strip().splitlines()[-5:] if code else []}

    start = time.perf_counter()
    with ThreadPoolExecutor(max_workers=4) as pool:
        runs = list(pool.map(lambda a: run(*a), EXAMPLE_RUNS))
    wall = time.perf_counter() - start
    emit(name, runs=runs, wall_seconds=wall)
    for r in runs:
        check(r["exit_code"] == 0, f"{name}: {r['script']} {r['args']} "
              f"exited {r['exit_code']}: {r['stderr_tail']}")
    check(wall < EXAMPLES_SECONDS, f"{name}: took {wall:.1f} s")
    return {"wall_seconds": wall}


# ---------------------------------------------------------------------------
# Partitioned full-graph training on torch.distributed
# ---------------------------------------------------------------------------

DIST_STEPS = 20
DIST_PARTS = 4  # the partitions of distributed_partitions_arxiv_shape
# Their processes' time limit (they take about 25 s on one card).
DIST_RANKS_SECONDS = 240
# Launches per step, predicted from the bodies (parallel/spmd.py,
# kernel_plan.py, attend_plan.py) before the first run. GCN: per layer the
# overlapped spmm runs the fused-gather scatter's row walk over the local
# and the remote stream, forward and (x @ W needs its gradient) backward.
# GATv2: per layer the fused forward without the score cache, rho and the
# receiver backward recomputing the scores, and the sender finish.
DIST_GCN_PER_STEP = {"gather_scatter_sum_sorted": 8}
DIST_GCN_MODES = {"gather_scatter_sum_sorted(rows)": 8}
DIST_GAT_PER_STEP = {"sddmm_stats_agg_sorted": 2, "attend_rho_sorted": 2,
                     "attend_recv_bwd_full_sorted": 2,
                     "gather_scatter_sum_sorted": 2}
DIST_GAT_MODES = {"sddmm_stats_agg_sorted(emit_scores=False)": 2,
                  "attend_rho_sorted(scores=None)": 2,
                  "attend_recv_bwd_full_sorted(scores=None)": 2}
# The bf16 limits of step 1 (PERF.md section 2): the loss, and each gradient
# against its largest entry.
BF16_LOSS_TOL, BF16_GRAD_TOL = 2e-2, 5e-2


@contextlib.contextmanager
def one_rank_group():
    """A process group of one rank on the card (NCCL), through a
    ``file://`` store under the git-ignored ``build/``, destroyed when the
    block ends."""
    import datetime

    import torch.distributed as dist

    store = ROOT / "build" / f"dist_store_{os.getpid()}"
    store.parent.mkdir(exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group(
        "nccl", init_method=f"file://{store}", rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=120))
    try:
        yield
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)


def held_step1(what, got, want):
    """Step 1's loss and gradients against another path's, at the bf16
    limits; returns the gradients' largest error relative to their scale."""
    (loss, grads), (w_loss, w_grads) = got, want
    check(math.isfinite(loss) and abs(loss - w_loss) <= BF16_LOSS_TOL,
          f"{what}: step-1 loss {loss} vs {w_loss}")
    worst = 0.0
    check(set(grads) == set(w_grads), f"{what}: parameter names differ")
    for key, wg in w_grads.items():
        scale = wg.abs().max().item()
        err = (grads[key] - wg).abs().max().item()
        check(math.isfinite(err) and err <= BF16_GRAD_TOL * max(scale, 1e-12),
              f"{what}: step-1 gradient of {key}: err {err:.3e} against "
              f"scale {scale:.3e}")
        worst = max(worst, err / max(scale, 1e-12))
    return worst


def kernel_entry(timer, replaces, name, path, shape, kernel, plain, err,
                 nbytes, ops, *, mode=None, library=None, extra=None,
                 plain_iters=5, no_reuse_bytes=None):
    """One entry of the kernels line: the kernel's and its plain version's
    times, its bound from bytes and operations, and the library call's time
    (``library``: ``(label, ms)``) where one computes the same function.
    ``plain_iters``: the plain version's timed calls, after one to warm up
    (none when it is 1: a plain version run block by block, just run for
    the error). ``no_reuse_bytes``: the bytes moved if every gathered row
    came from device memory, for the bound they give."""
    from keras_geometric_tpu_torch.utils.profiling import (
        H100_BYTES_PER_S,
        H100_F32_OPS_PER_S,
    )

    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_OPS_PER_S * 1e3
    library_ms, label = None, "none: no single PyTorch call computes this"
    if library is not None:
        label, library_ms = library
    entry = {
        "name": name, "route": "cuda", "source": SOURCES[REPLACES[name][0]],
        "replaces": replaces[name], "path": path, "shape": shape,
        "launches": 0, "max_abs_err": err, "ms": timer.cold_ms(kernel,
                                                               iters=10),
        "plain_ms": timer.cold_ms(plain, iters=plain_iters,
                                  warmup=int(plain_iters > 1)),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms, "library": label, **(extra or {})}
    if mode is not None:
        entry["mode"] = mode
    if no_reuse_bytes is not None:
        entry["bound_ms_if_gather_not_reused"] = max(
            no_reuse_bytes / H100_BYTES_PER_S * 1e3, t_ops)
    return entry


def stream_entries(timer, replaces, path, label, st, source, dtype, what):
    """The fused-gather scatter's row walk (K1) over one stream of a kernel
    plan (``st``: a ``StreamShard``; ``source``: its gather source), against
    its plain version, with ``torch.sparse.mm`` beside it."""
    from keras_geometric_tpu_torch.kernels import spmm_cuda as K

    w = st.weight.to(dtype)
    args = (source, st.senders, st.receivers, st.row_ptr, st.num_local)
    kernel = lambda: K.gather_scatter_sum_sorted(*args, weights=w,
                                                 pieces=False)
    plain = lambda: K.gather_scatter_sum_sorted_plain(
        source, st.senders, st.receivers, st.num_local, weights=w)
    mass = K.gather_scatter_sum_sorted_plain(
        source.float().abs(), st.senders, st.receivers, st.num_local,
        weights=w.float().abs())
    err = compare(kernel(), plain(), mass, dtype, what)
    s_rows, f = source.shape
    e, es = st.senders.shape[0], source.element_size()
    nbytes = (s_rows + st.num_local) * f * es + e * (4 + es) + \
        (st.num_local + 1) * 4
    library_ms, note = sparse_library_ms(
        timer, st.receivers, st.senders, w, (st.num_local, s_rows), source)
    return [kernel_entry(
        timer, replaces, "gather_scatter_sum_sorted", path,
        f"{label}: E={e} (real {st.num_real}) L={st.num_local} S={s_rows} "
        f"F={f} {str(dtype)[6:]}", kernel, plain, err, nbytes, 2 * e * f,
        mode="rows", library=("torch.sparse.mm on a CSR tensor", library_ms),
        extra={"library_note": note} if note else None)]


def table_attend_entries(timer, replaces, path, label, ctx, heads, f, dtype,
                         gen, device):
    """The no-cache attention kernels and the sender finish over a table
    context (``[h_local | halo]`` rows, ``attend_plan``), each against its
    plain version (``modes_case``) and timed."""
    from keras_geometric_tpu_torch.kernels import attend_cuda as A
    from keras_geometric_tpu_torch.kernels import spmm_cuda as K

    n, e, d = ctx.num_nodes, ctx.senders.shape[0], heads * f
    es = 2 if dtype == torch.bfloat16 else 4
    ht, att, gout, _ = attend_inputs(gen, n, heads, f, dtype, e, False,
                                     device)
    graph = (ctx.senders, ctx.receivers, ctx.row_ptr)
    valid = ctx.edge_mask
    errs = modes_case(graph + (valid,), ht, att, gout, None,
                      f"{path} {label}")
    out, m, l = A.sddmm_stats_agg_sorted(ht, *graph, att, edge_valid=valid,
                                         emit_scores=False)
    rho = A.attend_rho_sorted(gout, None, m, l, ht, *graph, att=att,
                              edge_valid=valid)
    _, _, v = A.attend_recv_bwd_full_sorted(ht, gout, *graph, att, None, m,
                                            l, rho, edge_valid=valid)
    del out
    nodes, stats = n * d * es, 2 * n * heads * 4
    index = e * 4 + (n + 1) * 4
    recompute = dict(att=att, edge_valid=valid)
    finish = (v, ctx.bwd_perm, ctx.senders_sorted, ctx.row_ptr_bwd, n)
    shape = f"{label}: E={e} N={n} H={heads} F={f} {str(dtype)[6:]}"
    cases = [
        ("sddmm_stats_agg_sorted", "emit_scores=False",
         lambda: A.sddmm_stats_agg_sorted(ht, *graph, att, edge_valid=valid,
                                          emit_scores=False),
         lambda: A.sddmm_stats_agg_sorted_plain(
             ht, *graph, att, edge_valid=valid, emit_scores=False),
         2 * nodes + index + e + stats + d * es, 8 * e * d),
        ("attend_rho_sorted", "scores=None",
         lambda: A.attend_rho_sorted(gout, None, m, l, ht, *graph,
                                     **recompute),
         lambda: A.attend_rho_sorted_plain(gout, None, m, l, ht, *graph,
                                           **recompute),
         2 * nodes + index + e + stats + n * heads * 4 + d * es, 6 * e * d),
        ("attend_recv_bwd_full_sorted", "scores=None",
         lambda: A.attend_recv_bwd_full_sorted(ht, gout, *graph, att, None,
                                               m, l, rho, edge_valid=valid),
         lambda: A.attend_recv_bwd_full_sorted_plain(
             ht, gout, *graph, att, None, m, l, rho, edge_valid=valid),
         3 * nodes + index + e + stats + n * heads * 4 + d * (es + 4)
         + e * d * es, 16 * e * d),
        # v read once, the output written, the sender-order streams.
        ("gather_scatter_sum_sorted", None,
         lambda: K.gather_scatter_sum_sorted(*finish),
         lambda: K.gather_scatter_sum_sorted_plain(*finish[:3], n),
         e * d * es + nodes + 2 * e * 4 + (n + 1) * 4, 2 * e * d),
    ]
    entries = []
    for name, mode, kernel, plain, nbytes, ops in cases:
        key = (f"{name}({mode})" if mode else
               "gather_scatter_sum_sorted(sender finish)")
        entries.append(kernel_entry(
            timer, replaces, name, path, shape, kernel, plain, errs[key],
            nbytes, ops, mode=mode,
            extra=piece_walk_fields(name, ctx.row_ptr_bwd
                                    if mode is None else ctx.row_ptr)))
    del ht, gout, m, l, rho, v, finish, cases
    torch.cuda.empty_cache()
    return entries


def distributed_training_phase(device, timer, workload, arxiv_model,
                               gat_arxiv_model, replaces):
    """``train_distributed_arxiv_shape``: the distributed step and
    evaluation function on a mesh of one card. Returns the run's launches,
    mode launches and kernel entries."""
    import torch.distributed as dist

    from keras_geometric_tpu_torch import parallel as par
    from keras_geometric_tpu_torch.parallel import attend_plan as par_ap
    from keras_geometric_tpu_torch.parallel import spmd as par_spmd
    from keras_geometric_tpu_torch.training import (
        make_node_classification_step,
    )
    from keras_geometric_tpu_torch.utils import timed_steps

    name = "train_distributed_arxiv_shape"
    phase_start = time.perf_counter()
    bf16 = torch.bfloat16
    make_gen = lambda: torch.Generator(device=device).manual_seed(7)
    adam = lambda model: torch.optim.Adam(model.parameters(), lr=1e-2)
    counts, modes, entries, runs = {}, {}, [], {}
    with one_rank_group():
        mesh = par.make_mesh((1,), device_type="cuda")
        check(dist.get_backend() == "nccl" and mesh.device_type == "cuda",
              f"{name}: the mesh is not an NCCL mesh on the card")
        gcn_ctx, gcn_x, gcn_y, gcn_mask = workload("arxiv")[:4]
        gat_ctx, gat_x, gat_y, gat_mask = workload("gat_arxiv")[:4]
        x, edges, y = arxiv_arrays(symmetric=True)
        start = time.perf_counter()
        pg = par.partition_graph(edges, ARXIV_NODES, 1, gcn_normalize=True,
                                 add_self_loops=True)
        kp = par.build_kernel_plan(pg)
        gcn_plan_s = time.perf_counter() - start
        masks = {"train_mask": np.ones(ARXIV_NODES, bool)}
        gcn_data = par.shard_partitioned_graph(pg, mesh, x=x, y=y,
                                               masks=masks, kernel_plan=kp)
        gx, gedges, gy = gat_arxiv_arrays()
        start = time.perf_counter()
        gpg = par.partition_graph(gedges, ARXIV_NODES, 1, add_self_loops=True)
        gkp = par.build_kernel_plan(gpg)
        gap = par_ap.build_attend_plan(gpg)
        gat_plan_s = time.perf_counter() - start
        start = time.perf_counter()
        gat_data = par.shard_partitioned_graph(
            gpg, mesh, x=gx, y=gy, masks=masks, kernel_plan=gkp,
            attend_plan=gap)
        gat_shard_s = time.perf_counter() - start
        check(gat_data["ap"].context.num_real_edges
              == GAT_ARXIV_EDGES + ARXIV_NODES,
              f"{name}: the attend plan's table has the wrong edge count")

        def dist_gcn_model():
            model = par.distributed_gcn_encoder(
                (HIDDEN, ARXIV_CLASSES), input_dim=ARXIV_FEATS, device=device)
            model.load_state_dict(arxiv_model().state_dict())
            return model

        def dist_step1(make_model, data):
            model = make_model()
            step = par.make_distributed_train_step(
                model, torch.optim.SGD(model.parameters(), lr=0.0), mesh,
                compute_dtype=bf16, generator=make_gen())
            loss = step(data).item()
            return loss, {k: p.grad.detach().clone()
                          for k, p in model.named_parameters()}

        # The data's kernel (and attend) shard picks the kernelized body.
        for run, make_model, data, single, single_modes, per_step, \
                per_mode in (
                ("gcn", dist_gcn_model, gcn_data,
                 (arxiv_model, gcn_ctx, gcn_x, gcn_y, gcn_mask),
                 ("permute", True), DIST_GCN_PER_STEP, DIST_GCN_MODES),
                ("gatv2", gat_arxiv_model, gat_data,
                 (gat_arxiv_model, gat_ctx, gat_x, gat_y, gat_mask),
                 ("permute", False), DIST_GAT_PER_STEP, DIST_GAT_MODES)):
            # Step 1 against the single-device port at the same weights
            # (GCN: its densified self-loops against the streamed ones here;
            # GATv2: in the no-cache mode the distributed body runs).
            got = dist_step1(make_model, data)
            with attend_modes(*single_modes):
                want = first_step(single[0], make_gen, *single[1:], bf16)
            grad_err = held_step1(f"{name} {run}", got, want)

            model = make_model()
            step = par.make_distributed_train_step(
                model, adam(model), mesh, compute_dtype=bf16,
                generator=make_gen())
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            for key in par_spmd.FALLBACK_COUNTS:
                par_spmd.FALLBACK_COUNTS[key] = 0
            losses = [step(data) for _ in range(DIST_STEPS)]
            timed = []

            def timed_step():
                timed.append(1)
                return step(data)

            step_ms = 1e3 * timed_steps(timed_step, k_lo=2, k_hi=12,
                                        trials=2)
            torch.cuda.synchronize()
            run_counts, run_modes = launch_counts(), mode_launch_counts()
            total = DIST_STEPS + len(timed)
            losses = [l.item() for l in losses]
            check(all(math.isfinite(l) for l in losses) and
                  losses[-1] < losses[0],
                  f"{name} {run}: loss not finite or not falling: {losses}")
            expected = {k: per_step.get(k, 0) * total for k in run_counts}
            check(run_counts == expected, f"{name} {run}: launch counts "
                  f"{run_counts}, expected {expected}")
            expected = {k: per_mode.get(k, 0) * total for k in run_modes}
            check(run_modes == expected, f"{name} {run}: mode launch counts "
                  f"{run_modes}, expected {expected}")
            check(not any(par_spmd.FALLBACK_COUNTS.values()),
                  f"{name} {run}: a fallback was taken: "
                  f"{par_spmd.FALLBACK_COUNTS}")
            peak_mb = torch.cuda.max_memory_allocated() / 2**20
            for k, v in run_counts.items():
                counts[k] = counts.get(k, 0) + v
            for k, v in run_modes.items():
                modes[k] = modes.get(k, 0) + v
            evaluate = par.make_distributed_eval_fn(
                model, mesh, compute_dtype=bf16)
            accuracy = evaluate(data, data["train_mask"]).item()
            check(0.0 <= accuracy <= 1.0, f"{name} {run}: accuracy "
                  f"{accuracy}")
            traced = profile_steps(lambda: step(data), iters=5, top=8)
            # The single-device run of the same model, timed and traced in
            # this call beside it.
            s_model = single[0]()
            s_step = make_node_classification_step(
                s_model, adam(s_model), compute_dtype=bf16,
                generator=make_gen())
            s_args = single[2:]
            with attend_modes(*single_modes):
                s_fn = lambda: s_step(s_args[0], None, *s_args[1:],
                                      context=single[1])
                single_ms = 1e3 * timed_steps(s_fn, k_lo=2, k_hi=12,
                                              trials=2)
                single_traced = profile_steps(s_fn, iters=5, top=4)
            runs[run] = dict(
                steps=total, losses=losses, step1_loss=got[0],
                step1_loss_single_device=want[0],
                step1_grad_rel_err_vs_single_device=grad_err,
                launches_per_step=per_step, launches=run_counts,
                mode_launches_per_step=per_mode, mode_launches=run_modes,
                fallbacks=dict(par_spmd.FALLBACK_COUNTS), step_ms=step_ms,
                peak_memory_mb=peak_mb, eval_accuracy=accuracy,
                profile=traced, single_device_step_ms=single_ms,
                single_device_profile=single_traced)
            del model, step, s_model, s_step, evaluate
            torch.cuda.empty_cache()

        # The kernels at the shapes of this path: the GCN's local stream at
        # both layers (F = 256: the distributed layer transforms before it
        # propagates), the attention over the table context at layer 1.
        gen = torch.Generator(device=device).manual_seed(31)
        st = gcn_data["kp"].loc
        for layer, f in (("layer 1", HIDDEN), ("layer 2", ARXIV_CLASSES)):
            h = torch.randn(st.num_source_rows, f, generator=gen,
                            device=device).to(bf16)
            entries += stream_entries(
                timer, replaces, name, f"GCN local stream, {layer}", st, h,
                bf16, f"{name} local stream {layer}")
        entries += table_attend_entries(
            timer, replaces, name, "GATv2 table, layer 1",
            gat_data["ap"].context, GAT_ARXIV_HEADS, GAT_ARXIV_DIMS[0], bf16,
            gen, device)
        del gcn_data, gat_data
    check(not dist.is_initialized(), f"{name}: the process group was not "
          "destroyed")
    emit(name, runs=runs, world_size=1, mesh=[1], backend="nccl",
         group_destroyed=True, gcn_plan_seconds=gcn_plan_s,
         gat_plan_seconds=gat_plan_s, gat_shard_seconds=gat_shard_s,
         halo_size=kp.halo_size, remote_edges=int(kp.rem.num_real[0]),
         seconds=time.perf_counter() - phase_start)
    torch.cuda.empty_cache()
    return counts, modes, entries


def halo_report(pg, plan):
    """A partition's halo size, comm fraction and edge split."""
    owners = pg.senders_global // pg.nodes_per_part
    remote = pg.edge_mask & (owners != np.arange(pg.num_parts)[:, None])
    return dict(halo_size=plan.halo_size, comm_fraction=plan.comm_fraction,
                remote_edge_fraction=float(remote.sum() / pg.edge_mask.sum()),
                edges=int(pg.edge_mask.sum()), parts=pg.num_parts,
                nodes_per_part=pg.nodes_per_part)


def partition_inputs(device, n_pad):
    """``distributed_partitions_arxiv_shape``'s inputs over the ``n_pad``
    global rows, drawn from one seed: the same values in every process that
    calls this. Returns the spmm inputs and cotangents (bf16, F = 128 / 40),
    the max's (f32, F = 128 / 256; columns of distinct values), the
    attention's ``(ht, att, g)`` and the generator, drawn that far."""
    bf16 = torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(41)
    rand = lambda *shape, dtype=torch.float32: torch.randn(
        *shape, generator=gen, device=device).to(dtype)
    inputs = {f: (rand(n_pad, f, dtype=bf16), rand(n_pad, f, dtype=bf16))
              for f in (ARXIV_FEATS, ARXIV_CLASSES)}
    # Columns of distinct values: no two senders tie, so the single-device
    # kernel rule (each tied element gets the whole cotangent) and the
    # distributed one (torch.maximum splits a tie across the two streams)
    # give the same gradients; the CPU tests pin both rules on ties.
    distinct = lambda f: (torch.rand(f, n_pad, generator=gen, device=device)
                          .argsort(dim=1).T.float() / n_pad - 0.5)
    max_inputs = {f: (distinct(f).contiguous(), rand(n_pad, f))
                  for f in (128, 256)}
    heads, f_att = GAT_ARXIV_HEADS, GAT_ARXIV_DIMS[0]
    ht = (0.5 * rand(n_pad, heads * f_att)).to(bf16)
    att = (0.3 * rand(heads, f_att)).to(bf16)
    g_att = rand(n_pad, heads * f_att, dtype=bf16)
    return inputs, max_inputs, (ht, att, g_att), gen


def partition_rank(rank, store, out_dir):
    """One rank of ``distributed_partitions_arxiv_shape``, a process of its
    own on the card: its partition's public per-rank bodies
    (``spmm_local_overlapped``, ``pooled_max_local``, ``attend_local``),
    forward and backward, over a gloo group of ``DIST_PARTS`` ranks, whose
    all-to-all carries the halo rows between the processes (NCCL takes one
    rank a card). Writes its rows of every output and gradient, its
    ``d att`` and the launches of the run to ``out_dir``."""
    import datetime
    import traceback

    import torch.distributed as dist

    from keras_geometric_tpu_torch import parallel as par
    from keras_geometric_tpu_torch.kernels import _build
    from keras_geometric_tpu_torch.parallel import attend_plan as par_ap
    from keras_geometric_tpu_torch.parallel import kernel_plan as par_kp
    from keras_geometric_tpu_torch.parallel.mesh import local_device

    out = pathlib.Path(out_dir)
    try:
        _build.load_libraries(sorted(SOURCES))  # the parent built them
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank,
            world_size=DIST_PARTS, timeout=datetime.timedelta(seconds=120))
        mesh = par.make_mesh((DIST_PARTS,), device_type="cuda")
        group, device = mesh.get_group("graph"), local_device(mesh)
        with open(out / "payload.pkl", "rb") as f:
            kp, ap = pickle.load(f)
        kshard = par_kp.plan_device_data(kp, rank, device)
        tshard = par_ap.plan_device_data(ap, rank, device)
        L = kp.nodes_per_part
        rows = slice(rank * L, (rank + 1) * L)
        inputs, max_inputs, (ht, att, g_att), _ = partition_inputs(
            device, DIST_PARTS * L)
        result = {}
        torch.cuda.synchronize()
        dist.barrier()
        reset_launch_counts()
        for f, (h, g) in inputs.items():
            x = h[rows].clone().requires_grad_()
            o = par_kp.spmm_local_overlapped(x, kshard, group=group)
            o.backward(g[rows])
            result[f"spmm_F{f}"] = (o.detach(), x.grad)
        for f, (h, g) in max_inputs.items():
            x = h[rows].clone().requires_grad_()
            o = par_kp.pooled_max_local(x, kshard, lambda m: m, group=group)
            o.backward(g[rows])
            result[f"max_F{f}"] = (o.detach(), x.grad)
        x, a = ht[rows].clone().requires_grad_(), att.clone().requires_grad_()
        o = par_ap.attend_local(x, a, tshard, group=group)
        o.backward(g_att[rows])
        result["attention"] = (o.detach(), x.grad, a.grad)
        torch.cuda.synchronize()
        result = {k: tuple(t.cpu() for t in v) for k, v in result.items()}
        result["launches"] = launch_counts()
        result["mode_launches"] = mode_launch_counts()
        torch.save(result, out / f"rank{rank}.pt")
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - the parent reports it
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def run_card_ranks(target, payload, label):
    """``target(rank, store, out_dir)`` on ``DIST_PARTS`` spawned processes
    on the card (a gloo group: NCCL takes one rank a card), ``payload``
    pickled to ``out_dir/payload.pkl`` (and any file the caller's ``payload``
    callable writes beside it); their results in rank order. Fails with a
    rank's traceback, and when the ranks have not all ended within
    ``DIST_RANKS_SECONDS`` (they are killed then); the ranks' files are
    removed."""
    import multiprocessing
    import shutil

    out = ROOT / "build" / f"{label}_{os.getpid()}"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    try:
        if callable(payload):
            payload = payload(out)
        with open(out / "payload.pkl", "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=target, daemon=True,
                             args=(r, str(out / "store"), str(out)))
                 for r in range(DIST_PARTS)]
        for proc in procs:
            proc.start()
        deadline = time.monotonic() + DIST_RANKS_SECONDS
        for proc in procs:
            proc.join(max(0.0, deadline - time.monotonic()))
        late = [r for r, proc in enumerate(procs) if proc.is_alive()]
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join(10)
        errors = sorted(out.glob("rank*.err"))
        check(not errors, f"a {label} rank failed:\n"
              + (errors[0].read_text() if errors else ""))
        check(not late, f"{label} ranks {late} still ran after "
              f"{DIST_RANKS_SECONDS} s and were killed")
        codes = [proc.exitcode for proc in procs]
        check(not any(codes), f"{label} ranks' exit codes {codes}")
        return [torch.load(out / f"rank{r}.pt", weights_only=False)
                for r in range(DIST_PARTS)]
    finally:
        shutil.rmtree(out, ignore_errors=True)


def distributed_partitions_phase(device, timer, workload, replaces):
    """``distributed_partitions_arxiv_shape``: a P = 4 plan of the community
    graph, each partition a process on the one card running the public
    per-rank bodies forward and backward (``partition_rank``), the halo rows
    carried by a gloo all-to-all; the reassembled outputs and gradients
    against the single-device context's ops and the plain versions. Returns
    the ranks' launches, mode launches and the kernel entries."""
    import keras_geometric_tpu_torch as kgt
    from keras_geometric_tpu_torch import parallel as par
    from keras_geometric_tpu_torch.kernels import attend_cuda as A
    from keras_geometric_tpu_torch.kernels import spmm_cuda as K
    from keras_geometric_tpu_torch.ops import reorder
    from keras_geometric_tpu_torch.parallel import attend_plan as par_ap
    from keras_geometric_tpu_torch.parallel import kernel_plan as par_kp
    from keras_geometric_tpu_torch.parallel.partition import (
        community_partition_order,
    )

    name = "distributed_partitions_arxiv_shape"
    phase_start = time.perf_counter()
    P, bf16 = DIST_PARTS, torch.bfloat16
    graph = workload("skewed_graph")
    s, r = graph["edges"][0], graph["edges"][1]
    start = time.perf_counter()
    order = community_partition_order(s, r, ARXIV_NODES, P)
    order_s = time.perf_counter() - start
    inv = reorder.invert_order(order)
    edges = np.stack([inv[s], inv[r]]).astype(np.int32)
    start = time.perf_counter()
    pg = par.partition_graph(edges, ARXIV_NODES, P, gcn_normalize=True,
                             add_self_loops=True)
    kp = par.build_kernel_plan(pg)
    apg = par.partition_graph(edges, ARXIV_NODES, P, add_self_loops=True)
    ap = par_ap.build_attend_plan(apg)
    plans_s = time.perf_counter() - start
    halos = {"community_partition_order": pg}
    for label, e in (("cluster_order_only", graph["edges"]),
                     ("uniform", arxiv_arrays(True)[1])):
        halos[label] = par.partition_graph(e, ARXIV_NODES, P,
                                           gcn_normalize=True,
                                           add_self_loops=True)
    halos = {label: halo_report(q, par.build_halo_plan(q))
             for label, q in halos.items()}
    check(np.array_equal(kp.send_idx, ap.send_idx),
          f"{name}: the kernel and attend plans' send tables differ")
    L, n_pad = pg.nodes_per_part, pg.padded_num_nodes

    # The run that counts: every partition in a process of its own.
    start = time.perf_counter()
    ranks = run_card_ranks(partition_rank, (kp, ap), "dist_parts")
    run_s = time.perf_counter() - start
    per_part = {"gather_scatter_sum_sorted": 8 + 4 + 1,
                "segment_max_wide_sorted": 4, "segment_max_wide_bwd": 4,
                "sddmm_stats_agg_sorted": 1, "attend_rho_sorted": 1,
                "attend_recv_bwd_full_sorted": 1}
    per_mode = {"gather_scatter_sum_sorted(rows)": 8,
                "sddmm_stats_agg_sorted(emit_scores=False)": 1,
                "attend_rho_sorted(scores=None)": 1,
                "attend_recv_bwd_full_sorted(scores=None)": 1}
    counts, modes = {}, {}
    for rank, res in enumerate(ranks):
        for got, per, total in ((res["launches"], per_part, counts),
                                (res["mode_launches"], per_mode, modes)):
            expected = {k: per.get(k, 0) for k in got}
            check(got == expected, f"{name}: rank {rank}'s launch counts "
                  f"{got}, expected {expected}")
            for k, v in got.items():
                total[k] = total.get(k, 0) + v
    # The ranks' rows stacked into the global ones, on the card.
    stacked = lambda key, i: torch.cat([res[key][i] for res in ranks]).to(
        device)

    # Reassembled against the single-device context's ops and the plain
    # versions on the same inputs.
    inputs, max_inputs, (ht, att, g_att), gen = partition_inputs(device,
                                                                 n_pad)
    ctx = kgt.prepare_graph(edges, ARXIV_NODES, add_self_loops=True,
                            gcn_normalize=True, device=device)
    ctx16 = ctx.with_weight_dtype(bf16)
    gctx = kgt.prepare_graph(edges, ARXIV_NODES, add_self_loops=True,
                             edge_chunk=512, device=device)
    n, results = ARXIV_NODES, {}
    part_of = lambda ids: ids.long() // L
    local_edge = part_of(ctx.senders) == part_of(ctx.receivers)
    recv_part_ss = part_of(ctx.receivers_ss)

    def held(got, want, mass, dtype, what, partials=None):
        rep = compare(got, want, mass, dtype, what, partials=partials,
                      report=True)
        check(rep["zeros_fail_share"] > 0, f"{what}: an output of zeros "
              f"would pass this check ({rep})")
        return rep

    def held_datt(got, want, mass, what, parts):
        """d att, the sum over 1.3M slots of terms that cancel, is far
        below its mass, so the element rule above cannot see it wrong;
        it is a parameter gradient, held as step 1's are: within
        ``BF16_GRAD_TOL`` of its largest entry."""
        rep = compare(got, want, mass, bf16, what, partials=parts.abs().sum(0),
                      report=True)
        scale = want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        limit = BF16_GRAD_TOL * scale
        check(err <= limit and scale > limit, f"{what}: max abs err {err} "
              f"against {limit} ({BF16_GRAD_TOL} of the largest entry, "
              f"{scale}), or zeros would pass")
        # A reassembly that left out one partition's part, against the
        # same limit.
        total = parts.sum(0)
        dropped = [(total - v - want.float()).abs().max().item()
                   for v in parts]
        return dict(element_rule=rep, gradient_limit=limit,
                    max_abs_err=err, max_abs_reference=scale,
                    zeros_fail=scale > limit,
                    max_abs_err_without_each_partition=dropped)

    # The plain versions take the weights as the bf16 runs do: rounded.
    w, w_ss = (t.to(bf16).float() for t in (ctx.edge_weight,
                                             ctx.edge_weight_ss))
    fwd = lambda x, w: K.gather_scatter_sum_sorted_plain(
        x, ctx.senders, ctx.receivers, n, weights=w)
    bwd = lambda x, w: K.gather_scatter_sum_sorted_plain(
        x, ctx.receivers_ss, ctx.senders_sorted, n, weights=w)
    for f, (h, g) in inputs.items():
        out, grad = stacked(f"spmm_F{f}", 0), stacked(f"spmm_F{f}", 1)
        hh = h[:n].clone().requires_grad_()
        ref = ctx16.spmm(hh)
        ref.backward(g[:n])
        hp = h[:n].float().requires_grad_()
        plain = fwd(hp, w)
        plain.backward(g[:n].float())
        mass = fwd(h[:n].float().abs(), w.abs())
        g_mass = bwd(g[:n].float().abs(), w_ss.abs())
        # The parts each rounded to bf16 before they are added: a row's
        # local and remote streams (forward); a sender row's part from
        # each receiving partition (backward).
        parts = (fwd(h[:n].float(), w * local_edge).abs()
                 + fwd(h[:n].float(), w * ~local_edge).abs())
        g_parts = sum(bwd(g[:n].float(), w_ss * (recv_part_ss == q)).abs()
                      for q in range(P))
        what = f"{name} spmm F={f}"
        results[f"spmm_F{f}"] = dict(
            vs_single_device=held(out[:n], ref, mass, bf16, what, parts),
            vs_plain=held(out[:n], plain.to(bf16), mass, bf16,
                          what + " vs plain", parts),
            grad_vs_single_device=held(grad[:n], hh.grad, g_mass, bf16,
                                       what + " grad", g_parts),
            grad_vs_plain=held(grad[:n], hp.grad.to(bf16), g_mass, bf16,
                               what + " grad vs plain", g_parts))
        del hh, ref, hp, plain, mass, g_mass, parts, g_parts
    for f, (h, g) in max_inputs.items():
        out, grad = stacked(f"max_F{f}", 0), stacked(f"max_F{f}", 1)
        hh = h[:n].clone().requires_grad_()
        msgs = ctx.gather(hh)
        ref = K.segment_max_wide_sorted(msgs, ctx.receivers, n,
                                        row_ptr=ctx.row_ptr,
                                        mask=ctx.edge_mask)
        ref.backward(g[:n])
        valid = ctx.edge_mask
        p_msgs = h[:n].index_select(0, ctx.senders.long())
        p_max = K.segment_max_wide_raw_plain(p_msgs, ctx.receivers, n,
                                             mask=valid, empty_to_zero=True)
        p_dmsg = K.segment_max_wide_bwd_plain(p_msgs, p_max, g[:n],
                                              ctx.receivers, n, mask=valid)
        p_grad = torch.zeros(n, f, dtype=torch.float64, device=device)
        p_grad.index_add_(0, ctx.senders.long(), p_dmsg.double())
        g_mass = torch.zeros(n, f, device=device).index_add_(
            0, ctx.senders.long(), p_dmsg.abs())
        what = f"{name} segment max F={f}"
        check(torch.equal(out[:n], ref.detach()) and
              torch.equal(out[:n], p_max),
              f"{what}: the reassembled max differs from the single-device "
              f"kernel's or the plain version's")
        results[f"segment_max_F{f}"] = dict(
            forward="bit for bit",
            grad_vs_single_device=held(grad[:n], hh.grad, g_mass,
                                       torch.float32, what + " grad"),
            grad_vs_plain=held(grad[:n], p_grad.float(), g_mass,
                               torch.float32, what + " grad vs plain"))
        del hh, msgs, ref, p_msgs, p_max, p_dmsg, p_grad, g_mass
    # The attention in the no-cache mode on one device, and restated in
    # library ops (f32 inside) as the plain version. Each row's output is
    # one walk over the same slots as one device's: no parts. A row's d ht
    # adds parts each rounded to bf16 first: its receiver part and each
    # slot's sender part (the finish sums those per partition, and the
    # exchange the partitions'). d att adds the ranks'.
    att_out, att_grad = stacked("attention", 0), stacked("attention", 1)
    t_recv = ht[:n].clone().requires_grad_()
    t_send = ht[:n].index_select(0, gctx.senders.long()).requires_grad_()
    attend_restated(gctx, t_recv, att, ht_send=t_send).backward(g_att[:n])
    dht_parts = t_recv.grad.float().abs().index_add_(
        0, gctx.senders.long(), t_send.grad.float().abs())
    del t_recv, t_send
    datt_parts = torch.stack([res["attention"][2].to(device).float()
                              for res in ranks])
    att_datt = datt_parts.sum(0).to(bf16)
    graph4 = (gctx.senders, gctx.receivers, gctx.row_ptr, gctx.edge_mask)
    _, p_scores, p_m, p_l = A.sddmm_stats_agg_sorted_plain(
        ht[:n], *graph4[:3], att, edge_valid=gctx.edge_mask)
    mass = attend_masses(graph4, ht[:n], att, g_att[:n], None, p_scores,
                         p_m, p_l)
    send_mass = mass["dht"] + torch.zeros_like(mass["dht"]).index_add_(
        0, gctx.senders.long(), mass["v"])
    del p_scores, p_m, p_l
    what = f"{name} attention"
    refs = {}
    for label, fn in (("single_device", lambda t, a: gctx.attend(t, a)),
                      ("plain", lambda t, a: attend_restated(gctx, t, a))):
        t = ht[:n].clone().requires_grad_()
        a = att.clone().requires_grad_()
        with attend_modes("permute", False):
            o = fn(t, a)
            o.backward(g_att[:n])
        refs[label] = (o.detach(), t.grad, a.grad)
    for label, (o, dt, da) in refs.items():
        results[f"attention_vs_{label}"] = dict(
            out=held(att_out[:n], o, mass["out"], bf16,
                     f"{what} out vs {label}"),
            dht=held(att_grad[:n], dt, send_mass, bf16,
                     f"{what} d ht vs {label}", dht_parts),
            datt=held_datt(att_datt, da, mass["datt"],
                           f"{what} d att vs {label}", datt_parts))
    del refs, mass, send_mass, dht_parts, ranks
    torch.cuda.empty_cache()

    # The kernels at this path's shapes, on the partition with the most
    # remote edges.
    p_star = int(np.argmax(kp.rem.num_real))
    kshard = par_kp.plan_device_data(kp, p_star, device)
    table = par_ap.plan_device_data(ap, p_star, device).context
    # Global rows of the partition's halo block: slot q*H + j holds row
    # send_idx[q, p_star, j] of partition q.
    send = torch.from_numpy(kp.send_idx[:, p_star].astype(np.int64))
    halo_rows = (torch.arange(P)[:, None] * L + send).reshape(-1).to(device)
    rows = slice(p_star * L, (p_star + 1) * L)
    h128 = inputs[ARXIV_FEATS][0]
    entries = []
    entries += stream_entries(timer, replaces, name,
                              f"partition {p_star} local stream",
                              kshard.loc, h128[rows].contiguous(), bf16,
                              f"{name} local stream")
    entries += stream_entries(timer, replaces, name,
                              f"partition {p_star} remote stream",
                              kshard.rem, h128.index_select(0, halo_rows),
                              bf16, f"{name} remote stream")
    entries += segment_max_stream_entries(
        timer, replaces, name, f"partition {p_star} remote stream",
        kshard.rem, max_inputs[128][0].index_select(0, halo_rows),
        max_inputs[128][1][rows].contiguous())
    entries += table_attend_entries(
        timer, replaces, name, f"partition {p_star} table", table,
        GAT_ARXIV_HEADS, GAT_ARXIV_DIMS[0], bf16, gen, device)
    emit(name, parts=P, backend="gloo", processes=P, halos=halos,
         community_partition_order_seconds=order_s, plans_seconds=plans_s,
         ranks_seconds=run_s, launches_per_partition=per_part,
         launches=counts, mode_launches=modes, checks=results,
         remote_edges_by_partition=[int(v) for v in kp.rem.num_real],
         local_edges_by_partition=[int(v) for v in kp.loc.num_real],
         seconds=time.perf_counter() - phase_start)
    del kshard, table, inputs, max_inputs
    torch.cuda.empty_cache()
    return counts, modes, entries


def segment_max_stream_entries(timer, replaces, path, label, st, source, g):
    """The wide segment max (K4) over one stream's gathered messages,
    forward and backward (the kernel's tie rule), against the plain
    versions, with ``torch.segment_reduce`` beside the forward."""
    from keras_geometric_tpu_torch.kernels import spmm_cuda as K

    msgs = source.index_select(0, st.senders)
    e, f = msgs.shape
    n = st.num_local
    fwd = lambda: K._segment_max_wide_fwd(msgs, st.receivers, st.row_ptr, n,
                                          st.valid, False)
    fwd_plain = lambda: K.segment_max_wide_raw_plain(
        msgs, st.receivers, n, mask=st.valid)
    maxv = fwd_plain()
    check(torch.equal(fwd(), maxv), f"{path} {label}: the segment max "
          f"differs from its plain version")
    bwd = lambda: K._segment_max_wide_bwd(msgs, maxv, g, st.receivers,
                                          st.row_ptr, n, st.valid, False)
    bwd_plain = lambda: K.segment_max_wide_bwd_plain(
        msgs, maxv, g, st.receivers, n, mask=st.valid)
    check(torch.equal(bwd(), bwd_plain()), f"{path} {label}: the segment "
          f"max's backward differs from its plain version")
    lengths = (st.row_ptr[1:] - st.row_ptr[:-1]).long()
    masked = msgs.masked_fill(~st.valid[:, None], float("-inf"))
    library = lambda: torch.segment_reduce(masked, "max", lengths=lengths,
                                           axis=0)
    shape = f"{label}: E={e} (real {st.num_real}) L={n} F={f} float32"
    fwd_bytes = e * f * 4 + n * f * 4 + e + (n + 1) * 4
    return [
        kernel_entry(timer, replaces, "segment_max_wide_sorted", path, shape,
                     fwd, fwd_plain, 0.0, fwd_bytes, e * f,
                     library=("torch.segment_reduce (max)",
                              timer.cold_ms(library, iters=10))),
        kernel_entry(timer, replaces, "segment_max_wide_bwd", path, shape,
                     bwd, bwd_plain, 0.0,
                     fwd_bytes + e * f * 4 + n * f * 4, 2 * e * f),
    ]


# ---------------------------------------------------------------------------
# Tensor and data parallelism on torch.distributed
# ---------------------------------------------------------------------------

TP_GRID = (2, 2)  # (graph, model) of the 2-D blocks; the 1-D mesh is (4,)
# The unsharded blocks at the main path's widths: the 2-layer GCN, the fused
# GATv2 arxiv config's first layer (concat) and a head-mean layer.
TP_BLOCKS = {"gcn": (ARXIV_FEATS, HIDDEN, ARXIV_CLASSES),
             "gat_concat": (GAT_ARXIV_HEADS, GAT_ARXIV_DIMS[0], True),
             "gat_mean": (GAT_ARXIV_HEADS, GAT_ARXIV_DIMS[1], False)}
# f32 on both sides, sums in other orders: outputs and gradients within
# 2e-4 of their largest entry (the f32 step-1 gradient limit).
TP_TOL = 2e-4
TP_TIMED = 3  # timed forward + backward passes of each block, after a warm one
# The GCN pair's activation: smooth. With relu, the card's f32 sums in an
# order that changes from run to run (index_add's atomics) put a few
# pre-activations on either side of 0, and the gradient through each of them
# changes by its whole term (tp_activation_probe.py, PERF.md). The CPU
# tests hold the blocks with relu.
TP_ACTIVATION = torch.nn.functional.gelu
DP_RANKS_STEPS = 10
# The data-parallel step against one process over the same buckets: the
# loss within 1e-4 of its magnitude (the sum readout's first losses run to
# the thousands), each parameter within 2e-4 of its largest entry.
DP_LOSS_TOL, DP_PARAM_TOL = 1e-4, 2e-4


def held_within(got, want, tol):
    """``(err, scale)``: the largest difference and ``want``'s largest entry;
    fails unless ``err <= tol * scale``."""
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    return err, scale, math.isfinite(err) and err <= tol * max(scale, 1e-12)


def tp_modules(device, generator):
    """The unsharded layers of each block in ``TP_BLOCKS``, from one seed,
    with nonzero biases (their paths count)."""
    from keras_geometric_tpu_torch import GATv2Conv, GCNConv

    f_in, hidden, classes = TP_BLOCKS["gcn"]
    kw = dict(generator=generator, device=device)
    mods = {"gcn": torch.nn.ModuleList([
        GCNConv(hidden, input_dim=f_in, add_self_loops=False,
                normalize=False, **kw),
        GCNConv(classes, input_dim=hidden, add_self_loops=False,
                normalize=False, **kw)])}
    for name in ("gat_concat", "gat_mean"):
        heads, f, concat = TP_BLOCKS[name]
        mods[name] = GATv2Conv(f, input_dim=f_in, heads=heads, concat=concat,
                               add_self_loops=False, **kw)
    with torch.no_grad():
        for mod in mods.values():
            for key, p in mod.named_parameters():
                if key.endswith("bias"):
                    p.normal_(0.0, 0.1, generator=generator)
    return mods


def tp_param_tree(name, mod, grads=False):
    """A block's parameters (or their gradients) as the reference's nested
    numpy dict, what ``shard_params_tp`` / ``shard_params_gatv2_tp`` take."""
    get = lambda p: (p.grad if grads else p).detach().cpu().numpy()
    if name == "gcn":
        return {f"layer_{i}": {"kernel": get(c.kernel), "bias": get(c.bias)}
                for i, c in enumerate(mod)}
    return {"kernel": get(mod.kernel), "att": get(mod.att),
            "bias": get(mod.bias)}


def tp_unsharded(name, mod, x, edges):
    """The unsharded block on the edge list (library ops)."""
    senders, receivers, weight, mask = edges
    ei = torch.stack([senders, receivers])
    if name == "gcn":
        h = TP_ACTIVATION(mod[0](x, ei, weight, edge_mask=mask))
        return mod[1](h, ei, weight, edge_mask=mask)
    return mod(x, ei, edge_mask=mask)


def tp_block_fn(name, tp, group_kw, activation=None):
    """``fn(p_shard, x, senders, receivers, weight, mask)``: the block's
    per-rank body, 1-D (``group_kw`` ``{"group"}``) or 2-D
    (``{"graph_group", "model_group"}``); the GCN pair's ``activation``
    (default ``TP_ACTIVATION``)."""
    two_d = "graph_group" in group_kw
    if name == "gcn":
        body = (tp.tp_graph_gcn_block_local if two_d
                else tp.tp_gcn_block_local)
        act = activation or TP_ACTIVATION
        return lambda p, x, s, r, w, m: body(p, x, s, r, w, m,
                                             activation=act, **group_kw)
    heads, _, concat = TP_BLOCKS[name]
    body = tp.tp_graph_gatv2_block_local if two_d else tp.tp_gatv2_block_local
    return lambda p, x, s, r, w, m: body(p, x, s, r, m, concat=concat,
                                         heads_total=heads, **group_kw)


def synchronize() -> None:
    """Wait for the card (nothing to wait for without one)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def fwd_bwd_ms(fn, iters, barrier=None):
    """Host ms of each of ``iters`` forward + backward passes of ``fn``,
    each between two synchronisations (after a ``barrier``, if given)."""
    out = []
    for _ in range(iters):
        if barrier is not None:
            barrier()
        synchronize()
        start = time.perf_counter()
        fn()
        synchronize()
        out.append(1e3 * (time.perf_counter() - start))
    return out


def tp_rank(rank, store, out_dir):
    """One rank of ``tensor_parallel_arxiv_shape``, a process of its own on
    the card in a gloo group of ``DIST_PARTS``: every block of
    ``TP_BLOCKS`` on a 1-D ``model`` mesh of 4 and on the ``TP_GRID`` mesh,
    forward and backward, its rows of the outputs and ``d x`` and its
    parameter shards' gradients (summed over the graph group on the 2-D
    mesh) held against the unsharded run's, the GCN's output also against
    the context path's (K1); then the blocks timed. Writes the errors, the
    times and the launches of the run to ``out_dir``."""
    import datetime
    import traceback

    import torch.distributed as dist

    from keras_geometric_tpu_torch import parallel as par
    from keras_geometric_tpu_torch.parallel import tensor_parallel as tp
    from keras_geometric_tpu_torch.parallel.distributed import _sum_gradients
    from keras_geometric_tpu_torch.parallel.mesh import local_device

    out = pathlib.Path(out_dir)
    try:
        # Four processes share the host's cores.
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // DIST_PARTS))
        with open(out / "payload.pkl", "rb") as f:
            payload = pickle.load(f)
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank,
            world_size=DIST_PARTS, timeout=datetime.timedelta(seconds=120))
        device_type = payload["device_type"]
        meshes = {
            "model": par.make_mesh((DIST_PARTS,), ("model",),
                                   device_type=device_type),
            "grid": par.make_mesh(TP_GRID, ("graph", "model"),
                                  device_type=device_type)}
        device = local_device(meshes["model"])
        ref = torch.load(out / "reference.pt", map_location=device,
                         weights_only=False)
        x_all = torch.from_numpy(payload["x"]).to(device)
        n = x_all.shape[0]
        result, timing_fns = {"checks": {}, "ms": {}}, {}
        reset_launch_counts()
        for mesh_name, mesh in meshes.items():
            if mesh_name == "model":
                part, parts = 0, 1
                t, size = mesh.get_local_rank("model"), DIST_PARTS
                group_kw = {"group": mesh.get_group("model")}
                graph_group = None
            else:
                part, t = (mesh.get_local_rank("graph"),
                           mesh.get_local_rank("model"))
                parts, size = TP_GRID
                graph_group = mesh.get_group("graph")
                group_kw = {"graph_group": graph_group,
                            "model_group": mesh.get_group("model")}
            pg = payload["partitions"][parts]
            L = pg["nodes_per_part"]
            edges = tuple(torch.from_numpy(np.ascontiguousarray(
                pg[k][part])).to(device) for k in (
                    "senders_global", "receivers_local", "edge_weight",
                    "edge_mask"))
            rows = slice(part * L, min((part + 1) * L, n))
            real = rows.stop - rows.start
            x_local = torch.zeros(L, x_all.shape[1], device=device)
            x_local[:real] = x_all[rows]
            for name in TP_BLOCKS:
                shard = payload["params"][name][size][t]
                params = tensor_tree(shard, device)
                leaves = list(flat_tree(params).values())
                fn = tp_block_fn(name, tp, group_kw)
                g_local = torch.zeros(L, ref["cotangent"][name].shape[1],
                                      device=device)
                g_local[:real] = ref["cotangent"][name][rows]

                def pass_once(params=params, leaves=leaves, fn=fn,
                              g_local=g_local, x_local=x_local, edges=edges,
                              graph_group=graph_group):
                    for p in leaves:
                        p.grad = None
                    x = x_local.clone().requires_grad_()
                    o = fn(params, x, *edges)
                    o.backward(g_local)
                    if graph_group is not None:
                        _sum_gradients(leaves, graph_group)
                    return o.detach(), x.grad

                o, dx = pass_once()
                checks = {
                    "out": held_within(o[:real], ref["out"][name][rows],
                                       TP_TOL),
                    "d_x": held_within(dx[:real], ref["d_x"][name][rows],
                                       TP_TOL)}
                if name == "gcn":  # against the context path (K1)
                    checks["out_vs_context_k1"] = held_within(
                        o[:real], ref["out_context"][rows], TP_TOL)
                want = flat_tree(payload["grads"][name][size][t])
                for key, p in flat_tree(params).items():
                    checks[f"d {key}"] = held_within(
                        p.grad, torch.from_numpy(np.asarray(want[key])).to(
                            device), TP_TOL)
                result["checks"][mesh_name, name] = checks
                timing_fns[mesh_name, name] = pass_once
        result["launches"] = launch_counts()
        result["mode_launches"] = mode_launch_counts()
        for key, fn in timing_fns.items():
            result["ms"][key] = fwd_bwd_ms(fn, TP_TIMED + 1,
                                           barrier=dist.barrier)[1:]
        torch.save(result, out / f"rank{rank}.pt")
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - the parent reports it
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def flat_tree(tree, prefix=""):
    """A nested dict's leaves under dotted names."""
    out = {}
    for key, value in tree.items():
        name = f"{prefix}.{key}" if prefix else key
        if isinstance(value, dict):
            out.update(flat_tree(value, name))
        else:
            out[name] = value
    return out


def tensor_tree(tree, device):
    """A nested dict of numpy arrays as leaf tensors on ``device`` that
    require gradients."""
    return {k: tensor_tree(v, device) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)).to(device).requires_grad_()
            for k, v in tree.items()}


def tensor_parallel_phase(device) -> tuple:
    """``tensor_parallel_arxiv_shape``: the tensor-parallel blocks of
    ``TP_BLOCKS`` on the uniform arxiv-shaped graph with its self-loops and
    GCN normalisation, as four processes on the card (``tp_rank``), held
    against the unsharded layers run here in f32 with the same weights; the
    unsharded GCN also against the context path (K1); one world-1 NCCL run
    of the GCN block through the default ``make_mesh``. Returns the ranks'
    launches and mode launches (no hand-written kernel on this path)."""
    import keras_geometric_tpu_torch as kgt
    from keras_geometric_tpu_torch import GCNConv
    from keras_geometric_tpu_torch import parallel as par
    from keras_geometric_tpu_torch.parallel import tensor_parallel as tp

    name = "tensor_parallel_arxiv_shape"
    phase_start = time.perf_counter()
    x, edges, _ = arxiv_arrays(symmetric=True)
    start = time.perf_counter()
    pgs = {parts: par.partition_graph(edges, ARXIV_NODES, parts,
                                      gcn_normalize=True, add_self_loops=True)
           for parts in (1, TP_GRID[0])}
    partition_s = time.perf_counter() - start
    gen = torch.Generator(device=device).manual_seed(43)
    mods = tp_modules(device, gen)
    e1 = tuple(torch.from_numpy(np.ascontiguousarray(a[0])).to(device)
               for a in (pgs[1].senders_global, pgs[1].receivers_local,
                         pgs[1].edge_weight, pgs[1].edge_mask))
    check(int(e1[3].sum()) == 2 * (ARXIV_EDGES // 2) + ARXIV_NODES,
          f"{name}: the graph has the wrong edge count")
    xd = torch.from_numpy(x).to(device)
    ref = {"cotangent": {}, "out": {}, "d_x": {}}
    params, grads, unsharded_ms = {}, {}, {}
    widths = (1, TP_GRID[1], DIST_PARTS)  # model-axis widths
    for block, mod in mods.items():
        out_dim = (TP_BLOCKS[block][2] if block == "gcn" else
                   mod.out_features)
        g = torch.randn(ARXIV_NODES, out_dim, generator=gen, device=device)

        def pass_once(mod=mod, block=block, g=g):
            mod.zero_grad(set_to_none=True)
            xx = xd.clone().requires_grad_()
            o = tp_unsharded(block, mod, xx, e1)
            o.backward(g)
            return o.detach(), xx.grad

        o, dx = pass_once()
        check(bool(torch.isfinite(o).all() and torch.isfinite(dx).all()),
              f"{name} {block}: the unsharded block is not finite")
        ref["cotangent"][block], ref["out"][block], ref["d_x"][block] = \
            g, o, dx
        shard = tp.shard_params_tp if block == "gcn" else \
            tp.shard_params_gatv2_tp
        params[block] = {t: shard(tp_param_tree(block, mod), t)
                         for t in widths}
        grads[block] = {t: shard(tp_param_tree(block, mod, grads=True), t)
                        for t in widths}
        unsharded_ms[block] = fwd_bwd_ms(pass_once, TP_TIMED + 1)[1:]

    # The unsharded GCN against the main path's layers on a context (K1).
    ctx = kgt.prepare_graph(edges, ARXIV_NODES, add_self_loops=True,
                            gcn_normalize=True, symmetric=True,
                            densify_self_loops=True, pad_nodes=True,
                            device=device)
    convs = [GCNConv.for_context(c.output_dim, input_dim=c.input_dim,
                                 device=device) for c in mods["gcn"]]
    for conv, c in zip(convs, mods["gcn"]):
        conv.load_state_dict(c.state_dict())
    reset_launch_counts()
    with torch.no_grad():
        x_pad = torch.zeros(ctx.num_nodes, ARXIV_FEATS, device=device)
        x_pad[:ARXIV_NODES] = xd
        out_ctx = convs[1](TP_ACTIVATION(convs[0](x_pad, context=ctx)),
                           context=ctx)[:ARXIV_NODES]
    context_launches = {k: v for k, v in launch_counts().items() if v}
    check(context_launches.get("gather_scatter_sum_sorted", 0) > 0,
          f"{name}: the context path launched no K1: {context_launches}")
    context_err = held_within(out_ctx, ref["out"]["gcn"], TP_TOL)
    check(context_err[2], f"{name}: the unsharded GCN on the edge list vs "
          f"on a context (K1): {context_err}")
    ref["out_context"] = out_ctx
    del ctx, convs, x_pad

    # One world-1 NCCL run through the default make_mesh.
    with one_rank_group():
        import torch.distributed as dist

        mesh = par.make_mesh((1,), ("model",))
        check(dist.get_backend() == "nccl" and mesh.device_type == "cuda",
              f"{name}: the default mesh is not an NCCL mesh on the card")
        fn = tp_block_fn("gcn", tp, {"group": mesh.get_group("model")})
        p1 = tensor_tree(params["gcn"][1][0], device)

        def nccl_pass():
            for p in flat_tree(p1).values():
                p.grad = None
            xx = xd.clone().requires_grad_()
            o = fn(p1, xx, *e1)
            o.backward(ref["cotangent"]["gcn"])
            return o.detach(), xx.grad

        o, dx = nccl_pass()
        nccl = {"out": held_within(o, ref["out"]["gcn"], TP_TOL),
                "d_x": held_within(dx, ref["d_x"]["gcn"], TP_TOL)}
        want = flat_tree(grads["gcn"][1][0])
        for key, p in flat_tree(p1).items():
            nccl[f"d {key}"] = held_within(
                p.grad, torch.from_numpy(want[key]).to(device), TP_TOL)
        nccl_ms = fwd_bwd_ms(nccl_pass, TP_TIMED + 1)[1:]
        del p1
    for key, (err, scale, ok) in nccl.items():
        check(ok, f"{name}: world-1 NCCL GCN block {key}: err {err:.3e} "
              f"against scale {scale:.3e}")

    # The run that counts: four processes on the card.
    payload = dict(
        device_type=device.type, x=x, params=params, grads=grads,
        partitions={parts: {**{k: getattr(pg, k) for k in (
            "senders_global", "receivers_local", "edge_weight",
            "edge_mask")}, "nodes_per_part": pg.nodes_per_part}
            for parts, pg in pgs.items()})

    def write(out):
        torch.save(ref, out / "reference.pt")
        return payload

    start = time.perf_counter()
    ranks = run_card_ranks(tp_rank, write, "tp_ranks")
    ranks_s = time.perf_counter() - start
    counts, modes, checks, rank_ms, failed = {}, {}, {}, {}, []
    for rank, res in enumerate(ranks):
        check(not any(res["launches"].values())
              and not any(res["mode_launches"].values()),
              f"{name}: rank {rank} launched hand-written kernels: "
              f"{res['launches']} {res['mode_launches']}")
        for total, got in ((counts, res["launches"]),
                           (modes, res["mode_launches"])):
            for k, v in got.items():
                total[k] = total.get(k, 0) + v
        for (mesh_name, block), case in res["checks"].items():
            for key, (err, scale, ok) in case.items():
                if not ok:
                    failed.append(f"rank {rank} {mesh_name} {block} {key}: "
                                  f"err {err:.3e} against scale {scale:.3e}")
                worst = checks.setdefault(f"{mesh_name} {block}", {})
                ratio = err / max(scale, 1e-12)
                worst[key] = max(worst.get(key, 0.0), ratio)
        for (mesh_name, block), ms in res["ms"].items():
            rank_ms.setdefault(f"{mesh_name} {block}", []).append(
                min(ms))
    check(not failed, f"{name}: " + "; ".join(failed))
    emit(name, nodes=ARXIV_NODES,
         edges_with_self_loops=int(e1[3].sum()), blocks={
             b: dict(zip(("f_in", "hidden", "classes") if b == "gcn" else
                         ("heads", "f", "concat"), v))
             for b, v in TP_BLOCKS.items()},
         meshes={"model": [DIST_PARTS], "grid": list(TP_GRID)},
         backend="gloo", processes=DIST_PARTS,
         worst_rel_err_by_case=checks, tolerance=TP_TOL,
         context_k1_rel_err=context_err[0] / max(context_err[1], 1e-12),
         context_k1_launches=context_launches,
         fwd_bwd_ms_per_rank=rank_ms, unsharded_fwd_bwd_ms={
             b: min(v) for b, v in unsharded_ms.items()},
         nccl_world1={"fwd_bwd_ms": min(nccl_ms), "rel_err": {
             k: e / max(s, 1e-12) for k, (e, s, _) in nccl.items()}},
         launches=counts, launches_why="the blocks run library ops "
         "(ops/segment.py) and dense products, as the reference's run XLA's",
         partition_seconds=partition_s, ranks_seconds=ranks_s,
         seconds=time.perf_counter() - phase_start)
    del ref, mods, xd, e1
    torch.cuda.empty_cache()
    return counts, modes


def dp_step_chunks(graphs):
    """The data-parallel run's batches: ``DP_RANKS_STEPS`` steps of
    ``DIST_PARTS`` batches of ``GC_BATCH`` graphs each (``gc_batches``)."""
    chunks = gc_batches(graphs, DP_RANKS_STEPS * DIST_PARTS)
    return [chunks[s * DIST_PARTS:(s + 1) * DIST_PARTS]
            for s in range(DP_RANKS_STEPS)]


def dp_rank(rank, store, out_dir):
    """One rank of ``train_dp_graph_classification``, a process of its own
    on the card in a gloo group of ``DIST_PARTS`` on a ``data`` mesh:
    ``DP_RANKS_STEPS`` steps of ``make_dp_graph_classifier_step`` over its
    bucket of each step. Writes its losses, parameters, step times and the
    launches of the run to ``out_dir``."""
    import datetime
    import traceback

    import torch.distributed as dist

    from keras_geometric_tpu_torch import parallel as par
    from keras_geometric_tpu_torch.parallel.mesh import local_device

    out = pathlib.Path(out_dir)
    try:
        # Four processes share the host's cores.
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // DIST_PARTS))
        with open(out / "payload.pkl", "rb") as f:
            payload = pickle.load(f)
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank,
            world_size=DIST_PARTS, timeout=datetime.timedelta(seconds=120))
        mesh = par.make_mesh((DIST_PARTS,), ("data",),
                             device_type=payload["device_type"])
        device = local_device(mesh)
        gc = example_module("graph_classification")
        graphs, _, classes = gc.make_dataset(GC_GRAPHS, GC_CLASSES, seed=0)
        model = gc.make_model(GC_HIDDEN, classes, "sum", device=device,
                              generator=None)
        model.load_state_dict(payload["state"])
        step = par.make_dp_graph_classifier_step(
            model, torch.optim.Adam(model.parameters(), lr=1e-3), mesh,
            GC_BATCH + 1)
        reset_launch_counts()
        losses, ms = [], []
        for chunks in dp_step_chunks(graphs):
            buckets = [gc.batch_to_arrays(c, GC_BATCH, "cpu") for c in chunks]
            data = par.stack_padded_batches([b[0] for b in buckets], mesh)
            check(data["x"].shape[0] == 1 and data["x"].device == device,
                  f"rank {rank}: its share is not one bucket on its device")
            data["y"] = buckets[rank][1][None].to(device)
            dist.barrier()
            synchronize()
            start = time.perf_counter()
            losses.append(step(data).item())
            ms.append(1e3 * (time.perf_counter() - start))
        torch.save(dict(losses=losses, ms=ms, fields=sorted(data),
                        params={k: p.detach().cpu() for k, p in
                                model.named_parameters()},
                        launches=launch_counts(),
                        mode_launches=mode_launch_counts()),
                   out / f"rank{rank}.pt")
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - the parent reports it
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def dp_graph_classification_phase(device) -> tuple:
    """``train_dp_graph_classification``: BASELINE.json config 3 as
    ``examples_torch/graph_classification.py`` builds it (the 5-layer GIN at
    width 32, sum readout, Adam 1e-3, f32), trained data-parallel by four
    processes on the card, one bucket of 32 graphs each a step, for
    ``DP_RANKS_STEPS`` steps; the losses and the final parameters held
    against one process running the reference's formulation over the same
    four buckets (NLL sums and counts added, one backward), and the
    parameters equal on every rank; one world-1 NCCL run over all four
    buckets through the default ``make_mesh``. Returns the ranks' launches
    and mode launches (no hand-written kernel on this path)."""
    from keras_geometric_tpu_torch import parallel as par
    from keras_geometric_tpu_torch.training import label_nll

    name = "train_dp_graph_classification"
    phase_start = time.perf_counter()
    gc = example_module("graph_classification")
    graphs, _, classes = gc.make_dataset(GC_GRAPHS, GC_CLASSES, seed=0)
    steps = dp_step_chunks(graphs)
    num_graphs = GC_BATCH + 1
    model = gc.make_model(GC_HIDDEN, classes, "sum", device=device,
                          generator=torch.Generator(device=device)
                          .manual_seed(0))
    state = {k: v.detach().cpu().clone()
             for k, v in model.state_dict().items()}

    # The reference's formulation in one process: the four buckets' NLL
    # sums and counts added, then one backward and one Adam step.
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    reset_launch_counts()
    ref_losses, ref_ms = [], []
    for chunks in steps:
        buckets = [gc.batch_to_arrays(c, GC_BATCH, device) for c in chunks]
        synchronize()
        start = time.perf_counter()
        model.eval()
        opt.zero_grad(set_to_none=True)
        sums = []
        for g, y, _ in buckets:
            logits = model(g.x, g.edge_index, g.batch, num_graphs,
                           edge_mask=g.edge_mask, node_mask=g.node_mask)
            valid = (y >= 0).to(logits.dtype)
            nll = label_nll(torch.log_softmax(logits, dim=-1),
                            y.clamp_min(0))
            sums.append(torch.stack([(nll * valid).sum(), valid.sum()]))
        total = torch.stack(sums).sum(dim=0)
        loss = total[0] / total[1].clamp_min(1.0)
        loss.backward()
        opt.step()
        ref_losses.append(loss.item())
        ref_ms.append(1e3 * (time.perf_counter() - start))
    ref_params = {k: p.detach() for k, p in model.named_parameters()}
    ref_launches = launch_counts()
    check(not any(ref_launches.values()),
          f"{name}: the one-process run launched hand-written kernels")
    check(all(map(math.isfinite, ref_losses))
          and ref_losses[-1] < ref_losses[0],
          f"{name}: the one-process losses {ref_losses}")

    def held_losses(what, losses):
        for i, (got, want) in enumerate(zip(losses, ref_losses)):
            check(math.isfinite(got) and abs(got - want)
                  <= DP_LOSS_TOL * max(1.0, abs(want)),
                  f"{name} {what}: step {i + 1} loss {got} vs {want}")
        return max(abs(g - w) / max(1.0, abs(w))
                   for g, w in zip(losses, ref_losses))

    def held_params(what, got):
        worst = 0.0
        for key, want in ref_params.items():
            err, scale, ok = held_within(got[key].to(device), want,
                                         DP_PARAM_TOL)
            check(ok, f"{name} {what}: parameter {key}: err {err:.3e} "
                  f"against scale {scale:.3e}")
            worst = max(worst, err / max(scale, 1e-12))
        return worst

    # One world-1 NCCL run over all four buckets (m = 4).
    with one_rank_group():
        import torch.distributed as dist

        mesh = par.make_mesh((1,), ("data",))
        check(dist.get_backend() == "nccl" and mesh.device_type == "cuda",
              f"{name}: the default mesh is not an NCCL mesh on the card")
        nccl_model = gc.make_model(GC_HIDDEN, classes, "sum", device=device,
                                   generator=None)
        nccl_model.load_state_dict(state)
        step = par.make_dp_graph_classifier_step(
            nccl_model, torch.optim.Adam(nccl_model.parameters(), lr=1e-3),
            mesh, num_graphs)
        nccl_losses, nccl_ms = [], []
        for chunks in steps:
            buckets = [gc.batch_to_arrays(c, GC_BATCH, "cpu")
                       for c in chunks]
            data = par.stack_padded_batches([b[0] for b in buckets], mesh)
            check(data["x"].shape[0] == DIST_PARTS,
                  f"{name}: the world-1 rank does not hold every bucket")
            data["y"] = torch.stack([b[1] for b in buckets]).to(device)
            synchronize()
            start = time.perf_counter()
            nccl_losses.append(step(data).item())
            nccl_ms.append(1e3 * (time.perf_counter() - start))
    nccl_loss_err = held_losses("world-1 NCCL", nccl_losses)
    nccl_param_err = held_params("world-1 NCCL", dict(
        nccl_model.named_parameters()))

    # The run that counts: four processes on the card.
    start = time.perf_counter()
    ranks = run_card_ranks(dp_rank, dict(device_type=device.type,
                                         state=state), "dp_ranks")
    ranks_s = time.perf_counter() - start
    counts, modes = {}, {}
    for rank, res in enumerate(ranks):
        check(not any(res["launches"].values())
              and not any(res["mode_launches"].values()),
              f"{name}: rank {rank} launched hand-written kernels: "
              f"{res['launches']} {res['mode_launches']}")
        for total, got in ((counts, res["launches"]),
                           (modes, res["mode_launches"])):
            for k, v in got.items():
                total[k] = total.get(k, 0) + v
        check(res["losses"] == ranks[0]["losses"],
              f"{name}: rank {rank}'s losses differ from rank 0's")
        for key, p in res["params"].items():
            check(torch.equal(p, ranks[0]["params"][key]),
                  f"{name}: rank {rank}'s {key} differs from rank 0's")
    loss_err = held_losses("four ranks", ranks[0]["losses"])
    param_err = held_params("four ranks", ranks[0]["params"])
    median = lambda v: float(np.median(v[1:]))
    emit(name, graphs=GC_GRAPHS, batch_size=GC_BATCH,
         node_bucket=24 * GC_BATCH, edge_bucket=24 * 8 * GC_BATCH,
         graph_slots=num_graphs, model=f"GraphClassifier(GIN(({GC_HIDDEN},) "
         f"* 5, mlp_hidden=({GC_HIDDEN},)), {classes}, readout='sum')",
         ranks=DIST_PARTS, backend="gloo", buckets_per_rank=1,
         steps=DP_RANKS_STEPS, fields=ranks[0]["fields"],
         losses=ranks[0]["losses"], losses_one_process=ref_losses,
         loss_rel_err=loss_err, param_rel_err=param_err,
         params_equal_on_every_rank=True,
         step_ms_per_rank=[median(r["ms"]) for r in ranks],
         step_ms_one_process_four_buckets=median(ref_ms),
         nccl_world1={"step_ms": median(nccl_ms), "buckets_per_rank":
                      DIST_PARTS, "loss_rel_err": nccl_loss_err,
                      "param_rel_err": nccl_param_err},
         launches=counts, launches_per_step=0, launches_why="the edge-list "
         "GIN aggregates and the readout pools with library segment ops "
         "(ops/segment.py), as the reference's run XLA's",
         ranks_seconds=ranks_s, seconds=time.perf_counter() - phase_start)
    return counts, modes


ACCURACY_STEPS = 60  # the reference gate's default


def accuracy_tool():
    """``tools/accuracy_check_torch.py`` of this checkout, as a module."""
    import importlib.util

    path = ROOT / "tools" / "accuracy_check_torch.py"
    spec = importlib.util.spec_from_file_location("accuracy_check_torch",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # its dataclasses look it up there
    spec.loader.exec_module(module)
    return module


def accuracy_trajectory_phase(device, smi) -> None:
    """The port's hardware accuracy gate in process: each of the tool's runs
    (``gcn_f32``, ``gcn_bf16``, ``gat_send_products_widths``) trains on the
    kernel path and on the plain edge-list path from the same parameters for
    ``ACCURACY_STEPS`` steps, then the tool's control (``gcn_f32`` with the
    kernel path's edge weights x 1.1); one line each with its trajectories,
    its gaps and the kernels' launches a step, then the card's name and
    power limit. Any run outside the gate's limits (a relative loss gap of
    2%, or the port's 0.15%, at a logged step, a final accuracy gap of 0.01,
    a loss that is not finite, launches a step other than listed), or a
    control that breaks no loss limit, fails the script."""
    tool = accuracy_tool()
    start = time.perf_counter()
    records, control = tool.run_all(
        steps=ACCURACY_STEPS, device=device,
        emit=lambda line: emit("accuracy_trajectory", **json.loads(line)))
    emit("accuracy_trajectory", nvidia_smi=smi,
         runs=[r["run"] for r in records],
         max_rel_gap={r["run"]: r["max_rel_gap"] for r in records},
         acc_gap={r["run"]: r["acc_gap"] for r in records},
         kernel_launches_per_step={r["run"]: r["kernel_launches_per_step"]
                                   for r in records},
         control=control["run"], control_max_rel_gap=control["max_rel_gap"],
         control_faults=control["faults"],
         seconds=time.perf_counter() - start)
    for r in records:
        check(r["ok"], f"accuracy_trajectory: {r['run']} diverged: "
              f"{r['faults']}")
    check(tool.control_caught(control),
          f"accuracy_trajectory: the control {control['run']} broke no loss "
          f"limit (gap {control['max_rel_gap']}): the gate cannot fail")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", nargs="?", const="train_arxiv_shape",
                    default=None, metavar="RUN",
                    help="after the phases, trace a few steps of the named "
                         "training run (default train_arxiv_shape) and print "
                         "device time by kernel")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset (the final line is printed "
                         "only when every phase ran; a subset that passes "
                         f"exits with code {PARTIAL_EXIT_CODE})")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases: {sorted(unknown)}")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this script runs the port on the "
              "card and has no CPU mode", file=sys.stderr)
        return 1

    import keras_geometric_tpu_torch as kgt
    from keras_geometric_tpu_torch.kernels import _build

    t_start = time.perf_counter()
    device = torch.device("cuda")
    torch.manual_seed(0)
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)

    # 1. device + build (always: everything below needs the libraries). One
    # compiler per source, side by side.
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=1) as pool:
        ptxas = pool.submit(ptxas_report)
        _build.load_libraries(sorted(SOURCES))
        ptxas = ptxas.result()
    nvcc = subprocess.run([_build._find_nvcc(), "--version"],
                          capture_output=True, text=True, timeout=60)
    emit("device", kind=kind, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         nvcc=nvcc.stdout.strip().splitlines()[-2:],
         capability=list(torch.cuda.get_device_capability(0)),
         kernel_build_seconds=_build.BUILD_SECONDS,
         build_wall_seconds=time.perf_counter() - t_start,
         nvcc_flags=list(_build.NVCC_FLAGS), package=kgt.__version__,
         ptxas=ptxas)

    timer = Timer(device)
    kernel_entries = []
    path_launches = {}  # training run -> each kernel's launches in that run
    path_mode_launches = {}  # the same, for the attention kernels' modes
    workloads = {}
    gcn_kw = dict(add_self_loops=True, gcn_normalize=True, symmetric=True,
                  densify_self_loops=True, pad_nodes=True,
                  attend_full_stream=False)
    gat_kw = dict(add_self_loops=True, edge_chunk=512, pad_nodes=True)

    def gcn_bf16(prepared):
        ctx, *rest = prepared
        return (ctx.with_weight_dtype(torch.bfloat16), *rest)

    makers = {"cora": cora_workload, "citeseer": citeseer_workload,
              "sage_cora": lambda dev: cora_workload(dev, gcn=False),
              "gat_arxiv": gat_arxiv_workload,
              "arxiv": lambda dev: arxiv_workload(dev, True),
              "directed": lambda dev: arxiv_workload(dev, False),
              "skewed_graph": lambda dev: skewed_graph_edges(),
              "skewed": lambda dev: gcn_bf16(prepared_on(
                  dev, workload("skewed_graph"), band_window=BAND_WINDOW,
                  **gcn_kw)),
              "skewed_plain": lambda dev: gcn_bf16(prepared_on(
                  dev, workload("skewed_graph"), **gcn_kw)),
              "skewed_products": lambda dev: products_widths_on(
                  workload("skewed")),
              "skewed_products_plain": lambda dev: products_widths_on(
                  workload("skewed_plain")),
              "gat_skewed": lambda dev: prepared_on(
                  dev, workload("skewed_graph"), attend_window=ATTEND_WINDOW,
                  **gat_kw),
              "gat_skewed_plain": lambda dev: prepared_on(
                  dev, workload("skewed_graph"), **gat_kw),
              "ogbn_arxiv": lambda dev: ogbn_data(),
              "gcn_ogbn_arxiv": lambda dev: ogbn_gcn_workload(
                  dev, workload("ogbn_arxiv")),
              # Generated with numpy from seed 0 into the git-ignored
              # build/ogb at a first run, read from there by the next.
              "ogbn_products": lambda dev: ogbn_data(
                  "ogbn-products", ROOT / "build" / "ogb", synthetic=True,
                  seed=0),
              "gcn_ogbn_products": lambda dev: ogbn_gcn_workload(
                  dev, workload("ogbn_products")),
              "gat_ogbn_products": lambda dev: ogbn_gat_workload(
                  dev, workload("ogbn_products"))}

    def workload(name):
        if name not in workloads:
            workloads[name] = makers[name](device)
        return workloads[name]

    if "kernels" in phases:
        cases, worst = kernel_sweep(device)
        attend_cases, attend_worst, hub = attend_sweep(device, timer)
        replaces = replaced_tpu_kernels()
        kernel_entries = time_kernel_cases(
            device, timer,
            {"arxiv": workload("arxiv")[0], "cora": workload("cora")[0],
             "gat_arxiv": workload("gat_arxiv")[0],
             "citeseer": workload("citeseer")[0],
             "sage_cora": workload("sage_cora")[0]},
            replaces)
        attention_contexts = {"gat_arxiv": workload("gat_arxiv")[0],
                              "citeseer": workload("citeseer")[0]}
        modes_cases, modes_worst, send_hub = modes_sweep(device, timer)
        kernel_entries += time_attend_cases(device, timer, attention_contexts,
                                            replaces, hub, send_hub)
        kernel_entries += time_mode_cases(device, timer, attention_contexts,
                                          replaces, hub, send_hub)
        composed_cases, composed_worst, composed_hub = composed_sweep(
            device, timer)
        kernel_entries += time_composed_cases(device, timer,
                                              attention_contexts, replaces)
        band_cases, band_worst = band_sweep(device)
        kernel_entries += time_band_cases(
            device, timer, {name: workload(name)[0] for name in (
                "skewed", "skewed_plain", "gat_skewed", "gat_skewed_plain")},
            replaces)
        segmax_cases, segmax_worst = segment_max_sweep(device)
        past_int32 = past_int32_case(device)
        kernel_entries += time_segment_max_cases(
            device, timer, {"gat_arxiv": workload("gat_arxiv")[0]}, replaces)
        emit("kernels", comparisons=cases + attend_cases + modes_cases
             + composed_cases + band_cases + segmax_cases,
             worst_abs_err={**worst, **attend_worst, **modes_worst,
                            **composed_worst, **band_worst, **segmax_worst},
             kernels=sorted(launch_counts()),
             past_2_31_elements=past_int32,
             wide_head_ms=time_wide_heads(device, timer,
                                          workload("gat_arxiv")[0]),
             hub_row_ms={**hub, "composed": composed_hub,
                         "sender_order": send_hub},
             timed=[{k: e[k] for k in ("name", "mode", "shape", "max_abs_err",
                                       "ms", "plain_ms", "library_ms",
                                       "bound_ms", "tier_ms",
                                       "without_tier_ms",
                                       "aten_segment_reduce_backward_ms",
                                       "library_tie_check") if k in e}
                    for e in kernel_entries if e["path"]])

    if "autograd" in phases:
        emit("autograd", grad_rel_err={
            **autograd_phase(device),
            **composed_autograd_phase(device, workload("citeseer")),
            **band_autograd_phase(device),
            **gin_sage_autograd_phase(device)})

    def arxiv_model():
        gen = torch.Generator(device=device).manual_seed(0)
        return kgt.GNNEncoder.for_context(
            "gcn", (HIDDEN, ARXIV_CLASSES), input_dim=ARXIV_FEATS,
            generator=gen, device=device)

    def gat_arxiv_model(fused_attend=True):
        gen = torch.Generator(device=device).manual_seed(0)
        return kgt.GNNEncoder.for_context(
            "gatv2", GAT_ARXIV_DIMS, input_dim=ARXIV_FEATS,
            conv_kwargs={"heads": GAT_ARXIV_HEADS,
                         "fused_attend": fused_attend},
            generator=gen, device=device)

    def gat_citeseer_model(fused_attend=True):
        gen = torch.Generator(device=device).manual_seed(0)
        return kgt.GNNEncoder.for_context(
            "gatv2", GAT_CITESEER_DIMS, input_dim=CITESEER["feats"],
            dropout_rate=0.3,
            conv_kwargs={"heads": GAT_CITESEER_HEADS, "dropout": 0.3,
                         "fused_attend": fused_attend},
            generator=gen, device=device)

    def cora_model():
        gen = torch.Generator(device=device).manual_seed(0)
        return CoraGCN(1_433, 16, 7, 0.5, gen, device)

    def products_gcn_model():
        gen = torch.Generator(device=device).manual_seed(0)
        return kgt.GNNEncoder.for_context(
            "gcn", (HIDDEN, PRODUCTS_CLASSES), input_dim=PRODUCTS_FEATS,
            generator=gen, device=device)

    def products_gat_model():
        gen = torch.Generator(device=device).manual_seed(0)
        return kgt.GNNEncoder.for_context(
            "gatv2", PRODUCTS_GAT_DIMS, input_dim=PRODUCTS_FEATS,
            conv_kwargs={"heads": GAT_ARXIV_HEADS, "fused_attend": True},
            generator=gen, device=device)

    def sage_pool_arxiv_model():
        gen = torch.Generator(device=device).manual_seed(0)
        return kgt.GraphSAGE((HIDDEN, ARXIV_CLASSES), aggregator="pooling",
                             input_dim=ARXIV_FEATS, generator=gen,
                             device=device)

    def gin_max_arxiv_model():
        gen = torch.Generator(device=device).manual_seed(0)
        return kgt.GNNEncoder("gin", (HIDDEN, ARXIV_CLASSES),
                              input_dim=ARXIV_FEATS,
                              conv_kwargs={"aggregator": "max"},
                              generator=gen, device=device)

    def sage_cora_model():
        gen = torch.Generator(device=device).manual_seed(0)
        return kgt.GNNEncoder("sage", (16, 7), input_dim=1_433,
                              conv_kwargs={"dropout_rate": 0.5},
                              generator=gen, device=device)

    adam = lambda model: torch.optim.Adam(model.parameters(), lr=1e-2)
    # GIN and GraphSAGE on the random arxiv-shaped graph: at 1e-2 their
    # first Adam steps overshoot (unnormalised maxes of 256-wide rows).
    adam_slow = lambda model: torch.optim.Adam(model.parameters(), lr=1e-3)
    adamw = lambda lr: (lambda model: torch.optim.AdamW(
        model.parameters(), lr=lr, weight_decay=5e-4))
    spmm_only = {"gather_scatter_sum_sorted": 3}  # L1 fwd, L2 fwd, L2 bwd
    # The GCN's operator takes the fused-gather scatter's row walk; every
    # other caller (the gather's VJP, the attention's finishes) its piece
    # walk, so each run's count of row walks is its GCN spmm calls.
    gcn_rows = {"gather_scatter_sum_sorted(rows)": 3}
    # Per GATv2 layer: one fused forward; in the backward one rho, one
    # receiver-backward and one sender finish (the fused-gather scatter).
    # Both layers run the whole backward: the input features need no
    # gradient, but ht = x @ kernel does.
    gat_two_layers = {"sddmm_stats_agg_sorted": 2, "attend_rho_sorted": 2,
                      "attend_recv_bwd_full_sorted": 2,
                      "gather_scatter_sum_sorted": 2}
    # Per composed GATv2 layer, read from GATv2Conv and ops/csr.py: forward
    # one score kernel, the two softmax kernels and the messages scatter;
    # backward the messages scatter's VJP (expand), the softmax's rho
    # (scatter over [E, H]) and rho_e (expand), the score backward kernel
    # and its d ht (scatter), and the gather's VJP (fused-gather scatter).
    gat_composed_two_layers = {
        "sddmm_scores_sorted": 2, "softmax_stats_sorted": 2,
        "softmax_apply_sorted": 2, "sddmm_bwd_sorted": 2,
        "scatter_sum_sorted": 6, "expand_sorted": 4,
        "gather_scatter_sum_sorted": 2}
    mean_of_ends = lambda l: sum(l[-5:]) < sum(l[:5])
    # name -> (workload, model, optimizer, compute dtype): what --profile
    # may name.
    runs = {
        "train_arxiv_shape": ("arxiv", arxiv_model, adam, torch.bfloat16),
        "train_directed": ("directed", arxiv_model, adam, torch.bfloat16),
        "train_cora_shape": ("cora", cora_model, adamw(0.01), None),
        "train_gat_arxiv_shape": ("gat_arxiv", gat_arxiv_model, adam,
                                  torch.bfloat16),
        "train_gat_citeseer_shape": ("citeseer", gat_citeseer_model,
                                     adamw(5e-3), None),
        "train_gat_arxiv_shape_composed": (
            "gat_arxiv", lambda: gat_arxiv_model(fused_attend=False), adam,
            torch.bfloat16),
        "train_gat_citeseer_shape_composed": (
            "citeseer", lambda: gat_citeseer_model(fused_attend=False),
            adamw(5e-3), None),
        "train_skewed_arxiv_shape": ("skewed", arxiv_model, adam,
                                     torch.bfloat16),
        "train_skewed_products_widths": ("skewed_products",
                                         products_gcn_model, adam,
                                         torch.bfloat16),
        "train_gat_skewed_arxiv_shape": ("gat_skewed", gat_arxiv_model, adam,
                                         torch.bfloat16),
        "train_sage_pool_arxiv_shape": ("gat_arxiv", sage_pool_arxiv_model,
                                        adam_slow, torch.bfloat16),
        "train_gin_max_arxiv_shape": ("gat_arxiv", gin_max_arxiv_model,
                                      adam_slow, torch.bfloat16),
        "train_sage_cora_shape": ("sage_cora", sage_cora_model, adamw(0.01),
                                  None),
        "train_gcn_ogbn_arxiv": ("gcn_ogbn_arxiv", arxiv_model, adam,
                                 torch.bfloat16),
        "train_gcn_ogbn_products": ("gcn_ogbn_products", products_gcn_model,
                                    adam, torch.bfloat16),
        "train_gat_ogbn_products": ("gat_ogbn_products", products_gat_model,
                                    adam, torch.bfloat16),
    }
    # The attention's module constants (ATTEND_BWD_MODE, ATTEND_SCORE_CACHE)
    # of the runs that set them; every other run keeps the defaults.
    run_modes = {
        "train_gat_arxiv_shape_send": ("send", True),
        "train_gat_arxiv_shape_nocache": ("permute", False),
        "train_gat_arxiv_shape_send_nocache": ("send", False),
        "train_gat_citeseer_shape_send": ("send", True),
        # Permute mode's per-edge v at products is [E, 256] bf16: 64.6 GB.
        "train_gat_ogbn_products": ("send", True),
    }
    for name in run_modes:
        base = name.replace("_send", "").replace("_nocache", "")
        runs[name] = runs[base]
    if args.profile is not None and args.profile not in runs:
        ap.error(f"--profile takes one of {sorted(runs)}")

    def train(name, **kwargs):
        wl, make_model, make_optimizer, compute_dtype = runs[name]
        ctx, x, y, mask = workload(wl)[:4]
        with attend_modes(*run_modes.get(name, ("permute", True))):
            path_launches[name], path_mode_launches[name] = train_phase(
                name, device, ctx, x, y, mask, make_model, make_optimizer,
                compute_dtype, **kwargs)

    if "train_arxiv_shape" in phases:
        ctx, _, _, _, prepare_s = workload("arxiv")
        check(ctx.num_real_edges == 2 * (ARXIV_EDGES // 2) and
              ctx.num_nodes == 169_472 and ctx.is_symmetric,
              "arxiv-shaped context has the wrong size")
        emit("prepare_arxiv_shape", host_seconds=prepare_s)
        train("train_arxiv_shape", steps=8, per_step=spmm_only,
              per_step_modes=gcn_rows, timed_iters=10)

    if "train_directed" in phases:
        check(not workload("directed")[0].is_symmetric,
              "directed context must not be symmetric")
        train("train_directed", steps=4, per_step=spmm_only,
              per_step_modes=gcn_rows, timed_iters=10)
    workloads.pop("directed", None)

    if "train_cora_shape" in phases:
        # layer 1: weighted scatter forward, expand + sender-sorted scatter
        # backward; layer 2: spmm forward and backward.
        train("train_cora_shape", steps=40,
              per_step={"scatter_sum_sorted": 1, "expand_sorted": 1,
                        "gather_scatter_sum_sorted": 3},
              per_step_modes={"gather_scatter_sum_sorted(rows)": 2},
              falling=mean_of_ends)
    workloads.pop("arxiv", None)
    torch.cuda.empty_cache()

    if "train_gat_arxiv_shape" in phases:
        ctx, _, _, _, prepare_s = workload("gat_arxiv")
        check(ctx.num_real_edges == GAT_ARXIV_EDGES + ARXIV_NODES and
              ctx.num_nodes == ARXIV_NODES and ctx.num_diag == 0,
              "arxiv-shaped attention context has the wrong size")
        emit("prepare_gat_arxiv_shape", host_seconds=prepare_s,
             slots=int(ctx.senders.shape[0]))
        train("train_gat_arxiv_shape", steps=8, per_step=gat_two_layers,
              timed_iters=10, profile=True)

    if "train_gat_citeseer_shape" in phases:
        train("train_gat_citeseer_shape", steps=40, per_step=gat_two_layers,
              timed_iters=10, falling=mean_of_ends)
        # The same graph through a model whose last layer averages its heads
        # (concat=False); its launches are reported on its own line only.
        ctx, x, y, mask = workload("citeseer")

        def mean_heads_model():
            gen = torch.Generator(device=device).manual_seed(0)
            return MeanHeadsGAT(
                CITESEER["feats"], GAT_CITESEER_DIMS[0], CITESEER["classes"],
                GAT_CITESEER_HEADS, 0.3, gen, device)

        train_phase("train_gat_citeseer_shape_mean_heads", device, ctx, x, y,
                    mask, mean_heads_model, adamw(5e-3), None, steps=20,
                    per_step=gat_two_layers, timed_iters=5,
                    falling=mean_of_ends)

    # The composed path: the same workloads and initial parameters as the
    # fused runs above, so step 1 is also held against the fused model.
    if "train_gat_arxiv_shape_composed" in phases:
        train("train_gat_arxiv_shape_composed", steps=8,
              per_step=gat_composed_two_layers, timed_iters=10,
              same_as=gat_arxiv_model)

    if "train_gat_citeseer_shape_composed" in phases:
        train("train_gat_citeseer_shape_composed", steps=40,
              per_step=gat_composed_two_layers, timed_iters=10,
              falling=mean_of_ends, same_as=gat_citeseer_model)

    # The attention's other modes: the same workloads and initial parameters
    # as the default runs above; step 1 also against the default modes'.
    # Send mode: the receiver backward writes no v and the sender backward
    # replaces the fused-gather finish; no score cache: the forward writes
    # no scores and rho and the receiver backward recompute them.
    gat_send = {**gat_two_layers, "attend_send_bwd_sorted": 2}
    del gat_send["gather_scatter_sum_sorted"]
    send_modes = {"attend_recv_bwd_full_sorted(emit_v=False)": 2}
    nocache_modes = {"sddmm_stats_agg_sorted(emit_scores=False)": 2,
                     "attend_rho_sorted(scores=None)": 2,
                     "attend_recv_bwd_full_sorted(scores=None)": 2}
    for name, per_step, per_step_modes in (
            ("train_gat_arxiv_shape_send", gat_send, send_modes),
            ("train_gat_arxiv_shape_nocache", gat_two_layers, nocache_modes),
            ("train_gat_arxiv_shape_send_nocache", gat_send,
             {**send_modes, **nocache_modes})):
        if name in phases:
            train(name, steps=8, per_step=per_step, timed_iters=10,
                  per_step_modes=per_step_modes, against_default_modes=True,
                  profile=True)
    if "train_gat_citeseer_shape_send" in phases:
        # Attention dropout: the layers draw the mask pair, and the sender
        # backward reads the sender-order twin.
        train("train_gat_citeseer_shape_send", steps=40, per_step=gat_send,
              timed_iters=10, falling=mean_of_ends,
              per_step_modes=send_modes, against_default_modes=True)

    if "attend_two_pass_arxiv_shape" in phases:
        path_launches["attend_two_pass_arxiv_shape"] = two_pass_phase(
            device, workload("gat_arxiv")[0], timer)
        path_mode_launches["attend_two_pass_arxiv_shape"] = (
            mode_launch_counts())

    # The segment max kernels. The narrow one has no module caller: its own
    # phase is its path. The wide one carries GraphSAGE's pooling and GIN's
    # max on the GATv2 arxiv graph: per layer one forward; its backward
    # (ties split) wherever the messages need a gradient (both SAGE layers:
    # the pooling Dense; GIN's second layer only); and the gather's VJP
    # (the fused-gather scatter) at the second layer, whose input needs one.
    if "segment_max_narrow_arxiv_shape" in phases:
        path_launches["segment_max_narrow_arxiv_shape"] = (
            segment_max_narrow_phase(device, workload("gat_arxiv")[0],
                                     timer))
        path_mode_launches["segment_max_narrow_arxiv_shape"] = (
            mode_launch_counts())
    split = "segment_max_wide_bwd(ties_split)"
    if "train_sage_pool_arxiv_shape" in phases:
        train("train_sage_pool_arxiv_shape", steps=8, timed_iters=10,
              per_step={"segment_max_wide_sorted": 2,
                        "segment_max_wide_bwd": 2,
                        "gather_scatter_sum_sorted": 1},
              per_step_modes={split: 2})
    if "train_gin_max_arxiv_shape" in phases:
        train("train_gin_max_arxiv_shape", steps=8, timed_iters=10,
              per_step={"segment_max_wide_sorted": 2,
                        "segment_max_wide_bwd": 1,
                        "gather_scatter_sum_sorted": 1},
              per_step_modes={split: 1})
    # GraphSAGE's mean with message dropout takes the per-edge path: the
    # messages-form scatter per layer; at layer 2 its VJP (expand) and the
    # gather's VJP.
    if "train_sage_cora_shape" in phases:
        train("train_sage_cora_shape", steps=40, timed_iters=10,
              per_step={"scatter_sum_sorted": 2, "expand_sorted": 1,
                        "gather_scatter_sum_sorted": 1},
              falling=mean_of_ends)
    workloads.pop("sage_cora", None)

    # The locality tier. Layer 1 propagates first (F = 128, no backward: x
    # needs no gradient), layer 2 runs at F = 40 forward and backward: the
    # band kernel and the residual's fused-gather scatter three times each.
    if "train_skewed_arxiv_shape" in phases:
        graph = workload("skewed_graph")
        ctx, x, _, _, prepare_s = workload("skewed")
        plain_ctx = workload("skewed_plain")[0]
        stream = ctx.num_band_edges + ctx.num_real_edges
        check(ctx.num_nodes == plain_ctx.num_nodes == 169_472 and
              stream == plain_ctx.num_real_edges and ctx.is_symmetric and
              ctx.band.band.dtype == torch.bfloat16,
              "skewed context has the wrong size or type")
        locality = dict(
            band_edges=ctx.num_band_edges, residual_edges=ctx.num_real_edges,
            banded_fraction=ctx.num_band_edges / stream,
            band_mb=ctx.band.band.numel() * ctx.band.band.element_size()
            / 2**20)
        emit("prepare_skewed_arxiv_shape", edges=int(graph["edges"].shape[1]),
             generate_seconds=graph["generate_s"],
             cluster_order_seconds=graph["cluster_order_s"],
             band_coverage_scrambled=graph["coverage_scrambled"],
             band_coverage_reordered=graph["coverage"],
             prepare_graph_seconds_with_band=prepare_s,
             prepare_graph_seconds_without=workload("skewed_plain")[4],
             **locality)
        train("train_skewed_arxiv_shape", steps=8,
              per_step={"band_spmm": 3, "gather_scatter_sum_sorted": 3},
              per_step_modes={"band_spmm(wgmma)": 3, **gcn_rows},
              timed_iters=10,
              same_graph=workload("skewed_plain")[:4], extra=locality,
              profile=True)
        # bench.py's best_* hoisting: S @ x once, on both contexts.
        from keras_geometric_tpu_torch.utils import timed_steps

        xb = x.to(torch.bfloat16)
        banded = kgt.precompute_propagation(ctx, xb)
        plain = kgt.precompute_propagation(plain_ctx, xb)
        scale = plain.float().abs().max().item()
        err = (banded.float() - plain.float()).abs().max().item()
        check(bool(torch.isfinite(banded).all()) and err <= 2e-2 * scale,
              f"precompute_propagation on the band context: max abs err "
              f"{err:.3e} against scale {scale:.3e}")
        emit("precompute_skewed_arxiv_shape", max_abs_err=err, scale=scale,
             ms_with_band=1e3 * timed_steps(
                 lambda: kgt.precompute_propagation(ctx, xb), k_hi=12),
             ms_without=1e3 * timed_steps(
                 lambda: kgt.precompute_propagation(plain_ctx, xb),
                 k_hi=12))
        del xb, banded, plain
    # The same graph and band at ogbn-products' widths (100 -> 256 -> 47):
    # every band launch at a width that is not a multiple of 8 (layer 1
    # propagates first at F = 100, layer 2 runs at F = 47 forward and
    # backward), three a step on the wgmma_flat route, and the residual's
    # row walk three times.
    if "train_skewed_products_widths" in phases:
        ctx, x = workload("skewed_products")[:2]
        check(ctx is workload("skewed")[0] and
              tuple(x.shape) == (ctx.num_nodes, PRODUCTS_FEATS) and
              ctx.band.band.dtype == torch.bfloat16,
              "the products-width skewed workload has the wrong size")
        stream = ctx.num_band_edges + ctx.num_real_edges
        train("train_skewed_products_widths", steps=8,
              per_step={"band_spmm": 3, "gather_scatter_sum_sorted": 3},
              per_step_modes={"band_spmm(wgmma_flat)": 3, **gcn_rows},
              timed_iters=10,
              same_graph=workload("skewed_products_plain")[:4],
              extra=dict(band_edges=ctx.num_band_edges,
                         residual_edges=ctx.num_real_edges,
                         banded_fraction=ctx.num_band_edges / stream,
                         widths=[PRODUCTS_FEATS, HIDDEN, PRODUCTS_CLASSES]),
              profile=True)
    workloads.pop("skewed_products_plain", None)
    workloads.pop("skewed_plain", None)
    if args.profile != "train_skewed_products_widths":
        workloads.pop("skewed_products", None)
    if args.profile not in ("train_skewed_arxiv_shape",
                            "train_skewed_products_widths"):
        workloads.pop("skewed", None)
    torch.cuda.empty_cache()

    # Per GATv2 layer as in train_gat_arxiv_shape, but the sender finish is
    # the window scatter plus the fused-gather scatter over the residual.
    if "train_gat_skewed_arxiv_shape" in phases:
        ctx, _, _, _, prepare_s = workload("gat_skewed")
        plain_ctx = workload("gat_skewed_plain")[0]
        plan = ctx.attw_plan
        check(ctx.num_real_edges == plain_ctx.num_real_edges and
              ctx.num_nodes == 169_984 and ctx.senders.shape[0] % 2048 == 0,
              "skewed attention context has the wrong size")
        locality = dict(
            slots=int(ctx.senders.shape[0]), windows=plan.num_windows,
            work_items=plan.num_work, eligible_slots=plan.num_band_edges,
            window_eligible_fraction=plan.num_band_edges / ctx.num_real_edges,
            residual_slots=int(ctx.attw_perm_res.shape[0]))
        emit("prepare_gat_skewed_arxiv_shape",
             prepare_graph_seconds_with_window=prepare_s,
             prepare_graph_seconds_without=workload("gat_skewed_plain")[4],
             **locality)
        train("train_gat_skewed_arxiv_shape", steps=8,
              per_step={**gat_two_layers, "window_scatter_sum": 2},
              timed_iters=10, same_graph=workload("gat_skewed_plain")[:4],
              extra=locality)
    workloads.pop("gat_skewed_plain", None)
    if args.profile != "train_gat_skewed_arxiv_shape":
        workloads.pop("gat_skewed", None)
    torch.cuda.empty_cache()

    # The data tier: the repository's ogbn-arxiv cache, sampled minibatches
    # of GraphSAGE (no hand-written kernel: library segment ops), then the
    # full-graph GCN of train_arxiv_shape on the dataset's own graph.
    if "train_sage_minibatch_ogbn_arxiv" in phases:
        path_launches["train_sage_minibatch_ogbn_arxiv"] = (
            sage_minibatch_phase(device, workload("ogbn_arxiv")))
        path_mode_launches["train_sage_minibatch_ogbn_arxiv"] = (
            mode_launch_counts())
        torch.cuda.empty_cache()
    if "train_gcn_ogbn_arxiv" in phases:
        ctx, _, _, mask, prepare_s = workload("gcn_ogbn_arxiv")
        ds = workload("ogbn_arxiv")["dataset"]
        check(ctx.num_real_edges == ds.num_edges and
              ctx.num_nodes == 169_472 and ctx.is_symmetric and
              int(mask.sum()) == len(workload("ogbn_arxiv")["split"]["train"]),
              "the ogbn-arxiv context has the wrong size")
        emit("prepare_gcn_ogbn_arxiv", host_seconds=prepare_s,
             load_seconds=workload("ogbn_arxiv")["load_s"],
             is_synthetic=ds.is_synthetic, stream_edges=ctx.num_real_edges,
             train_nodes=int(mask.sum()))
        train("train_gcn_ogbn_arxiv", steps=20, per_step=spmm_only,
              per_step_modes=gcn_rows, timed_iters=10, profile=True)
    if args.profile != "train_gcn_ogbn_arxiv":
        workloads.pop("gcn_ogbn_arxiv", None)
    torch.cuda.empty_cache()

    # ogbn-products (BASELINE.json's north star) on the one card: the
    # full-graph GCN (K1's row walk, 3 a step) and the send-mode fused GATv2
    # (2 each of K9, K10b, K10c without v and K10d a step) at full width;
    # step 1 against the plain versions run block by block.
    def products_prepared(name, ctx, mask, prepare_s, slots):
        data = workload("ogbn_products")
        ds = data["dataset"]
        check(ds.num_nodes == PRODUCTS_NODES and
              ds.num_edges == PRODUCTS_EDGES and
              data["x"].shape[1] == PRODUCTS_FEATS and
              int(mask.sum()) == len(data["split"]["train"]) and
              int(ctx.senders.shape[0]) == slots,
              f"{name}: the ogbn-products context has the wrong size")
        from keras_geometric_tpu_torch import native

        emit("prepare_" + name.removeprefix("train_"),
             dataset_seconds=data["dataset_s"], load_seconds=data["load_s"],
             cache_reused=data["cache_reused"], is_synthetic=ds.is_synthetic,
             native_available=native.available(),
             prepare_graph_seconds=prepare_s,
             host_peak_rss_gib=host_peak_rss_gib(), nodes=ctx.num_nodes,
             stream_edges=ctx.num_real_edges, slots=slots,
             train_nodes=int(mask.sum()))

    def products_kernels(path, make_entries, phase_start):
        """The path's kernels at its shapes, also on a line of their own
        (a run of a subset of the phases prints no kernels line), with the
        seconds they and the whole phase took."""
        start = time.perf_counter()
        entries = make_entries()
        kernel_entries.extend(entries)
        emit("kernels_" + path.removeprefix("train_"),
             seconds=time.perf_counter() - start,
             phase_seconds=time.perf_counter() - phase_start,
             timed=[{k: e[k] for k in (
                 "name", "mode", "shape", "max_abs_err", "ms", "plain_ms",
                 "library_ms", "bound_ms", "bound_ms_if_gather_not_reused",
                 "pieces", "split_rows", "padded_width",
                 "ms_at_padded_width") if k in e} for e in entries])

    if "train_gcn_ogbn_products" in phases:
        phase_start = time.perf_counter()
        ctx, x, _, mask, prepare_s = workload("gcn_ogbn_products")
        check(ctx.num_real_edges == PRODUCTS_EDGES and ctx.is_symmetric and
              ctx.num_nodes == PRODUCTS_N_PAD, "products GCN context size")
        products_prepared("train_gcn_ogbn_products", ctx, mask, prepare_s,
                          -(-PRODUCTS_EDGES // 1024) * 1024)
        train("train_gcn_ogbn_products", steps=PRODUCTS_STEPS,
              per_step=spmm_only, per_step_modes=gcn_rows,
              timed_iters=PRODUCTS_TIMED, profile=True,
              plain_block_slots=PLAIN_GCN_BLOCK_SLOTS)
        products_kernels("train_gcn_ogbn_products", lambda: (
            products_gcn_entries(
                timer, replaced_tpu_kernels(), "train_gcn_ogbn_products", ctx,
                x, torch.Generator(device=device).manual_seed(31))),
            phase_start)
        del ctx, x, mask
    workloads.pop("gcn_ogbn_products", None)
    torch.cuda.empty_cache()
    if "train_gat_ogbn_products" in phases:
        phase_start = time.perf_counter()
        ctx, _, _, mask, prepare_s = workload("gat_ogbn_products")
        loops = PRODUCTS_EDGES + PRODUCTS_NODES
        check(ctx.num_real_edges == loops and ctx.num_diag == 0 and
              ctx.num_nodes == PRODUCTS_NODES, "products GATv2 context size")
        products_prepared("train_gat_ogbn_products", ctx, mask, prepare_s,
                          -(-loops // 1024) * 1024)
        train("train_gat_ogbn_products", steps=PRODUCTS_STEPS,
              per_step=gat_send, per_step_modes=send_modes,
              timed_iters=PRODUCTS_TIMED, profile=True,
              plain_block_slots=PLAIN_GAT_BLOCK_SLOTS)
        from keras_geometric_tpu_torch.ops import csr as ops_csr

        check((ops_csr.ATTEND_BWD_MODE, ops_csr.ATTEND_SCORE_CACHE) ==
              ("permute", True), "the attention's modes were not restored")
        products_kernels("train_gat_ogbn_products", lambda: (
            products_attend_entries(
                timer, replaced_tpu_kernels(), "train_gat_ogbn_products", ctx,
                torch.Generator(device=device).manual_seed(32))),
            phase_start)
        del ctx, mask
    for name in ("gat_ogbn_products", "ogbn_products"):
        if args.profile not in ("train_gat_ogbn_products",
                                "train_gcn_ogbn_products"):
            workloads.pop(name, None)
    torch.cuda.empty_cache()

    # Partitioned full-graph training (parallel/): the distributed step on a
    # mesh of one card, then a four-partition plan run partition by
    # partition against the single-device ops.
    for phase, run_phase in (
            ("train_distributed_arxiv_shape", lambda: (
                distributed_training_phase(
                    device, timer, workload, arxiv_model, gat_arxiv_model,
                    replaced_tpu_kernels()))),
            ("distributed_partitions_arxiv_shape", lambda: (
                distributed_partitions_phase(device, timer, workload,
                                             replaced_tpu_kernels())))):
        if phase in phases:
            (path_launches[phase], path_mode_launches[phase],
             entries) = run_phase()
            kernel_entries += entries
    workloads.pop("skewed_graph", None)
    torch.cuda.empty_cache()

    # Tensor and data parallelism (parallel/tensor_parallel.py,
    # data_parallel.py): four processes on the card each, library ops only.
    for phase, run_phase in (
            ("tensor_parallel_arxiv_shape",
             lambda: tensor_parallel_phase(device)),
            ("train_dp_graph_classification",
             lambda: dp_graph_classification_phase(device))):
        if phase in phases:
            path_launches[phase], path_mode_launches[phase] = run_phase()

    # Graph classification (BASELINE.json config 3) and the readouts: the
    # edge-list GIN and the pooling run library ops, no hand-written kernel.
    # Then each twin of examples/ in a process of its own.
    if "train_gin_graph_classification" in phases:
        path_launches["train_gin_graph_classification"] = (
            graph_classification_phase(device))
        path_mode_launches["train_gin_graph_classification"] = (
            mode_launch_counts())
    if "readouts_on_card" in phases:
        path_launches["readouts_on_card"] = readouts_phase(device, timer)
        path_mode_launches["readouts_on_card"] = mode_launch_counts()
    if "examples_torch" in phases:
        (path_launches["examples_torch"],
         path_mode_launches["examples_torch"], entries) = twins_on_card(
             device, timer)
        kernel_entries += entries
        examples_phase()

    # The hardware accuracy gate: kernel-path training trajectories against
    # the plain edge-list path over 60 steps (tools/accuracy_check_torch.py).
    if "accuracy_trajectory" in phases:
        workloads.clear()
        torch.cuda.empty_cache()
        accuracy_trajectory_phase(device, smi)

    if args.profile is not None:
        from keras_geometric_tpu_torch.training import (
            make_node_classification_step,
        )

        wl, make_model, make_optimizer, compute_dtype = runs[args.profile]
        ctx, x, y, mask = workload(wl)[:4]
        model = make_model()
        step = make_node_classification_step(
            model, make_optimizer(model), compute_dtype=compute_dtype,
            generator=torch.Generator(device=device).manual_seed(7))
        with attend_modes(*run_modes.get(args.profile, ("permute", True))):
            emit("profile_" + args.profile.removeprefix("train_"),
                 **profile_steps(lambda: step(x, None, y, mask, context=ctx)))

    if set(phases) != set(PHASES):
        # A partial run is no pass: no "ok" key, and a code of its own.
        print(json.dumps({"partial": phases,
                          "exit_code": PARTIAL_EXIT_CODE}), flush=True)
        return PARTIAL_EXIT_CODE

    # Each entry carries its kernel's launches in the training run that gives
    # it the entry's shape, and that run must have launched it. Shapes no run
    # reaches are listed apart, with their times and no launches.
    on_path = [e for e in kernel_entries if e["path"]]
    check({e["name"] for e in on_path} == set(launch_counts()),
          "a kernel has no entry at a shape of the training runs")
    for entry in on_path:
        entry["launches"] = path_launches[entry["path"]][entry["name"]]
        check(entry["launches"] > 0, f"kernel {entry['name']} was never "
              f"launched by {entry['path']}")
        if "mode" in entry:  # and its launches in that mode
            entry["mode_launches"] = {
                key: path_mode_launches[entry["path"]][key]
                for key in (f"{entry['name']}({part.strip()})"
                            for part in entry["mode"].split(","))}
            check(all(entry["mode_launches"].values()),
                  f"kernel {entry['name']} ({entry['mode']}) was never "
                  f"launched in that mode by {entry['path']}")
    print(json.dumps({
        "kernels": on_path,
        "launches_by_path": path_launches,
        "mode_launches_by_path": path_mode_launches,
        "timed_at_shapes_no_path_launches": [
            e for e in kernel_entries if not e["path"]],
        "seconds": time.perf_counter() - t_start}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
