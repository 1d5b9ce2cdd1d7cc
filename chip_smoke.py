#!/usr/bin/env python3
"""Drive keras_geometric_tpu_torch on one NVIDIA GPU: build its CUDA kernels,
hold each against its plain PyTorch version, and train the 2-layer GCN through
the package's entry points.

Run from the repository root, with no arguments, on a machine with one CUDA
card, nvcc and PyTorch built for CUDA::

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure ends the run with a non-zero
exit code and without the final line):

1. ``device``   card, power limit (nvidia-smi), toolchain, kernel build;
2. ``kernels``  every kernel against its plain version on a skewed-degree
                graph (hub row, empty rows, padded slots; bf16 and f32;
                F in 128, 40, 16, 7; weighted / unweighted / masked), then
                timings at the shapes the training paths use;
3. ``autograd`` gradients of ``GraphContext.spmm`` (symmetric and general),
                ``gather`` and ``scatter_weighted`` through the kernels against
                autograd over the plain versions;
4. ``train_arxiv_shape``  the slice at full width: 169,343 nodes, 1,166,242
                symmetric stream edges, 128 features, 256 hidden, 40 classes,
                bf16 IO / f32 master parameters, Adam;
5. ``train_directed`` (the general, asymmetric operator) and
   ``train_cora_shape`` (2,708 nodes / 10,556 edges / 1,433 features / 16
                hidden / 7 classes, dropout 0.5 on layer 1: gather + weighted
                scatter forward, expand kernel in the backward).

Then one line ``{"kernels": [...]}``, the card's name and power limit as
``nvidia-smi`` prints them, and last ``{"ok": true, "device": {...}}``.

Tolerances. Kernel against plain version, per output element:
``|kernel - plain| <= 1e-6 + 2e-5 * S + u * |plain|`` with ``S`` the sum of
``|w * message|`` over the element's row (both sides accumulate in f32, in
another order) and ``u`` one unit in the last place of the stored type: 0 for
f32, ``2**-7`` for bf16 (both sides round the f32 sum once, and the two
roundings may fall on neighbouring bf16 values). Training step 1 through
the kernels against the same step through the plain versions: loss within
``1e-4`` (f32) / ``2e-2`` (bf16 IO), every gradient within ``2e-4`` / ``5e-2``
of its largest entry.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

PHASES = ("device", "kernels", "autograd", "train_arxiv_shape",
          "train_directed", "train_cora_shape")

ARXIV_NODES = 169_343
ARXIV_EDGES = 1_166_243
ARXIV_FEATS = 128
ARXIV_CLASSES = 40
HIDDEN = 256

SOURCE = "keras_geometric_tpu_torch/kernels/csrc/spmm.cu"
# Line of the pl.pallas_call each kernel replaces, in the reference package's
# kernels/spmm_pallas.py.
REPLACES_LINE = {
    "scatter_sum_sorted": 319,
    "gather_scatter_sum_sorted": 319,
    "expand_sorted": 620,
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def replaced_tpu_kernels() -> dict:
    """``file:line`` of the TPU kernel each CUDA kernel replaces: the
    reference's source is found in the checkout and each line is checked to
    hold a ``pallas_call``."""
    root = pathlib.Path(__file__).resolve().parent
    found = sorted(root.glob("*/kernels/spmm_pallas.py"))
    check(len(found) == 1, "the reference's kernels/spmm_pallas.py not found")
    lines = found[0].read_text().splitlines()
    for name, line in REPLACES_LINE.items():
        check("pallas_call" in lines[line - 1],
              f"{name}: no pallas_call at line {line} of {found[0].name}")
    rel = found[0].relative_to(root).as_posix()
    return {name: f"{rel}:{line}" for name, line in REPLACES_LINE.items()}


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
    CUDA events after a write over a buffer larger than the L2 cache, so the
    call finds the cache as cold as it would behind other work."""

    def __init__(self, device):
        self.flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8,
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


def compare(kernel_out, plain_out, mass, dtype, what):
    """max |kernel - plain|, checked element by element against
    ``ATOL + RTOL_MASS * mass + ULP[dtype] * |plain|``."""
    check(kernel_out.shape == plain_out.shape and
          kernel_out.dtype == plain_out.dtype, f"{what}: shape/dtype differ")
    k, p = kernel_out.float(), plain_out.float()
    check(bool(torch.isfinite(k).all()), f"{what}: kernel output not finite")
    err = (k - p).abs()
    allowed = ATOL + RTOL_MASS * mass + ULP[dtype] * p.abs()
    ratio = (err / allowed).max().item()
    check(ratio <= 1.0, f"{what}: kernel disagrees with its plain version "
          f"(max abs err {err.max().item():.3e}, {ratio:.2f}x the tolerance)")
    return err.max().item()


def skewed_graph(device, n=20_000, seed=1):
    """Receiver-sorted stream with one hub row (20,000 edges), every odd row
    empty, and padded slots (weight 0) inside the last row."""
    rng = np.random.default_rng(seed)
    recv = np.concatenate([
        np.full(20_000, 6), 2 * rng.integers(0, n // 2 - 1, 100_000),
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
                    ref = K.gather_scatter_sum_sorted_plain(
                        rows, g["idx"], g["recv"], n, weights=w,
                        self_weight=self_w)
                    worst["gather_scatter_sum_sorted"] = max(
                        worst["gather_scatter_sum_sorted"],
                        compare(out, ref, mass, dtype,
                                f"gather_scatter_sum_sorted {tag}"))
                    cases += 1
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


def time_kernel_cases(device, timer, contexts, replaces):
    """Kernel, plain version and library call at the layer-1 and layer-2
    shapes, each with its bound from bytes and operations. ``path`` names the
    training run that gives the kernel that shape, None where none does (the
    arxiv-shaped runs never form messages, so they launch neither the
    messages form nor expand)."""
    from keras_geometric_tpu_torch.kernels import spmm_cuda as K
    from keras_geometric_tpu_torch.utils.profiling import (
        H100_BYTES_PER_S,
        H100_F32_OPS_PER_S,
    )

    gen = torch.Generator(device=device).manual_seed(2)
    entries = []
    on_arxiv = {"gather_scatter_sum_sorted": "train_arxiv_shape",
                "scatter_sum_sorted": None, "expand_sorted": None}
    for ctx_name, layer, f, dtype, kernels in (
        ("arxiv", "layer 1", ARXIV_FEATS, torch.bfloat16, on_arxiv),
        ("arxiv", "layer 2", ARXIV_CLASSES, torch.bfloat16, on_arxiv),
        ("cora", "layer 2", 7, torch.float32,
         {"gather_scatter_sum_sorted": "train_cora_shape"}),
        ("cora", "layer 1", 16, torch.float32,
         {"scatter_sum_sorted": "train_cora_shape",
          "expand_sorted": "train_cora_shape"}),
    ):
        ctx = contexts[ctx_name]
        n, e = ctx.num_nodes, ctx.receivers.shape[0]
        es = 2 if dtype == torch.bfloat16 else 4
        ws = ctx.edge_weight.element_size()
        h = torch.randn(n, f, generator=gen, device=device).to(dtype)
        msgs = torch.randn(e, f, generator=gen, device=device).to(dtype)
        w, sw = ctx.edge_weight, ctx.self_weight
        edge_ids = torch.arange(e, device=device)
        for name, path in kernels.items():
            if name == "gather_scatter_sum_sorted":
                kernel = lambda: K.gather_scatter_sum_sorted(
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
                    msgs, ctx.receivers, n, row_ptr=ctx.row_ptr, weights=w)
                plain = lambda: K.scatter_sum_sorted_plain(
                    msgs, ctx.receivers, n, weights=w)
                mass = K.scatter_sum_sorted_plain(
                    msgs.float().abs(), ctx.receivers, n, weights=w.float())
                lib = (ctx.receivers, edge_ids, w, (n, e), msgs)
                nbytes = e * f * es + n * f * es + e * ws + (n + 1) * 4
                no_reuse = None
                ops = 2 * e * f
            else:
                kernel = lambda: K.expand_sorted(
                    h, ctx.receivers, row_ptr=ctx.row_ptr, weights=w)
                plain = lambda: K.expand_sorted_plain(
                    h, ctx.receivers, weights=w)
                mass = None
                lib = (edge_ids, ctx.receivers, w, (e, n), h)
                nbytes = n * f * es + e * f * es + e * (4 + ws)
                no_reuse = None
                ops = e * f
            k_out, p_out = kernel(), plain()
            if mass is None:
                mass = p_out.float().abs()
            err = compare(k_out, p_out, mass, dtype,
                          f"{name} at {ctx_name} {layer}")
            del k_out, p_out, mass
            ms = timer.cold_ms(kernel)
            plain_ms = timer.cold_ms(plain, iters=10)
            library_ms, library_note = sparse_library_ms(timer, *lib)
            # The card's published peaks: memory rate, and f32 outside the
            # tensor cores (the kernels multiply-add in f32).
            t_bytes = nbytes / H100_BYTES_PER_S * 1e3
            t_ops = ops / H100_F32_OPS_PER_S * 1e3
            entry = {
                "name": name, "route": "cuda", "source": SOURCE,
                "replaces": replaces[name], "path": path,
                "shape": f"{ctx_name} {layer}: E={e} N={n} F={f} "
                         f"{str(dtype)[6:]} weights {str(w.dtype)[6:]}",
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
            entries.append(entry)
    return entries


# ---------------------------------------------------------------------------
# Plain contexts: the same operators through the kernels' plain versions,
# differentiated by autograd over PyTorch's own ops. For comparison only.
# ---------------------------------------------------------------------------


class PlainContext:
    def __init__(self, ctx):
        self.ctx = ctx
        self.self_weight = ctx.self_weight

    def spmm(self, h):
        from keras_geometric_tpu_torch.kernels import spmm_cuda as K

        c = self.ctx
        return K.gather_scatter_sum_sorted_plain(
            h, c.senders, c.receivers, c.num_nodes, weights=c.edge_weight,
            self_weight=c.self_weight)

    def gather(self, h):
        return h.index_select(0, self.ctx.senders)

    def scatter_weighted(self, messages):
        from keras_geometric_tpu_torch.kernels import spmm_cuda as K

        c = self.ctx
        return K.scatter_sum_sorted_plain(
            messages, c.receivers, c.num_nodes, weights=c.edge_weight)


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
    torch.cuda.synchronize()
    return results


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def arxiv_workload(device, symmetric: bool):
    """The uniform arxiv-shaped workload, rebuilt with numpy from seed 0."""
    import keras_geometric_tpu_torch as kgt

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


def cora_workload(device):
    import keras_geometric_tpu_torch as kgt

    rng = np.random.default_rng(0)
    n, pairs, feats, classes = 2_708, 5_278, 1_433, 7
    a = rng.integers(0, n, pairs)
    b = rng.integers(0, n, pairs)
    edges = np.stack([np.concatenate([a, b]), np.concatenate([b, a])])
    x = (rng.random((n, feats)) < 0.02).astype(np.float32)  # sparse bag of words
    y = (x @ rng.standard_normal((feats, classes))).argmax(1).astype(np.int64)
    mask = rng.random(n) < 0.5
    ctx = kgt.prepare_graph(edges, n, add_self_loops=True, gcn_normalize=True,
                            device=device)
    dev = lambda arr: torch.from_numpy(arr).to(device)
    return ctx, dev(x), dev(y), dev(mask)


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
                falling=lambda l: l[-1] < l[0]):
    from keras_geometric_tpu_torch.kernels import spmm_cuda as K
    from keras_geometric_tpu_torch.training import make_node_classification_step
    from keras_geometric_tpu_torch.utils import timed_steps

    make_gen = lambda: torch.Generator(device=device).manual_seed(7)
    # Step 1 through the kernels against step 1 through the plain versions.
    k_loss, k_grads = first_step(make_model, make_gen, ctx, x, y, mask,
                                 compute_dtype)
    p_loss, p_grads = first_step(make_model, make_gen, PlainContext(ctx), x,
                                 y, mask, compute_dtype)
    l_tol, g_tol = (1e-4, 2e-4) if compute_dtype is None else (2e-2, 5e-2)
    check(math.isfinite(k_loss) and abs(k_loss - p_loss) <= l_tol,
          f"{name}: step-1 loss {k_loss} vs plain {p_loss}")
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
    K.reset_launch_counts()
    losses = [step(x, None, y, mask, context=ctx) for _ in range(steps)]
    step_ms = timed_steps(lambda: step(x, None, y, mask, context=ctx),
                          warmup=2, iters=timed_iters)
    torch.cuda.synchronize()
    counts = dict(K.LAUNCH_COUNTS)
    total_steps = steps + 2 + timed_iters
    losses = [l.item() for l in losses]
    check(all(math.isfinite(l) for l in losses), f"{name}: loss not finite")
    check(falling(losses), f"{name}: loss did not fall: {losses}")
    expected = {k: per_step.get(k, 0) * total_steps for k in counts}
    check(counts == expected,
          f"{name}: launch counts {counts}, expected {expected}")
    logits_ok = all(torch.isfinite(p).all().item() for p in model.parameters())
    check(logits_ok, f"{name}: parameters not finite after training")
    emit(name, steps=total_steps, losses=losses, step1_loss=k_loss,
         step1_loss_plain=p_loss, step1_grad_rel_err=grad_err,
         launches_per_step=per_step, launches=counts, step_ms=step_ms,
         peak_memory_mb=torch.cuda.max_memory_allocated() / 2**20,
         nodes=ctx.num_nodes, stream_edges=ctx.num_real_edges,
         compute_dtype=str(compute_dtype or torch.float32)[6:])
    return counts


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
    rows = [r for r in rows if r[0] > 0]
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="after the phases, trace a few steps of the "
                         "arxiv-shaped trainer and print device time by kernel")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset (the final line is printed "
                         "only when every phase ran)")
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
    from keras_geometric_tpu_torch.kernels import spmm_cuda as K

    t_start = time.perf_counter()
    device = torch.device("cuda")
    torch.manual_seed(0)
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)

    # 1. device + build (always: everything below needs the library)
    K._library()
    nvcc = subprocess.run([_build._find_nvcc(), "--version"],
                          capture_output=True, text=True, timeout=60)
    emit("device", kind=kind, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         nvcc=nvcc.stdout.strip().splitlines()[-2:],
         capability=list(torch.cuda.get_device_capability(0)),
         kernel_build_seconds=_build.BUILD_SECONDS,
         nvcc_flags=list(_build.NVCC_FLAGS), package=kgt.__version__)

    timer = Timer(device)
    kernel_entries = []
    path_launches = {}  # training run -> each kernel's launches in that run
    workloads = {}

    def workload(name):
        if name not in workloads:
            if name == "cora":
                workloads[name] = cora_workload(device)
            else:
                workloads[name] = arxiv_workload(device, name == "arxiv")
        return workloads[name]

    if "kernels" in phases:
        cases, worst = kernel_sweep(device)
        contexts = {"arxiv": workload("arxiv")[0], "cora": workload("cora")[0]}
        kernel_entries = time_kernel_cases(device, timer, contexts,
                                           replaced_tpu_kernels())
        emit("kernels", comparisons=cases, worst_abs_err=worst,
             kernels=sorted(K.LAUNCH_COUNTS),
             timed=[{k: e[k] for k in ("name", "shape", "max_abs_err", "ms",
                                       "plain_ms", "library_ms", "bound_ms")}
                    for e in kernel_entries if e["path"]])

    if "autograd" in phases:
        emit("autograd", grad_rel_err=autograd_phase(device))

    def arxiv_model():
        gen = torch.Generator(device=device).manual_seed(0)
        return kgt.GNNEncoder.for_context(
            "gcn", (HIDDEN, ARXIV_CLASSES), input_dim=ARXIV_FEATS,
            generator=gen, device=device)

    adam = lambda model: torch.optim.Adam(model.parameters(), lr=1e-2)
    spmm_only = {"gather_scatter_sum_sorted": 3}  # L1 fwd, L2 fwd, L2 bwd

    if "train_arxiv_shape" in phases:
        ctx, x, y, mask, prepare_s = workload("arxiv")
        check(ctx.num_real_edges == 2 * (ARXIV_EDGES // 2) and
              ctx.num_nodes == 169_472 and ctx.is_symmetric,
              "arxiv-shaped context has the wrong size")
        emit("prepare_arxiv_shape", host_seconds=prepare_s)
        path_launches["train_arxiv_shape"] = train_phase(
            "train_arxiv_shape", device, ctx, x, y, mask, arxiv_model, adam,
            torch.bfloat16, steps=12, per_step=spmm_only)

    if "train_directed" in phases:
        ctx, x, y, mask, _ = workload("directed")
        check(not ctx.is_symmetric, "directed context must not be symmetric")
        path_launches["train_directed"] = train_phase(
            "train_directed", device, ctx, x, y, mask, arxiv_model, adam,
            torch.bfloat16, steps=6, per_step=spmm_only, timed_iters=10)
    workloads.pop("directed", None)

    if "train_cora_shape" in phases:
        ctx, x, y, mask = workload("cora")

        def cora_model():
            gen = torch.Generator(device=device).manual_seed(0)
            return CoraGCN(x.shape[1], 16, 7, 0.5, gen, device)

        path_launches["train_cora_shape"] = train_phase(
            "train_cora_shape", device, ctx, x, y, mask, cora_model,
            lambda m: torch.optim.AdamW(m.parameters(), lr=0.01,
                                        weight_decay=5e-4),
            None, steps=40,
            # layer 1: weighted scatter forward, expand + sender-sorted
            # scatter backward; layer 2: spmm forward and backward.
            per_step={"scatter_sum_sorted": 1, "expand_sorted": 1,
                      "gather_scatter_sum_sorted": 3},
            falling=lambda l: sum(l[-5:]) < sum(l[:5]))

    if args.profile:
        from keras_geometric_tpu_torch.training import (
            make_node_classification_step,
        )

        ctx, x, y, mask, _ = workload("arxiv")
        model = arxiv_model()
        step = make_node_classification_step(
            model, adam(model), compute_dtype=torch.bfloat16)
        emit("profile_arxiv_shape",
             **profile_steps(lambda: step(x, None, y, mask, context=ctx)))

    if set(phases) != set(PHASES):
        print(json.dumps({"ok": False, "partial": phases}))
        return 0

    # Each entry carries its kernel's launches in the training run that gives
    # it the entry's shape, and that run must have launched it. Shapes no run
    # reaches are listed apart, with their times and no launches.
    on_path = [e for e in kernel_entries if e["path"]]
    check({e["name"] for e in on_path} == set(K.LAUNCH_COUNTS),
          "a kernel has no entry at a shape of the training runs")
    for entry in on_path:
        entry["launches"] = path_launches[entry["path"]][entry["name"]]
        check(entry["launches"] > 0, f"kernel {entry['name']} was never "
              f"launched by {entry['path']}")
    print(json.dumps({
        "kernels": on_path,
        "launches_by_path": path_launches,
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
