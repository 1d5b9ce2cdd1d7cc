"""The locality tier on Hopper: banded SpMM and the window scatter.

Counterpart of the JAX package's ``kernels/band_pallas.py``. The host half
(:class:`BandPlan` / :func:`build_band_plan`, :class:`WindowScatterPlan` /
:func:`build_window_scatter_plan`) is numpy and makes the same arrays as the
reference's, element for element. The kernels are CUDA C++ (``csrc/band.cu``,
built by ``_build.py`` at first use); this module holds their wrappers, their
plain PyTorch versions, their launch counters and the autograd wiring.

After a locality reordering (``ops/reorder.py``) most edges of a
community-structured graph join nodes less than half a window apart:

- ``band_window=W``: the edges that fit a ``W``-row window in both
  orientations are stored as a dense band ``[n_pad, W]``, and their SpMM is a
  product of dense tiles, ``y[b] = band[b] @ x[base(b) : base(b) + W]`` per
  row block ``b``. Its gradient is the same product over the transposed
  orientation's band (the band itself when the adjacency is symmetric).
- ``attend_window=W``: the sender side of the attention backward sums most
  per-edge cotangents into their senders' rows window by window, without the
  sender-sorted permutation.

Source notes, one per kernel:

- ``band_spmm`` replaces ``_band_matmul`` (``band_pallas.py:393``). Bound by
  bytes in bf16: the band is read once (``2W`` bytes per node row against
  ``2F`` for each of ``x`` and ``y``); in f32 by the FMA units' rate at
  ``F = 64`` and by the band's bytes at ``F = 16``. :func:`band_route` picks
  one of four instantiations from the type and the shapes alone, and a
  counter per route records it (``MODE_LAUNCH_COUNTS``). ``wgmma`` (bf16,
  ``F % 8 == 0``, row blocks of 256, ``W % 64 == 0``: the banded GCN's arxiv
  widths): a persistent CTA per SM takes whole row blocks, reading each
  ``x`` window once; a producer warp fills a ring of band and ``x`` tiles by
  TMA and two warpgroups multiply them with ``wgmma`` into f32 registers.
  ``wgmma_flat`` (bf16 at any other ``F``, the same row blocks and windows:
  the products widths 100 and 47): the same kernel, but a tensor map cannot
  read rows of ``2F`` bytes, so each stage's 64 ``x`` rows come in as one
  16-byte aligned run (``cp.async.bulk``; a column tile of a wider ``F``
  takes each row's part) and the consumers rewrite it into the swizzled
  tile that ``wgmma`` reads, ``N = F`` rounded up to 8; no column at or
  past ``F`` is stored. ``wmma`` (bf16 at other row blocks or windows): a
  block owns 64 rows of a row block and up to 128 columns and stages slabs
  of 32 window columns with thread-issued loads for ``nvcuda::wmma``.
  ``fma`` (f32, never TF32): blocks of 64 rows and 16, 32 or 64 columns
  (the least that holds ``F``), a ``cp.async`` ring of band and ``x`` slabs
  (32 window columns in 4 stages; 64 in 2 at 16 columns where ``W % 64 ==
  0``, since the band's bytes bound it there), each thread 8 x 8 outputs
  from 16-byte shared loads, two or four warps sharing a row range over the
  window's columns and adding their sums in a fixed order. Each rounds once
  at the store.
- ``window_scatter_sum`` replaces ``_win_scatter_kernel``
  (``band_pallas.py:249``), which contracts an equality one-hot on the TPU's
  matrix unit window by window: here the rows are summed directly. Bound by
  bytes: the eligible rows of ``v``, ``sender_tab`` and the output once. The
  plan lists the eligible slots in sender order (stable: ascending slot
  order within a row), a row pointer over the windows' rows and that list's
  work list of pieces of at most 32 slots (``spmm_cuda.recv_bwd_work``'s
  builder), and the kernel is the fused-gather piece walk that the sender
  finish takes (``csrc/gather_pieces.cuh``): each piece's slots staged, the
  next eight ``v`` rows in flight in a ``cp.async`` ring, 16-byte packs, f32
  sums in slot order, a row without a slot stored as zeros, a split row's
  shares added in piece order by a second launch. A listed slot adds only
  where ``sender_tab`` names its row. No atomics: the same bits on every
  launch, and a serial sum's bits on every row of at most 32 eligible slots.

A wrapper takes the plain version only for a tensor that lies on the CPU. For
a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from . import _build
from .spmm_cuda import (
    RECV_BWD_PIECE,
    RecvBwdWork,
    _build_recv_bwd_work,
    _check_data,
    _check_index,
    _raise_on_error,
)

__all__ = [
    "BandPlan",
    "build_band_plan",
    "band_spmm",
    "band_matmul",
    "band_matmul_plain",
    "WindowScatterPlan",
    "build_window_scatter_plan",
    "window_scatter_sum",
    "window_scatter_sum_plain",
    "band_route",
    "LAUNCH_COUNTS",
    "MODE_LAUNCH_COUNTS",
    "reset_launch_counts",
]

BAND_ROW_BLOCK = 256

# One plain integer per kernel entry, incremented where the kernel is
# launched and nowhere else.
LAUNCH_COUNTS = {"band_spmm": 0, "window_scatter_sum": 0}

# Launches of band_spmm by route (band_route), counted beside its own count.
MODE_LAUNCH_COUNTS = {
    "band_spmm(wgmma)": 0,
    "band_spmm(wgmma_flat)": 0,
    "band_spmm(wmma)": 0,
    "band_spmm(fma)": 0,
}


def reset_launch_counts() -> None:
    for counts in (LAUNCH_COUNTS, MODE_LAUNCH_COUNTS):
        for name in counts:
            counts[name] = 0


# ---------------------------------------------------------------------------
# Window scatter: plan and kernel.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WindowScatterPlan:
    """Host-built tables for :func:`window_scatter_sum`.

    ``work_win`` / ``work_chunk`` / ``work_flags`` are the reference's arrays
    (numpy): one item per (window, edge chunk) pair, window-major; bit 0 of a
    flag marks the first item of its window, bit 1 the last. The kernel reads
    the eligible slots in sender order instead: ``scatter_idx`` (the slots,
    ascending within a row), ``scatter_row_ptr`` (row ``r``'s slots are
    ``scatter_idx[scatter_row_ptr[r] : scatter_row_ptr[r + 1]]``, for every
    row of every window) and ``scatter_work``, that list's pieces.
    """

    work_win: np.ndarray  # [Wk] int32: window index of item
    work_chunk: np.ndarray  # [Wk] int32: edge chunk of item
    work_flags: np.ndarray  # [Wk] int32
    window: int
    num_windows: int
    edge_chunk: int
    num_band_edges: int  # absorbed edge count
    scatter_idx: torch.Tensor  # [num_band_edges] int32 slots of v
    scatter_row_ptr: torch.Tensor  # [num_windows * window + 1] int32
    scatter_work: RecvBwdWork  # pieces of scatter_row_ptr

    @property
    def num_work(self) -> int:
        return int(self.work_win.shape[0])


def build_window_scatter_plan(
    senders: np.ndarray,
    num_nodes: int,
    eligible: np.ndarray,
    *,
    window: int = 1024,
    edge_chunk: int = 1024,
) -> tuple[WindowScatterPlan, np.ndarray, np.ndarray]:
    """Choose each edge chunk's best W-aligned window and split edges.

    ``senders`` is the [E_pad] receiver-sorted sender array (padding slots
    marked False in ``eligible``). Returns ``(plan, band_mask, sender_tab)``:
    ``band_mask[e]`` marks edges whose sender falls in their chunk's chosen
    window; ``sender_tab[e]`` is the sender id for those edges and -1
    otherwise. ``num_nodes`` must be a multiple of ``window``.
    """
    senders = np.asarray(senders, np.int64)
    eligible = np.asarray(eligible, bool)
    e_pad = senders.shape[0]
    if e_pad % edge_chunk:
        raise ValueError("senders must be padded to the edge_chunk grain")
    if num_nodes % window:
        raise ValueError(
            f"num_nodes={num_nodes} must be a multiple of window={window}"
        )
    num_windows = num_nodes // window
    nchunks = e_pad // edge_chunk
    swin = senders // window  # [E_pad]
    chunk_id = np.arange(e_pad) // edge_chunk
    # Votes per (chunk, window) -> per-chunk argmax window.
    key = chunk_id[eligible] * num_windows + swin[eligible]
    votes = np.bincount(key, minlength=nchunks * num_windows)
    votes = votes.reshape(nchunks, num_windows)
    chosen = votes.argmax(axis=1)  # [nchunks]
    band_mask = eligible & (swin == chosen[chunk_id])
    sender_tab = np.where(band_mask, senders, -1).astype(np.int32)
    # One item per (chosen window, chunk) pair that has any band edge,
    # window-major; a window with no item gets one visit (to chunk 0, whose
    # band senders lie elsewhere) so that its rows are written as zeros.
    has = np.bincount(chunk_id[band_mask], minlength=nchunks) > 0
    wins = chosen[has]
    chunks = np.nonzero(has)[0]
    order = np.lexsort((chunks, wins))
    wins, chunks = wins[order], chunks[order]
    missing = np.setdiff1d(np.arange(num_windows), wins)
    if missing.size:
        wins = np.concatenate([wins, missing])
        chunks = np.concatenate([chunks, np.zeros_like(missing)])
        order = np.lexsort((chunks, wins))
        wins, chunks = wins[order], chunks[order]
    first = np.ones(wins.shape[0], np.int32)
    first[1:] = (wins[1:] != wins[:-1]).astype(np.int32)
    last = np.ones(wins.shape[0], np.int32)
    last[:-1] = (wins[1:] != wins[:-1]).astype(np.int32)
    work_win = wins.astype(np.int32)
    work_chunk = chunks.astype(np.int32)
    idx, row_ptr = _sender_order(sender_tab, num_windows * window)
    row_ptr = torch.from_numpy(row_ptr)
    plan = WindowScatterPlan(
        work_win=work_win,
        work_chunk=work_chunk,
        work_flags=(first | (2 * last)).astype(np.int32),
        window=window,
        num_windows=num_windows,
        edge_chunk=edge_chunk,
        num_band_edges=int(band_mask.sum()),
        scatter_idx=torch.from_numpy(idx),
        scatter_row_ptr=row_ptr,
        scatter_work=_build_recv_bwd_work(row_ptr, RECV_BWD_PIECE),
    )
    return plan, band_mask, sender_tab


def _sender_order(sender_tab: np.ndarray, num_rows: int):
    """The slots with ``sender_tab >= 0``, stable-sorted by their entry
    (ascending slot order within a row), and the ``[num_rows + 1]`` row
    pointer over them: the kernel's list, built from ``sender_tab`` alone."""
    slots = np.nonzero(sender_tab >= 0)[0]
    rows = sender_tab[slots]
    order = np.argsort(rows, kind="stable")
    row_ptr = np.searchsorted(rows[order], np.arange(num_rows + 1),
                              side="left")
    return slots[order].astype(np.int32), row_ptr.astype(np.int32)


def window_scatter_sum_plain(messages, sender_tab, plan):
    sel = sender_tab >= 0
    out = torch.zeros(plan.num_windows * plan.window, messages.shape[1],
                      dtype=torch.float32, device=messages.device)
    out.index_add_(0, sender_tab[sel].long(), messages[sel].float())
    return out.to(messages.dtype)


def window_scatter_sum(
    messages: torch.Tensor,
    sender_tab: torch.Tensor,
    plan: WindowScatterPlan,
) -> torch.Tensor:
    """Sum receiver-sorted ``[E, F]`` messages into their senders' rows for
    the window-eligible slots (``sender_tab[e] >= 0``); other slots
    contribute nothing. Returns ``[num_windows * window, F]`` in the
    messages' type, summed in f32 and rounded once. Not differentiable by
    itself (the attention backward calls it)."""
    if messages.ndim != 2:
        raise ValueError(
            f"messages must be [E, F], got {tuple(messages.shape)}")
    if not messages.is_cuda:
        return window_scatter_sum_plain(messages, sender_tab, plan)
    device = messages.device
    _check_data("messages", messages)
    e, f = messages.shape
    if e >= 2**31:
        raise ValueError("slot count must stay below 2**31 (int32 indices)")
    _check_index("sender_tab", sender_tab, e, device)
    rows = plan.num_windows * plan.window
    _check_index("scatter_idx", plan.scatter_idx, plan.num_band_edges, device)
    _check_index("scatter_row_ptr", plan.scatter_row_ptr, rows + 1, device)
    work = plan.scatter_work
    if work.pieces.device != device:
        raise ValueError(f"the plan's pieces lie on {work.pieces.device}, "
                         f"data on {device}")
    out = torch.empty(rows, f, dtype=messages.dtype, device=device)
    if out.numel() == 0:
        return out
    part = None
    if work.num_shares:
        part = torch.empty(work.num_shares, f, dtype=torch.float32,
                           device=device)
    lib = _library()
    with torch.cuda.device(device):
        code = lib.kgt_window_scatter_sum(
            messages.data_ptr(), sender_tab.data_ptr(),
            plan.scatter_idx.data_ptr(), work.pieces.data_ptr(),
            work.num_pieces, work.piece,
            None if part is None else part.data_ptr(),
            work.fix_rows.data_ptr(), work.fix_ptr.data_ptr(),
            int(work.fix_rows.shape[0]), out.data_ptr(), rows, f,
            int(messages.dtype == torch.bfloat16),
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on_error(lib, code, "window_scatter_sum")
    LAUNCH_COUNTS["window_scatter_sum"] += 1
    return out


# ---------------------------------------------------------------------------
# Banded SpMM: plan and kernel.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BandPlan:
    """Banded adjacency for one orientation."""

    band: torch.Tensor  # [n_pad, W] weights (0 = no edge)
    base_idx: torch.Tensor  # [NB] int32: window start in W/2-row units
    window: int
    row_block: int
    num_edges: int  # real edges represented in the band

    @property
    def n_pad(self) -> int:
        return int(self.band.shape[0])


def _block_base_rows(n_pad: int, window: int, row_block: int) -> np.ndarray:
    """Window start row per row block: centered, clamped, W/2-aligned. The
    clamp keeps every window inside ``[0, n_pad)``."""
    w2 = window // 2
    nb = n_pad // row_block
    centers = np.arange(nb, dtype=np.int64) * row_block + row_block // 2
    k = np.clip(
        np.round((centers - window // 2) / w2).astype(np.int64),
        0,
        max(n_pad // w2 - 2, 0),
    )
    return k


def build_band_plan(
    senders: np.ndarray,
    receivers: np.ndarray,
    weights: np.ndarray | None,
    num_nodes: int,
    *,
    window: int = 1024,
    row_block: int = BAND_ROW_BLOCK,
    exclude: np.ndarray | None = None,
) -> tuple[BandPlan, np.ndarray]:
    """Split edges into (band, residual) and build the dense band.

    Returns ``(plan, local_mask)`` where ``local_mask[e]`` marks edges
    absorbed into the band. An edge is banded only if it fits the window in
    both orientations, so the band's transpose is a band over the same node
    padding: ``plan`` serves as its own backward for symmetric adjacencies,
    and the caller builds one extra plan (same mask) from the swapped edge
    list otherwise. ``num_nodes`` must be a multiple of
    ``max(row_block, window/2)`` and at least ``window``. The band is f32 on
    the host; ``GraphContext.to`` / ``with_weight_dtype`` move and cast it.
    """
    w2 = window // 2
    if window % 256:
        raise ValueError(f"window must be a multiple of 256, got {window}")
    grain = max(row_block, w2)
    if num_nodes % grain or num_nodes < window:
        raise ValueError(
            f"num_nodes={num_nodes} must be a multiple of {grain} and "
            f">= window={window} (use prepare_graph(pad_nodes=True))"
        )
    s = np.asarray(senders, dtype=np.int64)
    r = np.asarray(receivers, dtype=np.int64)
    k = _block_base_rows(num_nodes, window, row_block)
    base_row = k * w2  # [NB]
    off_s = s - base_row[r // row_block]  # col of edge in r's band
    off_r = r - base_row[s // row_block]
    local = (
        (off_s >= 0) & (off_s < window) & (off_r >= 0) & (off_r < window)
    )
    if exclude is not None:
        local &= ~np.asarray(exclude, bool)
    band = np.zeros((num_nodes, window), np.float32)
    w = (
        np.ones(s.shape[0], np.float32)
        if weights is None
        else np.asarray(weights, np.float32)
    )
    np.add.at(band, (r[local], off_s[local]), w[local])
    plan = BandPlan(
        band=torch.from_numpy(band),
        base_idx=torch.from_numpy(k.astype(np.int32)),
        window=window,
        row_block=row_block,
        num_edges=int(local.sum()),
    )
    return plan, local


def band_matmul_plain(x, band, base_idx, window, row_block):
    """Gathered windows and one batched product, in f32, rounded once."""
    n_pad, f = x.shape
    nb = n_pad // row_block
    rows = (base_idx.long() * (window // 2))[:, None] + torch.arange(
        window, device=x.device)
    windows = x.float().index_select(0, rows.reshape(-1)).view(nb, window, f)
    y = torch.bmm(band.float().view(nb, row_block, window), windows)
    return y.reshape(n_pad, f).to(x.dtype)


# The route's code in the C entry point: the TMA + wgmma kernel with x by
# its tensor map is 1, with x by 1-D copies 2, the thread-staged ones (wmma,
# FMA) 0.
_ROUTE_CODE = {"wgmma": 1, "wgmma_flat": 2, "wmma": 0, "fma": 0}


def band_route(f: int, window: int, row_block: int, dtype) -> str:
    """The instantiation of the band kernel for these shapes. bf16 at row
    blocks of 256 (a CTA's tile) and ``window % 64 == 0`` (its ring stage)
    takes the TMA ring and Hopper's warpgroup products: ``"wgmma"`` where
    ``f % 8 == 0`` (``x`` by a tensor map, whose rows start on 16-byte
    boundaries), ``"wgmma_flat"`` at any other ``f`` (``x`` by 1-D copies,
    rewritten in shared memory); ``"wmma"`` for any other bf16 shape;
    ``"fma"`` for f32."""
    if dtype == torch.float32:
        return "fma"
    if dtype != torch.bfloat16:
        raise TypeError(f"the band kernel takes f32 or bf16, got {dtype}")
    if row_block == 256 and window % 64 == 0:
        return "wgmma" if f % 8 == 0 else "wgmma_flat"
    return "wmma"


def band_matmul(x, band, base_idx, window, row_block):
    """``y[b*RB : (b+1)*RB] = band[b*RB : (b+1)*RB] @ x[base(b) : base(b)+W]``
    with ``base(b) = base_idx[b] * W/2``: ``x`` ``[n_pad, F]`` and ``band``
    ``[n_pad, W]`` of one type (f32 or bf16), summed in f32 and rounded once.
    Not differentiable by itself: :func:`band_spmm` is."""
    if not x.is_cuda:
        return band_matmul_plain(x, band, base_idx, window, row_block)
    return _band_matmul_on(
        band_route(x.shape[1], window, row_block, x.dtype), x, band,
        base_idx, window, row_block)


def _band_matmul_on(route, x, band, base_idx, window, row_block, out=None):
    """One launch of the band kernel on ``route`` (a CUDA tensor) into
    ``out`` (a contiguous ``[n_pad, F]`` tensor like ``x``; a new one by
    default). The C entry point refuses a route that does not take these
    shapes."""
    device = x.device
    _check_data("x", x)
    _check_data("band", band)
    n_pad, f = x.shape
    if band.dtype != x.dtype:
        raise TypeError(f"band is {band.dtype}, x {x.dtype}: they must match")
    if tuple(band.shape) != (n_pad, window):
        raise ValueError(
            f"band must be [{n_pad}, {window}], got {tuple(band.shape)}")
    if window % 32 or row_block % 64 or n_pad % row_block:
        raise ValueError(
            "the band kernel needs window % 32 == 0, row_block % 64 == 0 and "
            f"n_pad % row_block == 0 (window={window}, row_block={row_block}, "
            f"n_pad={n_pad})")
    if band.data_ptr() % 16:
        raise ValueError("band must be 16-byte aligned")
    _check_index("base_idx", base_idx, n_pad // row_block, device)
    if x.data_ptr() % 16:  # TMA reads from 16-byte aligned rows
        x = x.clone()
    if out is None:
        out = torch.empty(n_pad, f, dtype=x.dtype, device=device)
    elif (out.shape != x.shape or out.dtype != x.dtype or
          out.device != device or not out.is_contiguous()):
        raise ValueError("out must be a contiguous tensor like x")
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(device):
        code = lib.kgt_band_matmul(
            x.data_ptr(), band.data_ptr(), base_idx.data_ptr(),
            out.data_ptr(), n_pad, f, window, row_block,
            int(x.dtype == torch.bfloat16), _ROUTE_CODE[route],
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on_error(lib, code, "band_spmm")
    LAUNCH_COUNTS["band_spmm"] += 1
    MODE_LAUNCH_COUNTS[f"band_spmm({route})"] += 1
    return out


class _BandSpmm(torch.autograd.Function):
    """``B @ x``; backward ``B^T @ g``: the same kernel over the transposed
    orientation's plan (``plan`` itself when ``plan_t`` is None, the
    symmetric case). Re-entering keeps higher-order gradients valid."""

    @staticmethod
    def forward(ctx, x, plan, plan_t):
        ctx.plans = (plan, plan_t)
        band = plan.band
        if band.dtype != x.dtype:  # a context not cast to the data's type
            band = band.to(x.dtype)
        return band_matmul(x.contiguous(), band, plan.base_idx, plan.window,
                           plan.row_block)

    @staticmethod
    def backward(ctx, g):
        plan, plan_t = ctx.plans
        if plan_t is None:
            return _BandSpmm.apply(g, plan, None), None, None
        return _BandSpmm.apply(g, plan_t, plan), None, None


def band_spmm(
    x: torch.Tensor,
    plan: BandPlan,
    plan_bwd: BandPlan | None = None,
) -> torch.Tensor:
    """``y = B @ x`` over the banded edges (differentiable in ``x``).

    ``plan_bwd`` is the transpose orientation's plan; omit it for symmetric
    adjacencies (the band is then its own transpose).
    """
    if x.ndim != 2 or x.shape[0] != plan.n_pad:
        raise ValueError(
            f"x must be [{plan.n_pad}, F] (the band's n_pad), got "
            f"{tuple(x.shape)}")
    return _BandSpmm.apply(x, plan, plan_bwd)


# ---------------------------------------------------------------------------
# Kernel library.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _build.load_library("band")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.kgt_band_matmul.argtypes = [
        vp, vp, vp, vp, i64, i64, i32, i32, i32, i32, vp,
    ]
    lib.kgt_band_matmul.restype = i32
    lib.kgt_window_scatter_sum.argtypes = [
        vp, vp, vp, vp, i64, i32, vp, vp, vp, i64, vp, i64, i64, i32, vp,
    ]
    lib.kgt_window_scatter_sum.restype = i32
    lib.kgt_cuda_error_string.argtypes = [i32]
    lib.kgt_cuda_error_string.restype = ctypes.c_char_p
    return lib
