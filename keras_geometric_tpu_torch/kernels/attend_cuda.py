"""Fused GATv2 attention on Hopper: the one-pass forward, the aggregation from
cached scores, rho, and the receiver and sender backwards.

Counterpart of the JAX package's ``sddmm_stats_agg_sorted``
(``kernels/sddmm_pallas.py``), ``attend_aggregate_sorted``,
``attend_rho_sorted``, ``attend_recv_bwd_full_sorted`` and
``attend_send_bwd_sorted`` (``kernels/attend_pallas.py``), in all their
modes: with or without the score cache (``emit_scores`` / ``scores=None``),
with or without the per-edge sender cotangent (``emit_v``). The kernels are
CUDA C++ (``csrc/attend.cu``, built by ``_build.py`` at first use); this
module holds their wrappers, their plain PyTorch versions, their launch
counters and their argument checks. ``ops/csr.py`` wires them into
``GraphContext.attend``; the two-pass forward's first half,
``sddmm_stats_sorted``, is in ``sddmm_cuda.py``.

One thing differs from the reference's signatures: the kernels gather the
rows they need themselves. The forward, aggregation, rho and receiver
backward take ``ht`` and ``senders`` where the reference takes the
materialised ``hj = ht[senders]``; the sender backward takes ``ht``, ``g``,
``m``, ``l``, ``rho`` and ``receivers_ss`` where the reference takes the
gathered ``g_r``, ``ht_r`` and ``stats_r`` streams. No ``[E, H*F]`` gather
reaches device memory.

Source notes, one per kernel (all five are bound by bytes):

- ``sddmm_stats_agg_sorted``: scores, online softmax statistics and the
  attention-weighted aggregation in one pass. Moves the node array and the
  output once, the sender, validity and keep-mask streams, and (with the
  cache) the ``[E, H]`` f32 scores. A sub-warp group per (piece, head) keeps
  the running max, normaliser and output columns in registers; a lane moves
  up to 16 bytes of neighbouring columns at a time, so that at F = 64 in
  bf16 one warp serves four heads. A row split into pieces gets its ``m``,
  ``l`` and output from its pieces' f32 ``(m_p, l_p, o_p)``, merged in piece
  order by a second launch (the flash-decoding combine).
- ``attend_aggregate_sorted``: ``out[r] = sum_e alpha*keep*ht[senders e]``
  from cached scores, ``m`` and ``l``; reads the node rows, the score stream,
  writes the output. A group per (piece, head) of rho's work list, the
  piece's scores staged as its flags (a slot whose score is ``-inf`` is never
  gathered); a split row's output is its pieces' f32 shares added in piece
  order by a second launch.
- ``attend_rho_sorted``: ``rho[r, h] = sum_e alpha*keep*<g[r, h], ht[j, h]>``
  from the cached scores, or from scores recomputed in registers; reads two
  node arrays and the score stream, writes ``[N, H]``. A split row's ``rho``
  is its pieces' f32 shares added in piece order by a second launch.
- ``attend_recv_bwd_full_sorted``: recomputes ``pre``, ``alpha``, ``dalpha``
  (and, without the cache, the score); writes the receiver part of ``d ht``,
  ``datt`` and, for the permute finish, the per-edge sender cotangent ``v``
  (``[E, H*F]``, the largest stream of these kernels), 0 on a padded slot.
  A split row's ``d ht`` is its pieces' f32 shares, added in piece order by
  the second launch, which also sums the ``datt`` partials in a fixed order.
- ``attend_send_bwd_sorted``: the sender part of ``d ht`` without ``v``: a
  group per (piece of a sender row, head) walks the sender-sorted slots,
  gathers the receiver's ``ht`` and ``g`` rows and its ``(m, l, rho)``,
  recomputes the score, ``alpha``, ``ds`` and ``d_pre`` and sums
  ``alpha*keep*g[r] + d_pre`` in f32, rounded once. Padded slots are never
  gathered.

The forward, the aggregation, rho and the receiver backward walk pieces of
at most ``RECV_BWD_PIECE`` slots (:func:`recv_bwd_work`, built once per
``row_ptr`` tensor and kept beside it, at a context's first forward), so no
group walks a long row, the padded tail or a hub, serially; the sender
backward walks
the pieces of the sender-sorted stream (``row_ptr_bwd``'s list, built at a
context's first backward, which the permute finish walks too). Each group
copies its piece's senders (the sender backward: receivers, and their ``m``,
``l`` and ``rho``), scores (or validity) and keep factors into shared memory
in one go, keeps the gathered rows of the next slots in flight in a
shared-memory ring filled by ``cp.async`` (the sender backward: each slot's
receiver's ``ht`` and ``g`` rows), and never gathers a padded slot. Each of
the five calls is two kernel launches (the piece walk, then the fixed-order
combination of the split rows; the receiver backward's second launch also
sums ``datt``) and counts one launch. No atomics: every result is
bit-reproducible, and a row whose finite scores lie in one piece (every row
of at most 32 slots, and the padded tail row whose real slots come first)
gets what a walk of the whole row gives, bit for bit.

Every score these kernels compute or recompute comes from one device function
with one lane layout, so a recomputed score is the forward's bit for bit; the
wrappers hand the kernels 16-byte aligned data (``_aligned``) so that the
layout depends on F and the type alone. Any F per head works: a head wider
than 256 columns runs an instantiation of its own that walks the head in
256-column slabs (``csrc/lanes.cuh``), with its own score function, shared
by every wide kernel in the same way.

A wrapper takes the plain version only for a tensor that lies on the CPU. For
a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .spmm_cuda import (
    _DATA_DTYPES,
    RECV_BWD_PIECE,
    RecvBwdWork,
    _check_data,
    _check_index,
    _mask_arg,
    _raise_on_error,
    recv_bwd_work,
)

__all__ = [
    "sddmm_stats_agg_sorted",
    "attend_aggregate_sorted",
    "attend_rho_sorted",
    "attend_recv_bwd_full_sorted",
    "attend_send_bwd_sorted",
    "sddmm_stats_agg_sorted_plain",
    "attend_aggregate_sorted_plain",
    "attend_rho_sorted_plain",
    "attend_recv_bwd_full_sorted_plain",
    "attend_send_bwd_sorted_plain",
    "RECV_BWD_PIECE",
    "RecvBwdWork",
    "recv_bwd_work",
    "LAUNCH_COUNTS",
    "reset_launch_counts",
]

# One plain integer per kernel entry, incremented where the kernel is
# launched and nowhere else.
LAUNCH_COUNTS = {
    "sddmm_stats_agg_sorted": 0,
    "attend_aggregate_sorted": 0,
    "attend_rho_sorted": 0,
    "attend_recv_bwd_full_sorted": 0,
    "attend_send_bwd_sorted": 0,
}

# Launches of the kernels above in their other modes, counted beside (not
# instead of) the kernel's own count: without the score cache, and without
# the per-edge sender cotangent ``v``.
MODE_LAUNCH_COUNTS = {
    "sddmm_stats_agg_sorted(emit_scores=False)": 0,
    "attend_rho_sorted(scores=None)": 0,
    "attend_recv_bwd_full_sorted(scores=None)": 0,
    "attend_recv_bwd_full_sorted(emit_v=False)": 0,
}

def reset_launch_counts() -> None:
    for counts in (LAUNCH_COUNTS, MODE_LAUNCH_COUNTS):
        for name in counts:
            counts[name] = 0


# ---------------------------------------------------------------------------
# Plain PyTorch versions: the same functions of the same arguments with
# library ops, f32 inside, rounded once. Used for CPU tensors and as the
# yardstick the kernels are held against on the card. Row pointers are what
# the kernels walk; the plain versions use the index vectors.
# ---------------------------------------------------------------------------


def _edge_views(ht, senders, receivers, heads):
    e = senders.shape[0]
    f = ht.shape[1] // heads
    rows = ht.float()
    hj = rows.index_select(0, senders.long()).view(e, heads, f)
    hi = rows.index_select(0, receivers.long()).view(e, heads, f)
    return hi, hj


def _scores(hi, hj, att, negative_slope, edge_valid):
    """GATv2 scores ``[E, H]`` f32, ``-inf`` on invalid slots."""
    pre = hi + hj
    z = torch.where(pre > 0, pre, negative_slope * pre)
    scores = (z * att.float()[None]).sum(-1)
    if edge_valid is not None:
        scores = scores.masked_fill(~edge_valid[:, None], float("-inf"))
    return scores


def _alpha(scores, m, l, receivers, eps):
    recv = receivers.long()
    return torch.exp(scores - m.index_select(0, recv)) / (
        l.index_select(0, recv) + eps)


def _alpha_of(scores, m, l, hi, hj, receivers, att, negative_slope,
              edge_valid, eps):
    """alpha from cached scores, or (``scores is None``) from scores
    recomputed as the forward computed them, with the reference's clamp
    ``exp(min(s - m, 0))`` (exact for the forward's own scores)."""
    if scores is not None:
        return _alpha(scores, m, l, receivers, eps)
    if att is None:
        raise ValueError("scores=None needs att= to recompute the scores")
    s = _scores(hi, hj, att, negative_slope, edge_valid)
    recv = receivers.long()
    return torch.exp(torch.clamp(s - m.index_select(0, recv), max=0.0)) / (
        l.index_select(0, recv) + eps)


def scores_and_stats_plain(ht, senders, receivers, att, negative_slope,
                           edge_valid):
    """``(hj, scores, m, l, exp(scores - m[r]))`` of the forward: the sender
    rows ``[E, H, F]`` f32, the scores ``[E, H]`` (``-inf`` on invalid
    slots), the per-row max (0 for a row without a finite score) and
    normaliser ``[N, H]``. Shared by the plain forwards here and in
    ``sddmm_cuda``."""
    n = ht.shape[0]
    heads = att.shape[0]
    e = senders.shape[0]
    recv = receivers.long()
    hi, hj = _edge_views(ht, senders, receivers, heads)
    scores = _scores(hi, hj, att, negative_slope, edge_valid)
    m = torch.full((n, heads), float("-inf"), device=ht.device)
    m = m.scatter_reduce(0, recv[:, None].expand(e, heads), scores, "amax")
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    ex = torch.exp(scores - m.index_select(0, recv))
    l = torch.zeros(n, heads, device=ht.device).index_add_(0, recv, ex)
    return hj, scores, m, l, ex


def sddmm_stats_agg_sorted_plain(ht, senders, receivers, row_ptr, att, *,
                                 edge_valid=None, drop_mask=None,
                                 negative_slope=0.2, eps=1e-10,
                                 emit_scores=True):
    del row_ptr
    n, d = ht.shape
    e = senders.shape[0]
    recv = receivers.long()
    hj, scores, m, l, ex = scores_and_stats_plain(
        ht, senders, receivers, att, negative_slope, edge_valid)
    if drop_mask is not None:  # dropout scales the numerator only
        ex = ex * drop_mask.float()
    o = torch.zeros(n, d, device=ht.device).index_add_(
        0, recv, (ex[:, :, None] * hj).reshape(e, d))
    out = (o.view(n, m.shape[1], -1) / (l[:, :, None] + eps)).reshape(n, d)
    if not emit_scores:
        return out.to(ht.dtype), m, l
    return out.to(ht.dtype), scores, m, l


def attend_aggregate_sorted_plain(scores, m, l, ht, senders, receivers,
                                  row_ptr, *, eps=1e-10, drop_mask=None):
    del row_ptr
    n, d = ht.shape
    heads = m.shape[1]
    e = senders.shape[0]
    _, hj = _edge_views(ht, senders, receivers, heads)
    alpha = _alpha(scores, m, l, receivers, eps)
    if drop_mask is not None:
        alpha = alpha * drop_mask.float()
    out = torch.zeros(n, d, device=ht.device).index_add_(
        0, receivers.long(), (alpha[:, :, None] * hj).reshape(e, d))
    return out.to(ht.dtype)


def attend_rho_sorted_plain(g, scores, m, l, ht, senders, receivers, row_ptr,
                            *, eps=1e-10, drop_mask=None, att=None,
                            negative_slope=0.2, edge_valid=None):
    del row_ptr
    n, heads = m.shape
    recv = receivers.long()
    hi, hj = _edge_views(ht, senders, receivers, heads)
    g_e = g.float().index_select(0, recv).view(hj.shape)
    alpha = _alpha_of(scores, m, l, hi, hj, receivers, att, negative_slope,
                      edge_valid, eps)
    prod = alpha * (g_e * hj).sum(-1)
    if drop_mask is not None:
        prod = prod * drop_mask.float()
    return torch.zeros(n, heads, device=ht.device).index_add_(0, recv, prod)


def attend_recv_bwd_full_sorted_plain(ht, g, senders, receivers, row_ptr, att,
                                      scores, m, l, rho, *, eps=1e-10,
                                      negative_slope=0.2, drop_mask=None,
                                      emit_v=True, edge_valid=None):
    del row_ptr
    n, d = ht.shape
    heads = att.shape[0]
    e = senders.shape[0]
    recv = receivers.long()
    hi, hj = _edge_views(ht, senders, receivers, heads)
    g_e = g.float().index_select(0, recv).view(hj.shape)
    alpha = _alpha_of(scores, m, l, hi, hj, receivers, att, negative_slope,
                      edge_valid, eps)
    dalpha = (g_e * hj).sum(-1)
    alpha_keep = alpha
    if drop_mask is not None:
        dalpha = dalpha * drop_mask.float()
        alpha_keep = alpha * drop_mask.float()
    ds = alpha * (dalpha - rho.index_select(0, recv))
    pre = hi + hj
    pos = pre > 0
    slope = torch.where(pos, 1.0, negative_slope)
    d_pre = ds[:, :, None] * att.float()[None] * slope
    dht = torch.zeros(n, d, device=ht.device).index_add_(
        0, recv, d_pre.reshape(e, d))
    z = torch.where(pos, pre, negative_slope * pre)
    datt = (z * ds[:, :, None]).sum(0)
    if not emit_v:
        return dht.to(ht.dtype), datt.to(att.dtype)
    v = alpha_keep[:, :, None] * g_e + d_pre
    return dht.to(ht.dtype), datt.to(att.dtype), v.reshape(e, d).to(ht.dtype)


def attend_send_bwd_sorted_plain(ht, g, receivers_ss, senders_sorted,
                                 row_ptr_bwd, att, m, l, rho, *, eps=1e-10,
                                 negative_slope=0.2, valid_ss=None,
                                 drop_ss=None):
    del row_ptr_bwd
    n, d = ht.shape
    heads = att.shape[0]
    e = receivers_ss.shape[0]
    r = receivers_ss.long()
    # In sender order the receiver plays hi, the sender hj, as in the forward.
    hr, hs = _edge_views(ht, senders_sorted, receivers_ss, heads)
    g_r = g.float().index_select(0, r).view(hr.shape)
    alpha = _alpha_of(None, m, l, hr, hs, receivers_ss, att, negative_slope,
                      None, eps)
    if valid_ss is not None:
        alpha = alpha * valid_ss.float()[:, None]
    dalpha = (g_r * hs).sum(-1)
    alpha_keep = alpha
    if drop_ss is not None:
        dalpha = dalpha * drop_ss.float()
        alpha_keep = alpha * drop_ss.float()
    ds = alpha * (dalpha - rho.index_select(0, r))
    pre = hr + hs
    d_pre = (ds[:, :, None] * att.float()[None]
             * torch.where(pre > 0, 1.0, negative_slope))
    v = alpha_keep[:, :, None] * g_r + d_pre
    out = torch.zeros(n, d, device=ht.device).index_add_(
        0, senders_sorted.long(), v.reshape(e, d))
    return out.to(ht.dtype)


# ---------------------------------------------------------------------------
# Kernel launches.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _build.load_library("attend")
    vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                         ctypes.c_float)
    lib.kgt_sddmm_stats_agg_sorted.argtypes = [
        vp, vp, vp, i64, i32, vp, i32, vp, vp, i32, vp, vp, vp, vp, vp, vp,
        vp, vp, vp, i64, i64, i32, i64, f32, f32, i32, vp,
    ]
    lib.kgt_sddmm_stats_agg_sorted.restype = i32
    lib.kgt_attend_aggregate_sorted.argtypes = [
        vp, vp, vp, vp, vp, vp, i64, i32, vp, i32, vp, vp, vp, vp, i64, i64,
        i32, i64, f32, i32, vp,
    ]
    lib.kgt_attend_aggregate_sorted.restype = i32
    lib.kgt_attend_rho_sorted.argtypes = [
        vp, vp, vp, vp, i64, i32, vp, vp, vp, vp, i32, vp, vp, i32, vp, vp,
        vp, vp, i64, i64, i32, i64, f32, f32, i32, vp,
    ]
    lib.kgt_attend_rho_sorted.restype = i32
    lib.kgt_attend_recv_bwd_partial_rows.argtypes = [
        vp, vp, vp, vp, i64, i32, i64, i32,
    ]
    lib.kgt_attend_recv_bwd_partial_rows.restype = i64
    lib.kgt_attend_recv_bwd_full_sorted.argtypes = [
        vp, vp, vp, vp, i64, i32, vp, i32, vp, vp, vp, vp, vp, vp, i32, vp,
        vp, vp, vp, i64, vp, vp, vp, i64, i32, i64, f32, f32, i32, vp,
    ]
    lib.kgt_attend_recv_bwd_full_sorted.restype = i32
    lib.kgt_attend_send_bwd_sorted.argtypes = [
        vp, vp, vp, vp, i64, i32, vp, i32, vp, vp, vp, vp, vp, i32, vp, vp,
        vp, vp, i64, i64, i32, i64, f32, f32, i32, vp,
    ]
    lib.kgt_attend_send_bwd_sorted.restype = i32
    lib.kgt_cuda_error_string.argtypes = [i32]
    lib.kgt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_like(name, t, shape, dtype, device):
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, data on {device}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous {list(shape)} tensor, got "
            f"{tuple(t.shape)}"
        )


def _scalar_matrix_arg(name, t, shape, device):
    """(pointer, is_bf16) of ``att`` or of an optional keep mask."""
    if t is None:
        return None, 0
    if t.dtype not in _DATA_DTYPES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    _check_like(name, t, shape, t.dtype, device)
    return t.data_ptr(), int(t.dtype == torch.bfloat16)


def _aligned(t):
    """``t`` when its data start on a 16-byte boundary, else an aligned copy.
    The kernels lay a head's columns over their lanes by F, the type and the
    data's alignment; with every array aligned the layout is the same in each
    kernel, and so is each score's order of summation."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _head_width(d, heads):
    if heads < 1 or d % heads:
        raise ValueError(f"{heads} heads do not divide the width {d}")
    return d // heads


def _check_graph(ht, senders, row_ptr, att):
    """Shared checks; returns ``(n, heads, f, num_slots)``."""
    _check_data("ht", ht)
    n, d = ht.shape
    if att.ndim != 2 or att.shape[0] * att.shape[1] != d:
        raise ValueError(
            f"att must be [H, F] with H*F = {d}, got {tuple(att.shape)}")
    heads, f = att.shape
    _head_width(d, heads)
    e = senders.shape[0]
    if e >= 2**31:
        raise ValueError("edge count must stay below 2**31 (int32 indices)")
    _check_index("senders", senders, e, ht.device)
    _check_index("row_ptr", row_ptr, n + 1, ht.device)
    return n, heads, f, e


def _check_stats(e, n, heads, device, scores, **named):
    """``scores`` ``[E, H]`` (or None) and each named ``[N, H]``, all f32."""
    if scores is not None:
        _check_like("scores", scores, (e, heads), torch.float32, device)
    for name, t in named.items():
        _check_like(name, t, (n, heads), torch.float32, device)


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _work_args(work):
    """(pieces, num_pieces, piece) of a work list, as the kernels take them."""
    return work.pieces.data_ptr(), work.num_pieces, work.piece


def _fix_args(work):
    """(fix_rows, fix_ptr, number of split rows) of a work list."""
    return (work.fix_rows.data_ptr(), work.fix_ptr.data_ptr(),
            int(work.fix_rows.shape[0]))


def _shares(work, width, device):
    """f32 scratch of ``width`` values per share of a split row (flat), or
    None where no row is split."""
    if not work.num_shares:
        return None
    return torch.empty(work.num_shares * width, dtype=torch.float32,
                       device=device)


def sddmm_stats_agg_sorted(ht, senders, receivers, row_ptr, att, *,
                           edge_valid=None, drop_mask=None,
                           negative_slope=0.2, eps=1e-10, emit_scores=True):
    """Fused GATv2 forward over a receiver-sorted stream.

    ``ht`` ``[N, H*F]`` (f32 or bf16), ``senders``/``receivers`` ``[E]`` int32
    with ``receivers`` sorted and ``row_ptr`` ``[N+1]`` its row pointers
    (``row_ptr[0] == 0``, ``row_ptr[N] == E``), ``att`` ``[H, F]``,
    ``edge_valid`` ``[E]`` bool (False on padded slots), ``drop_mask``
    ``[E, H]`` pre-scaled keep mask. Returns ``(out [N, H*F] in ht's type,
    scores [E, H] f32 with -inf on invalid slots, m [N, H] f32, l [N, H]
    f32)``, or ``(out, m, l)`` with ``emit_scores=False`` (no score stream is
    written; the backward recomputes the scores). ``m`` is 0 and ``l`` and
    ``out`` are 0 for a row without a valid edge. Dropout scales the
    aggregation's numerator only. Not differentiable by itself;
    ``GraphContext.attend`` wraps it with its backward.
    """
    if not ht.is_cuda:
        return sddmm_stats_agg_sorted_plain(
            ht, senders, receivers, row_ptr, att, edge_valid=edge_valid,
            drop_mask=drop_mask, negative_slope=negative_slope, eps=eps,
            emit_scores=emit_scores)
    device = ht.device
    n, heads, f, e = _check_graph(ht, senders, row_ptr, att)
    ht = _aligned(ht)
    att_ptr, att_bf16 = _scalar_matrix_arg("att", att, (heads, f), device)
    drop_ptr, drop_bf16 = _scalar_matrix_arg(
        "drop_mask", drop_mask, (e, heads), device)
    valid_ptr = _mask_arg(edge_valid, e, device)
    out = torch.empty_like(ht)
    scores = (torch.empty(e, heads, dtype=torch.float32, device=device)
              if emit_scores else None)
    m = torch.empty(n, heads, dtype=torch.float32, device=device)
    l = torch.empty(n, heads, dtype=torch.float32, device=device)
    result = (out, scores, m, l) if emit_scores else (out, m, l)
    if out.numel() == 0:
        return result
    lib = _library()
    work = recv_bwd_work(row_ptr)
    # The split rows' shares: m_p and l_p [num_shares, H], o_p [.., H*F].
    shares = _shares(work, 2 * heads + heads * f, device)
    m_part = l_part = o_part = None
    if shares is not None:
        m_part, l_part, o_part = (t.data_ptr() for t in shares.split(
            [work.num_shares * heads] * 2 + [work.num_shares * heads * f]))
    with torch.cuda.device(device):
        code = lib.kgt_sddmm_stats_agg_sorted(
            ht.data_ptr(), senders.data_ptr(), *_work_args(work), att_ptr,
            att_bf16, valid_ptr, drop_ptr, drop_bf16, out.data_ptr(),
            None if scores is None else scores.data_ptr(), m.data_ptr(),
            l.data_ptr(), m_part, l_part, o_part, *_fix_args(work), n, heads,
            f, float(negative_slope), float(eps),
            int(ht.dtype == torch.bfloat16), _stream(),
        )
    _raise_on_error(lib, code, "sddmm_stats_agg_sorted")
    LAUNCH_COUNTS["sddmm_stats_agg_sorted"] += 1
    if not emit_scores:
        MODE_LAUNCH_COUNTS["sddmm_stats_agg_sorted(emit_scores=False)"] += 1
    return result


def attend_aggregate_sorted(scores, m, l, ht, senders, receivers, row_ptr, *,
                            eps=1e-10, drop_mask=None):
    """Second half of the two-pass forward: ``out[r] = sum_e alpha[e] *
    keep[e] * ht[senders[e]]`` with ``alpha = exp(scores - m[r]) / (l[r] +
    eps)``, from the cached ``scores`` ``[E, H]`` (``-inf`` on invalid slots)
    and ``m``, ``l`` ``[N, H]`` (all f32, as ``sddmm_stats_sorted`` returns
    them). ``ht`` ``[N, H*F]`` f32 or bf16; the f32 sum is rounded once to
    ``ht``'s type. A row without a valid slot is 0.
    """
    if not ht.is_cuda:
        return attend_aggregate_sorted_plain(
            scores, m, l, ht, senders, receivers, row_ptr, eps=eps,
            drop_mask=drop_mask)
    device = ht.device
    _check_data("ht", ht)
    n, d = ht.shape
    heads = m.shape[1] if m.ndim == 2 else 0
    f = _head_width(d, heads)
    e = senders.shape[0]
    _check_index("senders", senders, e, device)
    _check_index("row_ptr", row_ptr, n + 1, device)
    _check_stats(e, n, heads, device, scores, m=m, l=l)
    drop_ptr, drop_bf16 = _scalar_matrix_arg(
        "drop_mask", drop_mask, (e, heads), device)
    ht = _aligned(ht)
    out = torch.empty_like(ht)
    if out.numel() == 0:
        return out
    lib = _library()
    work = recv_bwd_work(row_ptr)
    shares = _shares(work, d, device)
    with torch.cuda.device(device):
        code = lib.kgt_attend_aggregate_sorted(
            scores.data_ptr(), m.data_ptr(), l.data_ptr(), ht.data_ptr(),
            senders.data_ptr(), *_work_args(work), drop_ptr, drop_bf16,
            out.data_ptr(), None if shares is None else shares.data_ptr(),
            *_fix_args(work), n, heads, f, float(eps),
            int(ht.dtype == torch.bfloat16), _stream(),
        )
    _raise_on_error(lib, code, "attend_aggregate_sorted")
    LAUNCH_COUNTS["attend_aggregate_sorted"] += 1
    return out


def attend_rho_sorted(g, scores, m, l, ht, senders, receivers, row_ptr, *,
                      eps=1e-10, drop_mask=None, att=None, negative_slope=0.2,
                      edge_valid=None):
    """Softmax-Jacobian row term ``rho [N, H]`` f32.

    ``g`` is the cotangent of the forward's output (``[N, H*F]``, ``ht``'s
    type); ``scores``, ``m``, ``l`` are the forward's. ``rho[r, h] = sum_e
    alpha[e, h] * keep[e, h] * sum_f g[r, h, f] * ht[senders[e], h, f]`` with
    ``alpha = exp(scores - m[r]) / (l[r] + eps)``. ``scores=None``
    recomputes the scores from ``ht``, ``att`` (required then),
    ``negative_slope`` and ``edge_valid``, as the forward computed them.
    """
    if not ht.is_cuda:
        return attend_rho_sorted_plain(
            g, scores, m, l, ht, senders, receivers, row_ptr, eps=eps,
            drop_mask=drop_mask, att=att, negative_slope=negative_slope,
            edge_valid=edge_valid)
    device = ht.device
    _check_data("ht", ht)
    n, d = ht.shape
    heads = m.shape[1] if m.ndim == 2 else 0
    f = _head_width(d, heads)
    e = senders.shape[0]
    _check_like("g", g, (n, d), ht.dtype, device)
    _check_index("senders", senders, e, device)
    _check_index("row_ptr", row_ptr, n + 1, device)
    _check_stats(e, n, heads, device, scores, m=m, l=l)
    att_ptr, att_bf16, valid_ptr = None, 0, None
    if scores is None:
        if att is None:
            raise ValueError("scores=None needs att= to recompute the scores")
        att_ptr, att_bf16 = _scalar_matrix_arg("att", att, (heads, f), device)
        valid_ptr = _mask_arg(edge_valid, e, device)
    drop_ptr, drop_bf16 = _scalar_matrix_arg(
        "drop_mask", drop_mask, (e, heads), device)
    g, ht = _aligned(g), _aligned(ht)
    rho = torch.empty(n, heads, dtype=torch.float32, device=device)
    if ht.numel() == 0:
        return rho
    lib = _library()
    work = recv_bwd_work(row_ptr)
    shares = _shares(work, heads, device)
    with torch.cuda.device(device):
        code = lib.kgt_attend_rho_sorted(
            g.data_ptr(), ht.data_ptr(), senders.data_ptr(),
            *_work_args(work), None if scores is None else scores.data_ptr(),
            m.data_ptr(), l.data_ptr(), att_ptr, att_bf16, valid_ptr,
            drop_ptr, drop_bf16, rho.data_ptr(),
            None if shares is None else shares.data_ptr(), *_fix_args(work),
            n, heads, f, float(negative_slope), float(eps),
            int(ht.dtype == torch.bfloat16), _stream(),
        )
    _raise_on_error(lib, code, "attend_rho_sorted")
    LAUNCH_COUNTS["attend_rho_sorted"] += 1
    if scores is None:
        MODE_LAUNCH_COUNTS["attend_rho_sorted(scores=None)"] += 1
    return rho


def attend_recv_bwd_full_sorted(ht, g, senders, receivers, row_ptr, att,
                                scores, m, l, rho, *, eps=1e-10,
                                negative_slope=0.2, drop_mask=None,
                                emit_v=True, edge_valid=None):
    """Receiver-side backward of the fused attention.

    Returns ``(dht [N, H*F], datt [H, F], v [E, H*F])``: the receiver part of
    the cotangent of ``ht``, the cotangent of ``att`` (in ``att``'s type), and
    the per-edge sender cotangent ``v = alpha*keep*g[recv] + d_pre`` in
    receiver-sorted order (0 on invalid slots), whose sum by sender is the
    sender part of ``d ht``. ``emit_v=False`` returns ``(dht, datt)`` and
    writes no ``v`` (the sender backward recomputes it). ``scores=None``
    recomputes the scores as the forward computed them (``edge_valid`` marks
    the padded slots then).
    """
    if not ht.is_cuda:
        return attend_recv_bwd_full_sorted_plain(
            ht, g, senders, receivers, row_ptr, att, scores, m, l, rho,
            eps=eps, negative_slope=negative_slope, drop_mask=drop_mask,
            emit_v=emit_v, edge_valid=edge_valid)
    device = ht.device
    n, heads, f, e = _check_graph(ht, senders, row_ptr, att)
    d = heads * f
    att_ptr, att_bf16 = _scalar_matrix_arg("att", att, (heads, f), device)
    drop_ptr, drop_bf16 = _scalar_matrix_arg(
        "drop_mask", drop_mask, (e, heads), device)
    _check_like("g", g, (n, d), ht.dtype, device)
    _check_stats(e, n, heads, device, scores, m=m, l=l, rho=rho)
    valid_ptr = None if scores is not None else _mask_arg(edge_valid, e,
                                                          device)
    ht, g = _aligned(ht), _aligned(g)
    dht = torch.empty_like(ht)
    v = torch.empty(e, d, dtype=ht.dtype, device=device) if emit_v else None
    datt = torch.empty(heads, f, dtype=torch.float32, device=device)
    if ht.numel() == 0:
        datt = datt.zero_().to(att.dtype)
        return (dht, datt, v) if emit_v else (dht, datt)
    lib = _library()
    is_bf16 = int(ht.dtype == torch.bfloat16)
    v_ptr = None if v is None else v.data_ptr()
    work = recv_bwd_work(row_ptr)
    shares = _shares(work, d, device)
    with torch.cuda.device(device):
        partial_rows = lib.kgt_attend_recv_bwd_partial_rows(
            ht.data_ptr(), g.data_ptr(), dht.data_ptr(), v_ptr,
            work.num_pieces, heads, f, is_bf16)
        partial = torch.empty(partial_rows, d, dtype=torch.float32,
                              device=device)
        code = lib.kgt_attend_recv_bwd_full_sorted(
            ht.data_ptr(), g.data_ptr(), senders.data_ptr(),
            *_work_args(work), att_ptr, att_bf16,
            None if scores is None else scores.data_ptr(), m.data_ptr(),
            l.data_ptr(), rho.data_ptr(), valid_ptr, drop_ptr, drop_bf16,
            dht.data_ptr(), None if shares is None else shares.data_ptr(),
            *_fix_args(work), v_ptr, datt.data_ptr(), partial.data_ptr(), n,
            heads, f, float(negative_slope), float(eps), is_bf16, _stream(),
        )
    _raise_on_error(lib, code, "attend_recv_bwd_full_sorted")
    LAUNCH_COUNTS["attend_recv_bwd_full_sorted"] += 1
    if scores is None:
        MODE_LAUNCH_COUNTS["attend_recv_bwd_full_sorted(scores=None)"] += 1
    if not emit_v:
        MODE_LAUNCH_COUNTS["attend_recv_bwd_full_sorted(emit_v=False)"] += 1
        return dht, datt.to(att.dtype)
    return dht, datt.to(att.dtype), v


def attend_send_bwd_sorted(ht, g, receivers_ss, senders_sorted, row_ptr_bwd,
                           att, m, l, rho, *, eps=1e-10, negative_slope=0.2,
                           valid_ss=None, drop_ss=None):
    """Sender side of the fused attention's backward, recomputed in sender
    order: ``d ht_send [N, H*F]`` in ``ht``'s type, ``d ht_send[j] = sum over
    the slots e with sender j of alpha*keep*g[r] + d_pre`` with ``r =
    receivers_ss[e]``. On the card the kernel walks the pieces of
    ``recv_bwd_work(row_ptr_bwd)``; a sender row split into pieces is the
    sum of their f32 shares in piece order.

    ``receivers_ss`` / ``senders_sorted`` ``[E]`` int32 are the stream in
    sender-sorted order and ``row_ptr_bwd`` ``[N+1]`` the row pointers of
    ``senders_sorted``; ``g`` is the forward output's cotangent (``ht``'s
    type); ``m``, ``l``, ``rho`` ``[N, H]`` f32 are the forward's statistics
    and rho. ``valid_ss`` ``[E]`` f32 (1 real, 0 padded; None: all real) and
    ``drop_ss`` ``[E, H]`` (the keep mask) are in sender-sorted order. The
    score is recomputed as the forward computed it; ``datt`` is the receiver
    backward's (``emit_v=False``), not this kernel's.
    """
    if not ht.is_cuda:
        return attend_send_bwd_sorted_plain(
            ht, g, receivers_ss, senders_sorted, row_ptr_bwd, att, m, l, rho,
            eps=eps, negative_slope=negative_slope, valid_ss=valid_ss,
            drop_ss=drop_ss)
    device = ht.device
    n, heads, f, e = _check_graph(ht, receivers_ss, row_ptr_bwd, att)
    d = heads * f
    _check_index("senders_sorted", senders_sorted, e, device)
    _check_like("g", g, (n, d), ht.dtype, device)
    _check_stats(e, n, heads, device, None, m=m, l=l, rho=rho)
    att_ptr, att_bf16 = _scalar_matrix_arg("att", att, (heads, f), device)
    drop_ptr, drop_bf16 = _scalar_matrix_arg("drop_ss", drop_ss, (e, heads),
                                             device)
    valid_ptr = None
    if valid_ss is not None:
        _check_like("valid_ss", valid_ss, (e,), torch.float32, device)
        valid_ptr = valid_ss.data_ptr()
    ht, g = _aligned(ht), _aligned(g)
    out = torch.empty_like(ht)
    if out.numel() == 0:
        return out
    lib = _library()
    work = recv_bwd_work(row_ptr_bwd)
    shares = _shares(work, d, device)
    with torch.cuda.device(device):
        code = lib.kgt_attend_send_bwd_sorted(
            ht.data_ptr(), g.data_ptr(), receivers_ss.data_ptr(),
            *_work_args(work), att_ptr, att_bf16, m.data_ptr(), l.data_ptr(),
            rho.data_ptr(), valid_ptr, drop_ptr, drop_bf16, out.data_ptr(),
            None if shares is None else shares.data_ptr(), *_fix_args(work),
            n, heads, f, float(negative_slope), float(eps),
            int(ht.dtype == torch.bfloat16), _stream(),
        )
    _raise_on_error(lib, code, "attend_send_bwd_sorted")
    LAUNCH_COUNTS["attend_send_bwd_sorted"] += 1
    return out
