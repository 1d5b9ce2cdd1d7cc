"""Fused GATv2 attention on Hopper: forward, rho and the receiver backward.

Counterpart of the JAX package's ``sddmm_stats_agg_sorted``
(``kernels/sddmm_pallas.py``), ``attend_rho_sorted`` and
``attend_recv_bwd_full_sorted`` (``kernels/attend_pallas.py``), in their
default modes (cached scores, ``emit_v=True``). The kernels are CUDA C++
(``csrc/attend.cu``, built by ``_build.py`` at first use); this module holds
their wrappers, their plain PyTorch versions, their launch counters and their
argument checks. ``ops/csr.py`` wires them into ``GraphContext.attend``.

One thing differs from the reference's signatures: the kernels gather the
sender rows themselves, so they take ``ht`` and ``senders`` where the
reference takes the materialised ``hj = ht[senders]``; the ``[E, H*F]`` array
never reaches device memory.

Source notes, one per kernel (all three are bound by bytes):

- ``sddmm_stats_agg_sorted``: scores, online softmax statistics and the
  attention-weighted aggregation in one pass. Moves the node array and the
  output once, the sender, validity and keep-mask streams, and the ``[E, H]``
  f32 score cache. A sub-warp group per (receiver row, head) keeps the running
  max, normaliser and output columns in registers; a lane moves up to 16
  bytes of neighbouring columns at a time, so that at F = 64 in bf16 one warp
  serves the four heads of a row.
- ``attend_rho_sorted``: ``rho[r, h] = sum_e alpha*keep*<g[r, h], ht[j, h]>``
  from the cached scores; reads two node arrays and the score stream, writes
  ``[N, H]``.
- ``attend_recv_bwd_full_sorted``: recomputes ``pre``, ``alpha``, ``dalpha``;
  writes the receiver part of ``d ht``, the per-edge sender cotangent ``v``
  (``[E, H*F]``, the largest stream of the three kernels) and ``datt``. The
  reduction of ``datt`` over all edges goes through per-group partials and a
  second small kernel that sums them in a fixed order: no atomics, so ``datt``
  is bit-reproducible.

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
    _check_data,
    _check_index,
    _mask_arg,
    _raise_on_error,
)

__all__ = [
    "sddmm_stats_agg_sorted",
    "attend_rho_sorted",
    "attend_recv_bwd_full_sorted",
    "sddmm_stats_agg_sorted_plain",
    "attend_rho_sorted_plain",
    "attend_recv_bwd_full_sorted_plain",
    "LAUNCH_COUNTS",
    "reset_launch_counts",
    "MAX_HEAD_WIDTH",
]

# One plain integer per kernel entry, incremented where the kernel is
# launched and nowhere else.
LAUNCH_COUNTS = {
    "sddmm_stats_agg_sorted": 0,
    "attend_rho_sorted": 0,
    "attend_recv_bwd_full_sorted": 0,
}

# Columns per head the kernels take: 8 per lane of a warp.
MAX_HEAD_WIDTH = 256


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


# ---------------------------------------------------------------------------
# Plain PyTorch versions: the same functions of the same arguments with
# library ops, f32 inside, rounded once. Used for CPU tensors and as the
# yardstick the kernels are held against on the card. ``row_ptr`` is what the
# kernels walk; the plain versions use ``receivers``.
# ---------------------------------------------------------------------------


def _edge_views(ht, senders, receivers, heads):
    e = senders.shape[0]
    f = ht.shape[1] // heads
    rows = ht.float()
    hj = rows.index_select(0, senders.long()).view(e, heads, f)
    hi = rows.index_select(0, receivers.long()).view(e, heads, f)
    return hi, hj


def _alpha(scores, m, l, receivers, eps):
    recv = receivers.long()
    return torch.exp(scores - m.index_select(0, recv)) / (
        l.index_select(0, recv) + eps)


def sddmm_stats_agg_sorted_plain(ht, senders, receivers, row_ptr, att, *,
                                 edge_valid=None, drop_mask=None,
                                 negative_slope=0.2, eps=1e-10):
    del row_ptr
    n, d = ht.shape
    heads = att.shape[0]
    e = senders.shape[0]
    recv = receivers.long()
    hi, hj = _edge_views(ht, senders, receivers, heads)
    pre = hi + hj
    z = torch.where(pre > 0, pre, negative_slope * pre)
    scores = (z * att.float()[None]).sum(-1)
    if edge_valid is not None:
        scores = scores.masked_fill(~edge_valid[:, None], float("-inf"))
    m = torch.full((n, heads), float("-inf"), device=ht.device)
    m = m.scatter_reduce(0, recv[:, None].expand(e, heads), scores, "amax")
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    ex = torch.exp(scores - m.index_select(0, recv))
    l = torch.zeros(n, heads, device=ht.device).index_add_(0, recv, ex)
    if drop_mask is not None:  # dropout scales the numerator only
        ex = ex * drop_mask.float()
    o = torch.zeros(n, d, device=ht.device).index_add_(
        0, recv, (ex[:, :, None] * hj).reshape(e, d))
    out = o.view(n, heads, -1) / (l[:, :, None] + eps)
    return out.reshape(n, d).to(ht.dtype), scores, m, l


def attend_rho_sorted_plain(g, scores, m, l, ht, senders, receivers, row_ptr,
                            *, eps=1e-10, drop_mask=None):
    del row_ptr
    n, heads = m.shape
    recv = receivers.long()
    _, hj = _edge_views(ht, senders, receivers, heads)
    g_e = g.float().index_select(0, recv).view(hj.shape)
    prod = _alpha(scores, m, l, receivers, eps) * (g_e * hj).sum(-1)
    if drop_mask is not None:
        prod = prod * drop_mask.float()
    return torch.zeros(n, heads, device=ht.device).index_add_(0, recv, prod)


def attend_recv_bwd_full_sorted_plain(ht, g, senders, receivers, row_ptr, att,
                                      scores, m, l, rho, *, eps=1e-10,
                                      negative_slope=0.2, drop_mask=None):
    del row_ptr
    n, d = ht.shape
    heads = att.shape[0]
    e = senders.shape[0]
    recv = receivers.long()
    hi, hj = _edge_views(ht, senders, receivers, heads)
    g_e = g.float().index_select(0, recv).view(hj.shape)
    alpha = _alpha(scores, m, l, receivers, eps)
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
    v = alpha_keep[:, :, None] * g_e + d_pre
    return dht.to(ht.dtype), datt.to(att.dtype), v.reshape(e, d).to(ht.dtype)


# ---------------------------------------------------------------------------
# Kernel launches.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _build.load_library("attend")
    vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                         ctypes.c_float)
    lib.kgt_sddmm_stats_agg_sorted.argtypes = [
        vp, vp, vp, vp, i32, vp, vp, i32, vp, vp, vp, vp, i64, i32, i64, f32,
        f32, i32, vp,
    ]
    lib.kgt_sddmm_stats_agg_sorted.restype = i32
    lib.kgt_attend_rho_sorted.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, vp, i32, vp, i64, i32, i64, f32, i32, vp,
    ]
    lib.kgt_attend_rho_sorted.restype = i32
    lib.kgt_attend_recv_bwd_partial_rows.argtypes = [
        vp, vp, vp, vp, i64, i32, i64, i32,
    ]
    lib.kgt_attend_recv_bwd_partial_rows.restype = i64
    lib.kgt_attend_recv_bwd_full_sorted.argtypes = [
        vp, vp, vp, vp, vp, i32, vp, vp, vp, vp, vp, i32, vp, vp, vp, vp, i64,
        i32, i64, f32, f32, i32, vp,
    ]
    lib.kgt_attend_recv_bwd_full_sorted.restype = i32
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


def _check_graph(ht, senders, row_ptr, att):
    """Shared checks; returns ``(n, heads, f, num_slots)``."""
    _check_data("ht", ht)
    n, d = ht.shape
    if att.ndim != 2 or att.shape[0] * att.shape[1] != d:
        raise ValueError(
            f"att must be [H, F] with H*F = {d}, got {tuple(att.shape)}")
    heads, f = att.shape
    if f > MAX_HEAD_WIDTH:
        raise ValueError(
            f"the attention kernels take at most {MAX_HEAD_WIDTH} columns "
            f"per head, got F = {f}")
    e = senders.shape[0]
    if e >= 2**31:
        raise ValueError("edge count must stay below 2**31 (int32 indices)")
    _check_index("senders", senders, e, ht.device)
    _check_index("row_ptr", row_ptr, n + 1, ht.device)
    return n, heads, f, e


def sddmm_stats_agg_sorted(ht, senders, receivers, row_ptr, att, *,
                           edge_valid=None, drop_mask=None,
                           negative_slope=0.2, eps=1e-10):
    """Fused GATv2 forward over a receiver-sorted stream.

    ``ht`` ``[N, H*F]`` (f32 or bf16), ``senders``/``receivers`` ``[E]`` int32
    with ``receivers`` sorted and ``row_ptr`` ``[N+1]`` its row pointers
    (``row_ptr[0] == 0``, ``row_ptr[N] == E``), ``att`` ``[H, F]``,
    ``edge_valid`` ``[E]`` bool (False on padded slots), ``drop_mask``
    ``[E, H]`` pre-scaled keep mask. Returns ``(out [N, H*F] in ht's type,
    scores [E, H] f32 with -inf on invalid slots, m [N, H] f32, l [N, H]
    f32)``; ``m`` is 0 and ``l`` and ``out`` are 0 for a row without a valid
    edge. Dropout scales the aggregation's numerator only. Not differentiable
    by itself; ``GraphContext.attend`` wraps it with its backward.
    """
    if not ht.is_cuda:
        return sddmm_stats_agg_sorted_plain(
            ht, senders, receivers, row_ptr, att, edge_valid=edge_valid,
            drop_mask=drop_mask, negative_slope=negative_slope, eps=eps)
    device = ht.device
    n, heads, f, e = _check_graph(ht, senders, row_ptr, att)
    att_ptr, att_bf16 = _scalar_matrix_arg("att", att, (heads, f), device)
    drop_ptr, drop_bf16 = _scalar_matrix_arg(
        "drop_mask", drop_mask, (e, heads), device)
    valid_ptr = _mask_arg(edge_valid, e, device)
    out = torch.empty_like(ht)
    scores = torch.empty(e, heads, dtype=torch.float32, device=device)
    m = torch.empty(n, heads, dtype=torch.float32, device=device)
    l = torch.empty(n, heads, dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out, scores, m, l
    lib = _library()
    with torch.cuda.device(device):
        code = lib.kgt_sddmm_stats_agg_sorted(
            ht.data_ptr(), senders.data_ptr(), row_ptr.data_ptr(), att_ptr,
            att_bf16, valid_ptr, drop_ptr, drop_bf16, out.data_ptr(),
            scores.data_ptr(), m.data_ptr(), l.data_ptr(), n, heads, f,
            float(negative_slope), float(eps),
            int(ht.dtype == torch.bfloat16),
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on_error(lib, code, "sddmm_stats_agg_sorted")
    LAUNCH_COUNTS["sddmm_stats_agg_sorted"] += 1
    return out, scores, m, l


def attend_rho_sorted(g, scores, m, l, ht, senders, receivers, row_ptr, *,
                      eps=1e-10, drop_mask=None):
    """Softmax-Jacobian row term ``rho [N, H]`` f32.

    ``g`` is the cotangent of the forward's output (``[N, H*F]``, ``ht``'s
    type); ``scores``, ``m``, ``l`` are the forward's. ``rho[r, h] = sum_e
    alpha[e, h] * keep[e, h] * sum_f g[r, h, f] * ht[senders[e], h, f]`` with
    ``alpha = exp(scores - m[r]) / (l[r] + eps)``.
    """
    if not ht.is_cuda:
        return attend_rho_sorted_plain(
            g, scores, m, l, ht, senders, receivers, row_ptr, eps=eps,
            drop_mask=drop_mask)
    device = ht.device
    _check_data("ht", ht)
    n, d = ht.shape
    heads = m.shape[1]
    if heads < 1 or d % heads:
        raise ValueError(f"{heads} heads do not divide the width {d}")
    f = d // heads
    if f > MAX_HEAD_WIDTH:
        raise ValueError(
            f"the attention kernels take at most {MAX_HEAD_WIDTH} columns "
            f"per head, got F = {f}")
    e = senders.shape[0]
    _check_like("g", g, (n, d), ht.dtype, device)
    _check_index("senders", senders, e, device)
    _check_index("row_ptr", row_ptr, n + 1, device)
    _check_like("scores", scores, (e, heads), torch.float32, device)
    _check_like("m", m, (n, heads), torch.float32, device)
    _check_like("l", l, (n, heads), torch.float32, device)
    drop_ptr, drop_bf16 = _scalar_matrix_arg(
        "drop_mask", drop_mask, (e, heads), device)
    rho = torch.empty(n, heads, dtype=torch.float32, device=device)
    if ht.numel() == 0:
        return rho
    lib = _library()
    with torch.cuda.device(device):
        code = lib.kgt_attend_rho_sorted(
            g.data_ptr(), ht.data_ptr(), senders.data_ptr(),
            row_ptr.data_ptr(), scores.data_ptr(), m.data_ptr(),
            l.data_ptr(), drop_ptr, drop_bf16, rho.data_ptr(), n, heads, f,
            float(eps), int(ht.dtype == torch.bfloat16),
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on_error(lib, code, "attend_rho_sorted")
    LAUNCH_COUNTS["attend_rho_sorted"] += 1
    return rho


def attend_recv_bwd_full_sorted(ht, g, senders, receivers, row_ptr, att,
                                scores, m, l, rho, *, eps=1e-10,
                                negative_slope=0.2, drop_mask=None):
    """Receiver-side backward of the fused attention.

    Returns ``(dht [N, H*F], datt [H, F], v [E, H*F])``: the receiver part of
    the cotangent of ``ht``, the cotangent of ``att`` (in ``att``'s type), and
    the per-edge sender cotangent ``v = alpha*keep*g[recv] + d_pre`` in
    receiver-sorted order (0 on invalid slots), whose sum by sender is the
    sender part of ``d ht``.
    """
    if not ht.is_cuda:
        return attend_recv_bwd_full_sorted_plain(
            ht, g, senders, receivers, row_ptr, att, scores, m, l, rho,
            eps=eps, negative_slope=negative_slope, drop_mask=drop_mask)
    device = ht.device
    n, heads, f, e = _check_graph(ht, senders, row_ptr, att)
    d = heads * f
    att_ptr, att_bf16 = _scalar_matrix_arg("att", att, (heads, f), device)
    drop_ptr, drop_bf16 = _scalar_matrix_arg(
        "drop_mask", drop_mask, (e, heads), device)
    _check_like("g", g, (n, d), ht.dtype, device)
    _check_like("scores", scores, (e, heads), torch.float32, device)
    for name, t in (("m", m), ("l", l), ("rho", rho)):
        _check_like(name, t, (n, heads), torch.float32, device)
    dht = torch.empty_like(ht)
    v = torch.empty(e, d, dtype=ht.dtype, device=device)
    datt = torch.empty(heads, f, dtype=torch.float32, device=device)
    if ht.numel() == 0:
        return dht, datt.zero_().to(att.dtype), v
    lib = _library()
    is_bf16 = int(ht.dtype == torch.bfloat16)
    with torch.cuda.device(device):
        partial_rows = lib.kgt_attend_recv_bwd_partial_rows(
            ht.data_ptr(), g.data_ptr(), dht.data_ptr(), v.data_ptr(), n,
            heads, f, is_bf16)
        partial = torch.empty(partial_rows, d, dtype=torch.float32,
                              device=device)
        code = lib.kgt_attend_recv_bwd_full_sorted(
            ht.data_ptr(), g.data_ptr(), senders.data_ptr(),
            row_ptr.data_ptr(), att_ptr, att_bf16, scores.data_ptr(),
            m.data_ptr(), l.data_ptr(), rho.data_ptr(), drop_ptr, drop_bf16,
            dht.data_ptr(), v.data_ptr(), datt.data_ptr(),
            partial.data_ptr(), n, heads, f, float(negative_slope),
            float(eps), is_bf16,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on_error(lib, code, "attend_recv_bwd_full_sorted")
    LAUNCH_COUNTS["attend_recv_bwd_full_sorted"] += 1
    return dht, datt.to(att.dtype), v
