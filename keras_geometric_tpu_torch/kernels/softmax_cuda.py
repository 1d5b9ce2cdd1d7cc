"""Sorted edge softmax on Hopper: per-receiver statistics and normalisation.

Counterpart of the JAX package's ``kernels/softmax_pallas.py``
(``softmax_stats_sorted``, ``softmax_apply_sorted``). The kernels are CUDA C++
(``csrc/softmax.cu``, built by ``_build.py`` at first use); this module holds
their wrappers, their plain PyTorch versions, their launch counters and their
argument checks. ``ops/csr.py`` wires them into ``GraphContext.edge_softmax``.

The signatures take what the kernels walk instead of the reference's TPU
work-list tables: ``row_ptr`` for the statistics (the pieces of its rows)
and ``receivers`` for the normalisation (one thread per slot and head).

Source notes, one per kernel (both are bound by bytes):

- ``softmax_stats_sorted``: online per-row max ``m`` and normaliser ``l`` of
  ``[E, K]`` f32 scores; reads the score stream once, writes ``[N, K]`` twice.
  One thread per (piece, head) over the pieces of ``row_ptr``
  (:func:`spmm_cuda.recv_bwd_work`, at most 32 slots of one row, the list
  the attention kernels walk) loads its slots' scores sixteen at once and
  folds them in order with the fused forward's online step; a split row (a
  hub, the padded tail) is merged in piece order by a second launch with
  the forward's merge. So ``(m, l)`` equals the fused forward's
  (``attend_cuda.sddmm_stats_agg_sorted``) bit for bit on the same scores.
- ``softmax_apply_sorted``: ``alpha = exp(s - m[r]) / (l[r] + eps)``; reads
  the scores and the receivers, each receiver's ``(m, l)`` row, writes
  alpha. Threads lie on the flat (slot, pack) index, a pack being up to four
  neighbouring heads moved with one 16-byte load or store
  (:func:`_apply_vec`), one pack a thread; a thread reads ``recv[e]`` once
  a pack and finds its slot by a multiply-high and a shift. A launch too
  small to give every SM two blocks takes narrower packs. Each element is the
  plain version's formula with an IEEE division.

A wrapper takes the plain version only for a tensor that lies on the CPU. For
a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .attend_cuda import _check_like
from .spmm_cuda import _check_index, _raise_on_error, recv_bwd_work

__all__ = [
    "softmax_stats_sorted",
    "softmax_apply_sorted",
    "softmax_stats_sorted_plain",
    "softmax_apply_sorted_plain",
    "LAUNCH_COUNTS",
    "reset_launch_counts",
]

# One plain integer per kernel entry, incremented where the kernel is
# launched and nowhere else.
LAUNCH_COUNTS = {
    "softmax_stats_sorted": 0,
    "softmax_apply_sorted": 0,
}

_OUT_DTYPES = (torch.float32, torch.bfloat16)


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


# ---------------------------------------------------------------------------
# Plain PyTorch versions: the same functions with library ops, f32 inside.
# Used for CPU tensors and as the yardstick the kernels are held against on
# the card. ``row_ptr`` is what the statistics kernel walks; the plain
# version uses ``receivers``.
# ---------------------------------------------------------------------------


def softmax_stats_sorted_plain(scores, receivers, num_nodes):
    e, k = scores.shape
    recv = receivers.long()
    s = scores.float()
    m = torch.full((num_nodes, k), float("-inf"), device=scores.device)
    m = m.scatter_reduce(0, recv[:, None].expand(e, k), s, "amax")
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    ex = torch.exp(s - m.index_select(0, recv))  # -inf slots -> 0
    l = torch.zeros(num_nodes, k, device=scores.device).index_add_(0, recv, ex)
    return m, l


def softmax_apply_sorted_plain(scores, m, l, receivers, *, eps=1e-10,
                               out_dtype=None):
    recv = receivers.long()
    alpha = torch.exp(scores.float() - m.index_select(0, recv)) / (
        l.index_select(0, recv) + eps)
    return alpha.to(out_dtype or scores.dtype)


# ---------------------------------------------------------------------------
# Kernel launches.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _build.load_library("softmax")
    vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                         ctypes.c_float)
    lib.kgt_softmax_stats_sorted.argtypes = [
        vp, vp, i64, vp, vp, i64, vp, vp, vp, vp, i64, i32, vp,
    ]
    lib.kgt_softmax_stats_sorted.restype = i32
    lib.kgt_softmax_apply_sorted.argtypes = [
        vp, vp, vp, vp, vp, i64, i32, i32, f32, i32, vp,
    ]
    lib.kgt_softmax_apply_sorted.restype = i32
    lib.kgt_cuda_error_string.argtypes = [i32]
    lib.kgt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_scores(scores):
    """The kernels read f32 ``[E, K]`` scores; returns ``(E, K)``."""
    if scores.ndim != 2:
        raise ValueError(f"scores must be [E, K], got {tuple(scores.shape)}")
    e, k = scores.shape
    _check_like("scores", scores, (e, k), torch.float32, scores.device)
    if e * max(k, 1) >= 2**31:
        raise ValueError("E*K must stay below 2**31 (int32 indices)")
    return e, k


# Threads a block of the normalisation kernel (csrc/lanes.cuh kThreads), and
# the blocks a SM below which a launch takes narrower packs, so that a small
# launch spreads over the card.
_APPLY_THREADS = 256
_APPLY_MIN_BLOCKS_PER_SM = 2


def _apply_vec(heads, num_slots, sms, scores, m, l, alpha):
    """Heads in a pack of the normalisation kernel, one pack a thread: the
    widest of 4, 2 and 1 that divides ``heads`` and keeps ``scores``, ``m``,
    ``l`` (f32) and ``alpha`` aligned to its pack (16 bytes of f32 at 4),
    narrowed while its grid would give the card's ``sms`` SMs fewer than
    ``_APPLY_MIN_BLOCKS_PER_SM`` blocks each (at CiteSeer's E * H = 106k:
    single heads, 416 blocks, against 104 of 16-byte packs)."""
    vec = next(v for v in (4, 2, 1) if heads % v == 0 and all(
        t.data_ptr() % (v * t.element_size()) == 0
        for t in (scores, m, l, alpha)))
    while vec > 1 and (-(-num_slots * (heads // vec) // _APPLY_THREADS)
                       < _APPLY_MIN_BLOCKS_PER_SM * sms):
        vec //= 2
    return vec


def softmax_stats_sorted(scores, receivers, row_ptr, num_nodes):
    """Per-receiver ``(m, l)`` of receiver-sorted ``[E, K]`` scores.

    ``scores`` f32 with masked slots already ``-inf``; ``receivers`` ``[E]``
    int32, sorted, and ``row_ptr`` ``[N+1]`` its row pointers
    (``row_ptr[0] == 0``, ``row_ptr[N] == E``), whose pieces the kernel
    walks (the plain version, which a CPU tensor takes, reads
    ``receivers``). Returns ``m`` (row max, 0 for a row without a finite
    score) and ``l = sum exp(s - m)``, each ``[num_nodes, K]`` f32.
    """
    if not scores.is_cuda:
        return softmax_stats_sorted_plain(scores, receivers, num_nodes)
    device = scores.device
    e, k = _check_scores(scores)
    _check_index("receivers", receivers, e, device)
    _check_index("row_ptr", row_ptr, num_nodes + 1, device)
    m = torch.empty(num_nodes, k, dtype=torch.float32, device=device)
    l = torch.empty(num_nodes, k, dtype=torch.float32, device=device)
    if m.numel() == 0 or e == 0:  # no slot: every row is empty
        return m.zero_(), l.zero_()
    lib = _library()
    work = recv_bwd_work(row_ptr)
    # Each split row's pieces leave their (m, l) here for the merge.
    m_part = torch.empty(work.num_shares, k, dtype=torch.float32,
                         device=device)
    l_part = torch.empty_like(m_part)
    with torch.cuda.device(device):
        code = lib.kgt_softmax_stats_sorted(
            scores.data_ptr(), work.pieces.data_ptr(), work.num_pieces,
            work.fix_rows.data_ptr(), work.fix_ptr.data_ptr(),
            work.fix_rows.shape[0], m.data_ptr(), l.data_ptr(),
            m_part.data_ptr(), l_part.data_ptr(), num_nodes, k,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on_error(lib, code, "softmax_stats_sorted")
    LAUNCH_COUNTS["softmax_stats_sorted"] += 1
    return m, l


def softmax_apply_sorted(scores, m, l, receivers, *, eps=1e-10,
                         out_dtype=None):
    """``alpha[e] = exp(s[e] - m[recv[e]]) / (l[recv[e]] + eps)``.

    ``scores`` f32 ``[E, K]`` (masked slots ``-inf``, which come out 0),
    ``m`` / ``l`` from :func:`softmax_stats_sorted`. ``alpha`` is
    ``[E, K]`` in ``out_dtype`` (f32 or bf16; the scores' type by default).
    """
    if not scores.is_cuda:
        return softmax_apply_sorted_plain(scores, m, l, receivers, eps=eps,
                                          out_dtype=out_dtype)
    device = scores.device
    out_dtype = out_dtype or scores.dtype
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    e, k = _check_scores(scores)
    _check_index("receivers", receivers, e, device)
    if m.ndim != 2:
        raise ValueError(f"m must be [N, K], got {tuple(m.shape)}")
    for name, t in (("m", m), ("l", l)):
        _check_like(name, t, (m.shape[0], k), torch.float32, device)
    alpha = torch.empty(e, k, dtype=out_dtype, device=device)
    if alpha.numel() == 0:
        return alpha
    lib = _library()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    with torch.cuda.device(device):
        code = lib.kgt_softmax_apply_sorted(
            scores.data_ptr(), receivers.data_ptr(), m.data_ptr(),
            l.data_ptr(), alpha.data_ptr(), e, k,
            _apply_vec(k, e, sms, scores, m, l, alpha), float(eps),
            int(out_dtype == torch.bfloat16),
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on_error(lib, code, "softmax_apply_sorted")
    LAUNCH_COUNTS["softmax_apply_sorted"] += 1
    return alpha
