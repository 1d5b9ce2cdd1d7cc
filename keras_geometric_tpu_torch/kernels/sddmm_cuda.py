"""GATv2 attention scores on Hopper: the composed path's score kernel and its
backward, and the two-pass forward's score-and-statistics kernel.

Counterpart of the JAX package's ``sddmm_scores_sorted``,
``sddmm_bwd_sorted`` and ``sddmm_stats_sorted`` (``kernels/sddmm_pallas.py``).
The kernels are CUDA C++ (``csrc/sddmm.cu``, built by ``_build.py`` at first
use); this module holds their wrappers, their plain PyTorch versions, their
launch counters and their argument checks. ``ops/csr.py`` wires the first two
into ``GraphContext.sddmm_scores``; ``sddmm_stats_sorted`` followed by
``attend_cuda.attend_aggregate_sorted`` computes what the one-pass forward
``attend_cuda.sddmm_stats_agg_sorted`` does.

As in the reference, the score kernel and its backward take the materialised
sender rows ``hj = ht[senders]`` (``[E, H*F]``, receiver-sorted slot order):
on the composed path ``hj`` exists anyway, because the messages are
``alpha * hj``. In place of the reference's TPU work-list tables they take
``receivers``. ``sddmm_stats_sorted`` takes ``ht``, ``senders`` and
``row_ptr`` and gathers the sender rows itself, as the one-pass forward does:
the reference's ``hj`` input is not made.

Source notes, one per kernel (all three are bound by bytes):

- ``sddmm_scores_sorted``: ``s[e, h] = sum_f att[h, f] *
  leaky_relu(ht[recv e] + hj[e])[hF + f]`` in f32. Reads ``hj`` once (most of
  its bytes), each receiver row once a piece, writes ``[E, H]``. It walks
  the pieces of the receiver-sorted stream (:func:`spmm_cuda.recv_bwd_work`
  of ``row_ptr``, at most 32 slots of one row, the list the attention
  kernels walk): a fixed grid of sub-warp groups strides over the (piece,
  head) items with its head held constant, keeps the head's columns of the
  receiver row and of ``att`` in registers for the piece, streams the
  piece's contiguous ``hj`` rows through a ``cp.async`` ring of eight
  stages (16-byte packs per lane), reduces each score by shuffles and
  writes the piece's scores from shared memory at its end. Its scores are
  the fused forward's (K9's) bit for bit on ``hj = ht[senders]``: the same
  score function in the same lane layout.
- ``sddmm_bwd_sorted``: ``d_pre [E, H*F]`` (in ``hj``'s type) and ``datt``
  from ``ds [E, H]``. Reads ``hj``, each receiver row once a piece, and
  writes ``d_pre``. It walks the same pieces as the score kernel, save
  that a row longer than one piece (the padded tail, a hub) is cut into
  pieces of ``BWD_SPLIT_PIECE`` slots: its slots are independent, so those
  pieces run side by side in short chains (at CiteSeer's shapes, where the
  tail's 32-slot chains set the walk's time, it took 0.0108 -> 0.0075 ms
  on an H100, PERF.md). A group
  per (piece, head) holds the receiver row's and ``att``'s columns in
  registers, stages the piece's ``ds`` in shared memory and streams the
  piece's contiguous ``hj`` rows through a ``cp.async`` ring of eight
  stages, storing each slot's ``d_pre`` from registers. ``datt`` goes
  through per-group partials summed in group order into one row per block
  and a second small kernel that sums those rows in a fixed order: no
  atomics, so it is bit-reproducible.
- ``sddmm_stats_sorted``: scores ``[E, H]`` f32 (``-inf`` on invalid slots)
  and the per-receiver online ``(m, l)`` in one pass over the receiver-sorted
  slots, the sender rows gathered in the kernel. Reads the node rows and the
  sender and validity streams, writes the scores and ``[N, H]`` twice. It
  walks the fused forward's (``attend_cuda.sddmm_stats_agg_sorted``'s) work
  the same way: the pieces of :func:`spmm_cuda.recv_bwd_work` of
  ``row_ptr``, a sub-warp group per (piece, head) with the piece's senders
  and validity staged in shared memory and a ``cp.async`` ring of sender
  rows (a padded slot is never gathered), each piece folded in slot order
  with the forward's online step and a split row's pieces merged in piece
  order by a second launch with the forward's merge. So its scores, ``m``
  and ``l`` are the one-pass forward's bit for bit on every row, hubs and
  the padded tail included (the same score, online-step and merge
  functions, ``csrc/lanes.cuh`` and ``csrc/recv_pieces.cuh``).

A wrapper takes the plain version only for a tensor that lies on the CPU. For
a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .attend_cuda import (
    _aligned,
    _check_graph,
    _check_like,
    _fix_args,
    _scalar_matrix_arg,
    _shares,
    _work_args,
    scores_and_stats_plain,
)
from .spmm_cuda import (
    SPLIT_PIECE,
    _check_data,
    _check_index,
    _mask_arg,
    _raise_on_error,
    _row_ptr_or_raise,
    recv_bwd_work,
)

__all__ = [
    "sddmm_scores_sorted",
    "sddmm_bwd_sorted",
    "sddmm_stats_sorted",
    "sddmm_scores_sorted_plain",
    "sddmm_bwd_sorted_plain",
    "sddmm_stats_sorted_plain",
    "BWD_SPLIT_PIECE",
    "LAUNCH_COUNTS",
    "reset_launch_counts",
]

# Slots of a piece of a row longer than RECV_BWD_PIECE in the score
# backward's work list (the messages-form scatter's list too).
BWD_SPLIT_PIECE = SPLIT_PIECE

# One plain integer per kernel entry, incremented where the kernel is
# launched and nowhere else.
LAUNCH_COUNTS = {
    "sddmm_scores_sorted": 0,
    "sddmm_bwd_sorted": 0,
    "sddmm_stats_sorted": 0,
}


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


# ---------------------------------------------------------------------------
# Plain PyTorch versions: the same functions with library ops, f32 inside,
# rounded once. Used for CPU tensors and as the yardstick the kernels are
# held against on the card.
# ---------------------------------------------------------------------------


def _pre(ht, hj, att, receivers):
    e = hj.shape[0]
    heads, f = att.shape
    hi = ht.float().index_select(0, receivers.long())
    return (hi + hj.float()).view(e, heads, f)


def sddmm_scores_sorted_plain(ht, hj, att, receivers, *,
                              negative_slope=0.2):
    pre = _pre(ht, hj, att, receivers)
    z = torch.where(pre > 0, pre, negative_slope * pre)
    return (z * att.float()[None]).sum(-1)


def sddmm_bwd_sorted_plain(ht, hj, att, dscores, receivers, *,
                           negative_slope=0.2):
    pre = _pre(ht, hj, att, receivers)
    pos = pre > 0
    ds = dscores.float()[:, :, None]
    d_pre = ds * att.float()[None] * torch.where(pos, 1.0, negative_slope)
    z = torch.where(pos, pre, negative_slope * pre)
    datt = (z * ds).sum(0)
    return d_pre.reshape(hj.shape).to(hj.dtype), datt.to(att.dtype)


def sddmm_stats_sorted_plain(ht, senders, receivers, row_ptr, att, *,
                             edge_valid=None, negative_slope=0.2):
    del row_ptr
    _, scores, m, l, _ = scores_and_stats_plain(
        ht, senders, receivers, att, negative_slope, edge_valid)
    return scores, m, l


# ---------------------------------------------------------------------------
# Kernel launches.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _build.load_library("sddmm")
    vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                         ctypes.c_float)
    lib.kgt_sddmm_scores_sorted.argtypes = [
        vp, vp, vp, i64, i32, vp, i32, vp, i64, i32, i64, f32, i32, vp,
    ]
    lib.kgt_sddmm_scores_sorted.restype = i32
    lib.kgt_sddmm_bwd_partial_rows.argtypes = [vp, vp, vp, i64, i32, i64, i32]
    lib.kgt_sddmm_bwd_partial_rows.restype = i64
    lib.kgt_sddmm_bwd_sorted.argtypes = [
        vp, vp, vp, i64, i32, vp, i32, vp, vp, vp, vp, i64, i32, i64, f32,
        i32, vp,
    ]
    lib.kgt_sddmm_bwd_sorted.restype = i32
    lib.kgt_sddmm_stats_sorted.argtypes = [
        vp, vp, vp, i64, i32, vp, i32, vp, vp, vp, vp, vp, vp, vp, vp, i64,
        i64, i32, i64, f32, i32, vp,
    ]
    lib.kgt_sddmm_stats_sorted.restype = i32
    lib.kgt_cuda_error_string.argtypes = [i32]
    lib.kgt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_operands(ht, hj, att, receivers):
    """Shared checks; returns ``(heads, f, num_slots)``."""
    _check_data("ht", ht)
    _check_data("hj", hj)
    if hj.dtype != ht.dtype:
        raise TypeError(f"hj must be {ht.dtype} like ht, got {hj.dtype}")
    if hj.device != ht.device:
        raise ValueError(f"hj lies on {hj.device}, ht on {ht.device}")
    d = ht.shape[1]
    if hj.shape[1] != d:
        raise ValueError(f"hj must be [E, {d}], got {tuple(hj.shape)}")
    if att.ndim != 2 or att.shape[0] * att.shape[1] != d:
        raise ValueError(
            f"att must be [H, F] with H*F = {d}, got {tuple(att.shape)}")
    heads, f = att.shape
    e = hj.shape[0]
    if e * heads >= 2**31:
        raise ValueError("E*H must stay below 2**31 (int32 indices)")
    _check_index("receivers", receivers, e, ht.device)
    return heads, f, e


def sddmm_scores_sorted(ht, hj, att, receivers, *, negative_slope=0.2,
                        row_ptr=None):
    """GATv2 scores ``[E, H]`` f32 over receiver-sorted slots.

    ``ht`` ``[N, H*F]`` and ``hj`` ``[E, H*F]`` (both f32 or both bf16),
    ``att`` ``[H, F]`` (f32 or bf16), ``receivers`` ``[E]`` int32 (the rows
    of ``ht`` each slot adds to its sender row), sorted, and ``row_ptr``
    ``[N+1]`` its row pointers (``row_ptr[0] == 0``, ``row_ptr[N] == E``):
    required for a CUDA tensor, whose kernel walks their pieces (the plain
    version, which a CPU tensor takes, does not read it). Padded slots are
    computed like any other; the caller masks them. Not differentiable by
    itself; ``GraphContext.sddmm_scores`` wraps it with its backward.
    """
    if not ht.is_cuda:
        return sddmm_scores_sorted_plain(ht, hj, att, receivers,
                                         negative_slope=negative_slope)
    n = ht.shape[0]
    row_ptr = _row_ptr_or_raise(ht, receivers, n, row_ptr)
    device = ht.device
    heads, f, e = _check_operands(ht, hj, att, receivers)
    _check_index("row_ptr", row_ptr, n + 1, device)
    att_ptr, att_bf16 = _scalar_matrix_arg("att", att, (heads, f), device)
    ht, hj = _aligned(ht), _aligned(hj)
    scores = torch.empty(e, heads, dtype=torch.float32, device=device)
    if hj.numel() == 0:
        return scores
    lib = _library()
    work = recv_bwd_work(row_ptr)
    with torch.cuda.device(device):
        code = lib.kgt_sddmm_scores_sorted(
            ht.data_ptr(), hj.data_ptr(), work.pieces.data_ptr(),
            work.num_pieces, work.piece, att_ptr, att_bf16,
            scores.data_ptr(), n, heads, f, float(negative_slope),
            int(ht.dtype == torch.bfloat16),
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on_error(lib, code, "sddmm_scores_sorted")
    LAUNCH_COUNTS["sddmm_scores_sorted"] += 1
    return scores


def sddmm_bwd_sorted(ht, hj, att, dscores, receivers, *, negative_slope=0.2,
                     row_ptr=None):
    """Backward of :func:`sddmm_scores_sorted` with respect to the
    pre-activation and ``att``: returns ``(d_pre [E, H*F] in hj's type,
    datt [H, F] in att's type)``. ``dscores`` is ``[E, H]`` f32. ``d_pre`` is
    the cotangent of both endpoints' rows: the caller returns it as ``d hj``
    and sums it by receiver for ``d ht``. ``row_ptr`` ``[N+1]`` (the row
    pointers of the sorted ``receivers``) is required for a CUDA tensor,
    whose kernel walks their pieces; the plain version, which a CPU tensor
    takes, does not read it.
    """
    if not ht.is_cuda:
        return sddmm_bwd_sorted_plain(ht, hj, att, dscores, receivers,
                                      negative_slope=negative_slope)
    n = ht.shape[0]
    row_ptr = _row_ptr_or_raise(ht, receivers, n, row_ptr)
    device = ht.device
    heads, f, e = _check_operands(ht, hj, att, receivers)
    _check_index("row_ptr", row_ptr, n + 1, device)
    att_ptr, att_bf16 = _scalar_matrix_arg("att", att, (heads, f), device)
    _check_like("dscores", dscores, (e, heads), torch.float32, device)
    d_pre = torch.empty_like(hj)
    datt = torch.empty(heads, f, dtype=torch.float32, device=device)
    if hj.numel() == 0:
        return d_pre, datt.zero_().to(att.dtype)
    lib = _library()
    work = recv_bwd_work(row_ptr, split_piece=BWD_SPLIT_PIECE)
    is_bf16 = int(ht.dtype == torch.bfloat16)
    with torch.cuda.device(device):
        partial_rows = lib.kgt_sddmm_bwd_partial_rows(
            ht.data_ptr(), hj.data_ptr(), d_pre.data_ptr(), work.num_pieces,
            heads, f, is_bf16)
        partial = torch.empty(partial_rows, heads * f, dtype=torch.float32,
                              device=device)
        code = lib.kgt_sddmm_bwd_sorted(
            ht.data_ptr(), hj.data_ptr(), work.pieces.data_ptr(),
            work.num_pieces, work.piece, att_ptr, att_bf16,
            dscores.data_ptr(), d_pre.data_ptr(), datt.data_ptr(),
            partial.data_ptr(), n, heads, f, float(negative_slope), is_bf16,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on_error(lib, code, "sddmm_bwd_sorted")
    LAUNCH_COUNTS["sddmm_bwd_sorted"] += 1
    return d_pre, datt.to(att.dtype)


def sddmm_stats_sorted(ht, senders, receivers, row_ptr, att, *,
                       edge_valid=None, negative_slope=0.2):
    """GATv2 scores and the per-receiver softmax statistics in one pass.

    ``ht`` ``[N, H*F]`` (f32 or bf16), ``senders``/``receivers`` ``[E]`` int32
    with ``receivers`` sorted and ``row_ptr`` ``[N+1]`` its row pointers,
    ``att`` ``[H, F]``, ``edge_valid`` ``[E]`` bool (False on padded slots).
    Returns ``(scores [E, H] f32 with -inf on invalid slots, m [N, H] f32,
    l [N, H] f32)``: ``m`` is the row's max score (0 for a row without a
    finite one) and ``l = sum exp(scores - m)``. A CUDA tensor's kernel
    walks the pieces of ``row_ptr`` (the plain version, which a CPU tensor
    takes, reads ``receivers``). With
    ``attend_cuda.attend_aggregate_sorted`` it is the two-pass form of
    ``attend_cuda.sddmm_stats_agg_sorted``; not differentiable by itself.
    """
    if not ht.is_cuda:
        return sddmm_stats_sorted_plain(ht, senders, receivers, row_ptr, att,
                                        edge_valid=edge_valid,
                                        negative_slope=negative_slope)
    device = ht.device
    n, heads, f, e = _check_graph(ht, senders, row_ptr, att)
    att_ptr, att_bf16 = _scalar_matrix_arg("att", att, (heads, f), device)
    valid_ptr = _mask_arg(edge_valid, e, device)
    ht = _aligned(ht)
    scores = torch.empty(e, heads, dtype=torch.float32, device=device)
    m = torch.empty(n, heads, dtype=torch.float32, device=device)
    l = torch.empty(n, heads, dtype=torch.float32, device=device)
    if ht.numel() == 0:
        return scores, m, l
    lib = _library()
    work = recv_bwd_work(row_ptr)
    # The split rows' shares: m_p and l_p [num_shares, H].
    shares = _shares(work, 2 * heads, device)
    m_part = l_part = None
    if shares is not None:
        m_part, l_part = (t.data_ptr() for t in shares.chunk(2))
    with torch.cuda.device(device):
        code = lib.kgt_sddmm_stats_sorted(
            ht.data_ptr(), senders.data_ptr(), *_work_args(work), att_ptr,
            att_bf16, valid_ptr, scores.data_ptr(), m.data_ptr(),
            l.data_ptr(), m_part, l_part, *_fix_args(work), n, heads, f,
            float(negative_slope), int(ht.dtype == torch.bfloat16),
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on_error(lib, code, "sddmm_stats_sorted")
    LAUNCH_COUNTS["sddmm_stats_sorted"] += 1
    return scores, m, l
