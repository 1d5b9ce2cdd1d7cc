"""Sorted-CSR SpMM on Hopper: scatter-sum, its fused-gather form, and expand.

Counterpart of the JAX package's ``kernels/spmm_pallas.py`` for
:func:`scatter_sum_sorted` and :func:`expand_sorted`. The kernels are CUDA C++
(``csrc/spmm.cu``, built by ``_build.py`` at first use); this module holds
their wrappers, their plain PyTorch versions, their launch counters and the
autograd wiring (each one's backward is the other, with the same weights).

Source notes, one per kernel:

- ``scatter_sum_sorted`` (messages form) replaces ``_scatter_impl`` /
  ``_scatter_block_impl``. Bound by bytes (``E*F`` message values read once,
  ``N*F`` written, ``E`` weights, ``N`` row pointers). It walks the pieces of
  ``recv_bwd_work(row_ptr, split_piece=SPLIT_PIECE)`` (a row of at most
  ``RECV_BWD_PIECE`` slots whole, a longer one in pieces of ``SPLIT_PIECE``:
  the score backward's list, kept on the same ``row_ptr``), one thread per
  (piece, 16-byte column pack), each streaming its column of the piece's
  contiguous block of messages with eight slots' loads in flight and adding
  ``w * message`` rounded to f32 in slot order; a whole row is rounded once
  at the store (a serial walk's bits). A split row's f32 shares are added in
  piece order, in the same launch, by the piece that draws the row's last
  arrival ticket (int tickets kept zeroed on ``row_ptr``, no float atomics).
- ``gather_scatter_sum_sorted`` (fused-gather form of the same kernel) replaces
  the ``jnp.take`` + scatter pair inside ``_spmm_symmetric``/``_spmm_general``:
  message ``e`` is ``h[idx[e]]`` read inside the kernel, so the ``[E, F]``
  array never reaches device memory. Bound by bytes: the node array once, the
  output once, index and weight streams; the random row reads are served by L2
  when the node array fits there. It walks pieces of at most
  ``RECV_BWD_PIECE`` slots (:func:`recv_bwd_work`, the attention kernels'
  work list, kept on the ``row_ptr`` tensor), so no sub-warp walks a long row
  (a hub, or the padded tail that piles into the last sender row) serially:
  each piece's indices and weights are staged in shared memory, the next
  eight gathered rows kept in flight in a ``cp.async`` ring and summed in
  f32 in slot order; a split row's f32 shares are added in piece order by a
  second launch, which applies the diagonal epilogue and rounds once.
  ``pieces=False`` takes the row walk (a sub-warp per row), which gives the
  same bits on every row that is one piece; the GCN's operator takes it
  (``ops/csr.py``).
- ``expand_sorted`` replaces ``_expand_impl``: ``out[e] = rows[recv[e]]*w[e]``,
  threads on the flat (edge, 16-byte column pack) index of the contiguous
  ``[E, F]`` output (every warp stores 32 neighbouring packs at any F), 16
  bytes of output a thread. Bound by the ``E*F`` write.
- ``segment_max_sorted`` (``csrc/segment_max.cu``) replaces
  ``segment_max_sorted``'s ``_segment_max_kernel``: the per-row max of narrow
  ``[E, K]`` scores, ``-inf`` for a row without an unmasked slot, no VJP. Bound
  by bytes (the scores once, ``[N, K]`` written). It walks the messages
  form's list (``recv_bwd_work(row_ptr, split_piece=SPLIT_PIECE)``), one
  thread per (piece, pack of up to 16 bytes of a slot's heads), eight slots'
  packs and mask bytes loaded at once; a split row's f32 shares are merged
  in the same launch by the warp of the piece that draws the row's last
  ticket (the tickets kept on ``row_ptr``, shared with the scatter). Every
  row equals a serial walk's max, bit for bit.
- ``segment_max_wide_raw`` / ``segment_max_wide_sorted`` (same source)
  replace ``_segment_max_wide_kernel`` and its custom VJP: the per-row max
  of wide ``[E, F]`` messages into ``[N, F]`` f32 (the ``-1e30`` sentinel on
  an empty row, 0 with ``empty_to_zero``), and a backward kernel that routes
  the cotangent to the elements equal to their row's max. Bound by bytes (the
  messages read once forward, read and written once backward). A sub-warp per
  row lies across the columns as in the scatter; the TPU's max-scan and
  one-hot select have no counterpart. The public function gives every tied
  element the whole cotangent, the JAX package's kernel rule; the layers use
  ``_segment_max_sorted_split``, whose backward (the same kernel with a
  template flag) splits it evenly among the ties, as XLA's ``segment_max``
  does.

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

__all__ = [
    "scatter_sum_sorted",
    "expand_sorted",
    "gather_scatter_sum_sorted",
    "scatter_sum_sorted_plain",
    "gather_scatter_sum_sorted_plain",
    "expand_sorted_plain",
    "segment_max_sorted",
    "segment_max_wide_raw",
    "segment_max_wide_sorted",
    "segment_max_sorted_plain",
    "segment_max_wide_raw_plain",
    "segment_max_wide_bwd_plain",
    "row_ptr_from_sorted",
    "RECV_BWD_PIECE",
    "SPLIT_PIECE",
    "RecvBwdWork",
    "recv_bwd_work",
    "LAUNCH_COUNTS",
    "MODE_LAUNCH_COUNTS",
    "reset_launch_counts",
]

# One plain integer per kernel entry, incremented where the kernel is
# launched and nowhere else.
LAUNCH_COUNTS = {
    "scatter_sum_sorted": 0,
    "gather_scatter_sum_sorted": 0,
    "expand_sorted": 0,
    "segment_max_sorted": 0,
    "segment_max_wide_sorted": 0,
    "segment_max_wide_bwd": 0,
}

# Launches of the wide segment max's backward with the ties split evenly (the
# layers' rule), and of the fused-gather form's row walk (``pieces=False``),
# counted beside (not instead of) the kernel's own count.
MODE_LAUNCH_COUNTS = {"segment_max_wide_bwd(ties_split)": 0,
                      "gather_scatter_sum_sorted(rows)": 0}

# Where the wide segment max leaves a row without an unmasked slot (the JAX
# package's finite stand-in for -inf).
NEG_SENTINEL = -1e30

_DATA_DTYPES = (torch.float32, torch.bfloat16)


def reset_launch_counts() -> None:
    for counts in (LAUNCH_COUNTS, MODE_LAUNCH_COUNTS):
        for name in counts:
            counts[name] = 0


def row_ptr_from_sorted(receivers: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """``[N+1]`` int32 row pointers of a sorted index vector on the CPU.

    ``row_ptr[r]:row_ptr[r+1]`` spans the entries equal to ``r``; entries
    beyond the last node fall outside every row. Raises when the vector is
    not sorted. A host helper: for tensors on the card graph preparation
    supplies ``row_ptr``.
    """
    if receivers.is_cuda:
        raise ValueError(
            "row_ptr_from_sorted runs on the host; for CUDA tensors pass the "
            "row_ptr that graph preparation built"
        )
    recv = receivers.detach().numpy()
    if recv.size and not np.all(recv[1:] >= recv[:-1]):
        raise ValueError("receivers must be sorted (receiver-major CSR)")
    row_ptr = np.searchsorted(recv, np.arange(num_nodes + 1), side="left")
    return torch.from_numpy(row_ptr.astype(np.int32))


# ---------------------------------------------------------------------------
# The work list of the kernels that walk pieces: the fused-gather form here,
# and the attention's forward, rho and both backwards (attend_cuda).
# ---------------------------------------------------------------------------

# Slots a group of those kernels walks at most.
RECV_BWD_PIECE = 32
# The pieces of a longer row in the lists of the kernels whose slots are
# independent: the messages-form scatter's, the narrow segment max's and the
# score backward's (``sddmm_cuda.BWD_SPLIT_PIECE``), one list on a
# ``row_ptr``.
SPLIT_PIECE = 8


@dataclasses.dataclass(frozen=True)
class RecvBwdWork:
    """Pieces of a sorted stream (receiver- or sender-sorted) for the kernels
    that walk them.

    ``pieces`` ``[P, 4]`` int32: (row, first slot, end slot, share), in row
    and slot order; every row has at least one piece (an empty row one empty
    piece) and every slot lies in exactly one, of at most ``piece`` slots.
    ``share`` is -1 where the piece is its whole row, else its row in the
    ``[num_shares, D]`` f32 scratch of shares. ``fix_rows`` ``[R]`` int32 are
    the rows split into several pieces, in order, and their shares are
    ``fix_ptr[k] .. fix_ptr[k + 1]`` (``[R + 1]`` int32), in slot order.
    """

    pieces: torch.Tensor
    fix_rows: torch.Tensor
    fix_ptr: torch.Tensor
    piece: int
    num_shares: int

    @property
    def num_pieces(self) -> int:
        return int(self.pieces.shape[0])


def _build_recv_bwd_work(row_ptr: torch.Tensor, piece: int,
                         split_piece: int | None = None) -> RecvBwdWork:
    rp = row_ptr.long()
    lengths = rp[1:] - rp[:-1]
    size = torch.full_like(lengths, piece)
    if split_piece is not None:  # rows longer than a piece: shorter pieces
        size = torch.where(lengths > piece, split_piece, size)
    counts = torch.clamp((lengths + size - 1) // size, min=1)
    total = int(counts.sum())
    n = lengths.shape[0]
    row = torch.repeat_interleave(torch.arange(n, device=rp.device), counts,
                                  output_size=total)
    first = torch.cumsum(counts, 0) - counts  # each row's first piece
    k = torch.arange(total, device=rp.device) - first[row]
    lo = rp[row] + k * size[row]
    hi = torch.minimum(lo + size[row], rp[row + 1])
    split = counts[row] > 1
    share = torch.where(split, torch.cumsum(split.long(), 0) - 1, -1)
    pieces = torch.stack([row, lo, hi, share], 1).to(torch.int32).contiguous()
    fix_rows = torch.nonzero(counts > 1).flatten()
    fix_ptr = torch.zeros(fix_rows.shape[0] + 1, dtype=torch.long,
                          device=rp.device)
    fix_ptr[1:] = torch.cumsum(counts[fix_rows], 0)
    return RecvBwdWork(pieces=pieces, fix_rows=fix_rows.to(torch.int32),
                       fix_ptr=fix_ptr.to(torch.int32), piece=piece,
                       num_shares=int(split.sum()))


def recv_bwd_work(row_ptr: torch.Tensor, piece: int = RECV_BWD_PIECE, *,
                  split_piece: int | None = None) -> RecvBwdWork:
    """The pieces for ``row_ptr`` (``[N + 1]``), on its device, that the
    kernels walk: ``row_ptr`` over the receiver-sorted stream for the
    attention's forward, rho and receiver backward, ``row_ptr_bwd`` over the
    sender-sorted one for its sender backward and the finish, and either for
    the fused-gather scatter. ``split_piece`` (at most ``piece``): a row
    longer than ``piece`` slots is cut into pieces of that many slots
    instead, for a kernel whose slots are independent, so that a long row's
    pieces run side by side in short chains (the score backward's). Built
    once per ``row_ptr`` tensor and list (one host synchronisation, at its
    first use) and kept on the tensor while it is not written to."""
    if piece < 1:
        raise ValueError(f"piece must be >= 1, got {piece}")
    if split_piece is not None and not 1 <= split_piece <= piece:
        raise ValueError(f"split_piece must lie in [1, {piece}], got "
                         f"{split_piece}")
    kept = getattr(row_ptr, "_recv_bwd_work", None)
    if kept is None:
        kept = row_ptr._recv_bwd_work = {}
    cached = kept.get((piece, split_piece))
    if cached is not None and cached[0] == row_ptr._version:
        return cached[1]
    work = _build_recv_bwd_work(row_ptr, piece, split_piece)
    kept[(piece, split_piece)] = (row_ptr._version, work)
    return work


def _row_ptr_or_raise(data, receivers, num_nodes, row_ptr):
    """The sortedness contract: a CUDA tensor comes with its ``row_ptr``; for
    a CPU tensor it is derived (and the order checked) on the host."""
    if row_ptr is not None:
        return row_ptr
    if data.is_cuda:
        raise ValueError(
            "row_ptr is required for CUDA tensors (it is the sortedness "
            "contract of the kernel; graph preparation builds it)"
        )
    return row_ptr_from_sorted(receivers, num_nodes)


# ---------------------------------------------------------------------------
# Plain PyTorch versions: the same functions with library ops, accumulated in
# f32 and rounded once. Used for CPU tensors and as the yardstick the kernels
# are held against on the card.
# ---------------------------------------------------------------------------


def _weighted_f32(values, weights, mask):
    values = values.float()
    if weights is not None:
        values = values * weights.float()[:, None]
    if mask is not None:
        values = torch.where(mask[:, None], values, torch.zeros_like(values))
    return values


def scatter_sum_sorted_plain(messages, receivers, num_nodes, *, weights=None,
                             mask=None):
    vals = _weighted_f32(messages, weights, mask)
    out = torch.zeros(num_nodes, messages.shape[1], dtype=torch.float32,
                      device=messages.device)
    out.index_add_(0, receivers.long(), vals)
    return out.to(messages.dtype)


def gather_scatter_sum_sorted_plain(h, idx, receivers, num_nodes, *,
                                    weights=None, self_weight=None):
    vals = _weighted_f32(h.float().index_select(0, idx.long()), weights, None)
    out = torch.zeros(num_nodes, h.shape[1], dtype=torch.float32,
                      device=h.device)
    out.index_add_(0, receivers.long(), vals)
    if self_weight is not None:
        out = out + h.float()[:num_nodes] * self_weight.float()[:, None]
    return out.to(h.dtype)


def expand_sorted_plain(rows, receivers, *, weights=None, mask=None):
    vals = rows.float().index_select(0, receivers.long())
    return _weighted_f32(vals, weights, mask).to(rows.dtype)


# ---------------------------------------------------------------------------
# Kernel launches.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _build.load_library("spmm")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.kgt_scatter_sum_sorted.argtypes = [
        vp, vp, vp, vp, i32, vp, vp, i32, vp, i64, i64, i32, vp,
    ]
    lib.kgt_scatter_sum_sorted.restype = i32
    lib.kgt_scatter_messages.argtypes = [
        vp, vp, i64, i32, vp, i32, vp, vp, vp, vp, vp, i64, vp, i64, i64,
        i32, vp,
    ]
    lib.kgt_scatter_messages.restype = i32
    lib.kgt_gather_scatter_pieces.argtypes = [
        vp, vp, vp, i64, i32, vp, i32, vp, i32, vp, vp, vp, vp, i64, i64,
        i64, i32, vp,
    ]
    lib.kgt_gather_scatter_pieces.restype = i32
    lib.kgt_expand_sorted.argtypes = [
        vp, vp, vp, i32, vp, vp, i64, i64, i32, vp,
    ]
    lib.kgt_expand_sorted.restype = i32
    lib.kgt_cuda_error_string.argtypes = [i32]
    lib.kgt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_data(name, t):
    if t.dtype not in _DATA_DTYPES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if t.ndim != 2:
        raise ValueError(f"{name} must be [rows, F], got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_index(name, t, length, device):
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, data on {device}")
    if t.ndim != 1 or t.shape[0] != length or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous [{length}] vector, got "
            f"{tuple(t.shape)}"
        )


def _scalar_arg(name, t, length, device):
    """(pointer, is_bf16) of an optional per-edge / per-node scalar vector."""
    if t is None:
        return None, 0
    if t.dtype not in _DATA_DTYPES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, data on {device}")
    if t.ndim != 1 or t.shape[0] != length or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous [{length}] vector, got "
            f"{tuple(t.shape)}"
        )
    return t.data_ptr(), int(t.dtype == torch.bfloat16)


def _mask_arg(mask, length, device):
    if mask is None:
        return None
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")
    if mask.device != device:
        raise ValueError(f"mask lies on {mask.device}, data on {device}")
    if mask.ndim != 1 or mask.shape[0] != length or not mask.is_contiguous():
        raise ValueError(f"mask must be a contiguous [{length}] vector")
    return mask.data_ptr()


def _raise_on_error(lib, code, what):
    if code != 0:
        msg = lib.kgt_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({code}: {msg})")


def _launch_rows(h, idx, row_ptr, num_nodes, weights, self_weight):
    """The fused-gather form's row walk: a sub-warp per row."""
    device = h.device
    _check_data("source", h)
    _check_index("row_ptr", row_ptr, num_nodes + 1, device)
    num_edges = idx.shape[0]
    _check_index("idx", idx, num_edges, device)
    w_ptr, w_bf16 = _scalar_arg("weights", weights, num_edges, device)
    sw_ptr, sw_bf16 = _scalar_arg("self_weight", self_weight, num_nodes, device)
    if num_edges >= 2**31:
        raise ValueError("edge count must stay below 2**31 (int32 indices)")
    f = h.shape[1]
    out = torch.empty(num_nodes, f, dtype=h.dtype, device=device)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(device):
        code = lib.kgt_scatter_sum_sorted(
            h.data_ptr(), idx.data_ptr(), row_ptr.data_ptr(), w_ptr, w_bf16,
            None, sw_ptr, sw_bf16, out.data_ptr(), num_nodes, f,
            int(h.dtype == torch.bfloat16),
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on_error(lib, code, "gather_scatter_sum_sorted")
    LAUNCH_COUNTS["gather_scatter_sum_sorted"] += 1
    MODE_LAUNCH_COUNTS["gather_scatter_sum_sorted(rows)"] += 1
    return out


def _split_row_tickets(row_ptr, count):
    """At least ``count`` int32 zeros on ``row_ptr``'s device, kept on the
    tensor beside its work lists: the messages-form scatter's and the narrow
    segment max's arrival tickets (one per split row and column pack), which
    every launch leaves at zero.
    Calls over one ``row_ptr`` run in order on one stream, so one set
    serves them all."""
    tickets = getattr(row_ptr, "_split_row_tickets", None)
    if tickets is None or tickets.numel() < count:
        tickets = torch.zeros(max(count, 1), dtype=torch.int32,
                              device=row_ptr.device)
        row_ptr._split_row_tickets = tickets
    return tickets


def _launch_messages(src, row_ptr, num_nodes, weights, mask):
    """The messages form over the pieces of ``row_ptr`` (split rows in pieces
    of ``SPLIT_PIECE``), their shares merged in the same launch."""
    device = src.device
    _check_data("source", src)
    _check_index("row_ptr", row_ptr, num_nodes + 1, device)
    num_edges = src.shape[0]
    w_ptr, w_bf16 = _scalar_arg("weights", weights, num_edges, device)
    mask_ptr = _mask_arg(mask, num_edges, device)
    if num_edges >= 2**31:
        raise ValueError("edge count must stay below 2**31 (int32 indices)")
    f = src.shape[1]
    out = torch.empty(num_nodes, f, dtype=src.dtype, device=device)
    if out.numel() == 0:
        return out
    lib = _library()
    work = recv_bwd_work(row_ptr, split_piece=SPLIT_PIECE)
    n_fix = int(work.fix_rows.shape[0])
    part = tickets = None
    if n_fix:
        part = torch.empty(work.num_shares, f, dtype=torch.float32,
                           device=device)
        tickets = _split_row_tickets(row_ptr, n_fix * f)
    with torch.cuda.device(device):
        code = lib.kgt_scatter_messages(
            src.data_ptr(), work.pieces.data_ptr(), work.num_pieces,
            work.piece, w_ptr, w_bf16, mask_ptr, out.data_ptr(),
            None if part is None else part.data_ptr(),
            work.fix_rows.data_ptr(), work.fix_ptr.data_ptr(), n_fix,
            None if tickets is None else tickets.data_ptr(), num_nodes, f,
            int(src.dtype == torch.bfloat16),
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on_error(lib, code, "scatter_sum_sorted")
    LAUNCH_COUNTS["scatter_sum_sorted"] += 1
    return out


def _launch_gather_pieces(h, idx, row_ptr, num_nodes, weights, self_weight):
    """The fused-gather form over the pieces of ``row_ptr``: the piece walk,
    then the split rows' merge (one launch by the count)."""
    device = h.device
    _check_data("source", h)
    _check_index("row_ptr", row_ptr, num_nodes + 1, device)
    num_edges = idx.shape[0]
    _check_index("idx", idx, num_edges, device)
    w_ptr, w_bf16 = _scalar_arg("weights", weights, num_edges, device)
    sw_ptr, sw_bf16 = _scalar_arg("self_weight", self_weight, num_nodes,
                                  device)
    if num_edges >= 2**31:
        raise ValueError("edge count must stay below 2**31 (int32 indices)")
    f = h.shape[1]
    out = torch.empty(num_nodes, f, dtype=h.dtype, device=device)
    if out.numel() == 0:
        return out
    lib = _library()
    work = recv_bwd_work(row_ptr)
    part = None
    if work.num_shares:
        part = torch.empty(work.num_shares, f, dtype=torch.float32,
                           device=device)
    with torch.cuda.device(device):
        code = lib.kgt_gather_scatter_pieces(
            h.data_ptr(), idx.data_ptr(), work.pieces.data_ptr(),
            work.num_pieces, work.piece, w_ptr, w_bf16, sw_ptr, sw_bf16,
            out.data_ptr(), None if part is None else part.data_ptr(),
            work.fix_rows.data_ptr(), work.fix_ptr.data_ptr(),
            int(work.fix_rows.shape[0]), num_nodes, f,
            int(h.dtype == torch.bfloat16),
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on_error(lib, code, "gather_scatter_sum_sorted")
    LAUNCH_COUNTS["gather_scatter_sum_sorted"] += 1
    return out


def _scatter_raw(messages, receivers, row_ptr, num_nodes, weights, mask):
    if messages.shape[0] != receivers.shape[0]:
        raise ValueError(
            f"{messages.shape[0]} messages for {receivers.shape[0]} receivers"
        )
    if not messages.is_cuda:
        return scatter_sum_sorted_plain(
            messages, receivers, num_nodes, weights=weights, mask=mask
        )
    return _launch_messages(messages, row_ptr, num_nodes, weights, mask)


def gather_scatter_sum_sorted(h, idx, receivers, row_ptr, num_nodes, *,
                              weights=None, self_weight=None, pieces=True):
    """``out[r] = sum_{e: receivers[e]=r} weights[e]*h[idx[e]] (+ self_weight[r]*h[r])``.

    The fused-gather form of the sorted scatter: no ``[E, F]`` array is
    formed. ``receivers`` is sorted and ``row_ptr`` are its row pointers. On
    the card the kernel walks the pieces of :func:`recv_bwd_work` (built at
    the first call for a ``row_ptr`` tensor), or with ``pieces=False`` each
    row whole; the two agree bit for bit on a row of at most
    ``RECV_BWD_PIECE`` slots. Not differentiable by itself;
    ``GraphContext.spmm`` wraps it with its VJP.
    """
    if self_weight is not None and h.shape[0] < num_nodes:
        raise ValueError("self_weight needs one source row per output row")
    if not h.is_cuda:
        return gather_scatter_sum_sorted_plain(
            h, idx, receivers, num_nodes, weights=weights,
            self_weight=self_weight,
        )
    if pieces:
        return _launch_gather_pieces(h, idx, row_ptr, num_nodes, weights,
                                     self_weight)
    return _launch_rows(h, idx, row_ptr, num_nodes, weights, self_weight)


def _expand_raw(rows, receivers, weights, mask):
    if not rows.is_cuda:
        return expand_sorted_plain(rows, receivers, weights=weights, mask=mask)
    device = rows.device
    num_edges = receivers.shape[0]
    _check_data("rows", rows)
    _check_index("receivers", receivers, num_edges, device)
    w_ptr, w_bf16 = _scalar_arg("weights", weights, num_edges, device)
    mask_ptr = _mask_arg(mask, num_edges, device)
    f = rows.shape[1]
    out = torch.empty(num_edges, f, dtype=rows.dtype, device=device)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(device):
        code = lib.kgt_expand_sorted(
            rows.data_ptr(), receivers.data_ptr(), w_ptr, w_bf16, mask_ptr,
            out.data_ptr(), num_edges, f, int(rows.dtype == torch.bfloat16),
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on_error(lib, code, "expand_sorted")
    LAUNCH_COUNTS["expand_sorted"] += 1
    return out


# ---------------------------------------------------------------------------
# Autograd: scatter and expand are each other's transposes.
# ---------------------------------------------------------------------------


class _ScatterSumSorted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, messages, receivers, row_ptr, num_nodes, weights, mask):
        ctx.index = (receivers, row_ptr, weights, mask)
        return _scatter_raw(
            messages.contiguous(), receivers, row_ptr, num_nodes, weights, mask
        )

    @staticmethod
    def backward(ctx, g):
        receivers, row_ptr, weights, mask = ctx.index
        dmsg = _ExpandSorted.apply(g, receivers, row_ptr, weights, mask)
        return dmsg, None, None, None, None, None


class _ExpandSorted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, receivers, row_ptr, weights, mask):
        ctx.index = (receivers, row_ptr, weights, mask)
        ctx.num_nodes = rows.shape[0]
        return _expand_raw(rows.contiguous(), receivers, weights, mask)

    @staticmethod
    def backward(ctx, g):
        receivers, row_ptr, weights, mask = ctx.index
        drows = _ScatterSumSorted.apply(
            g, receivers, row_ptr, ctx.num_nodes, weights, mask
        )
        return drows, None, None, None, None


def scatter_sum_sorted(messages, receivers, num_nodes, *, mask=None,
                       row_ptr=None, weights=None):
    """Sum receiver-sorted ``[E, F]`` messages into ``[N, F]`` rows.

    ``row_ptr`` (``[N+1]`` int32, from graph preparation) is the sortedness
    contract the kernel relies on: required for CUDA tensors; for CPU tensors
    it is computed from ``receivers`` when absent, which raises if they are
    not sorted. ``weights`` (``[E]``)
    and ``mask`` (``[E]`` bool) are applied inside the kernel. The gradient
    with respect to ``messages`` is :func:`expand_sorted` with the same
    weights.
    """
    if messages.ndim != 2:
        raise ValueError(f"messages must be [E, F], got {tuple(messages.shape)}")
    row_ptr = _row_ptr_or_raise(messages, receivers, num_nodes, row_ptr)
    return _ScatterSumSorted.apply(
        messages, receivers, row_ptr, num_nodes, weights, mask
    )


def expand_sorted(rows, receivers, *, row_ptr=None, weights=None):
    """Sorted gather: ``out[e] = rows[receivers[e]] (* weights[e])``.

    The transpose of :func:`scatter_sum_sorted` and its gradient; its own
    gradient is that scatter over the same ``row_ptr`` (required for CUDA
    tensors, as for the scatter).
    """
    if rows.ndim != 2:
        raise ValueError(f"rows must be [N, F], got {tuple(rows.shape)}")
    row_ptr = _row_ptr_or_raise(rows, receivers, rows.shape[0], row_ptr)
    return _ExpandSorted.apply(rows, receivers, row_ptr, weights, None)


# ---------------------------------------------------------------------------
# Segment max over receiver-sorted streams (csrc/segment_max.cu): the narrow
# per-row max of attention-width scores, and the wide per-row max of message
# rows with its backward.
# ---------------------------------------------------------------------------


def _bool_mask(mask):
    """The slot mask as bool; the JAX package passes 1/0 floats as well."""
    if mask is None or mask.dtype == torch.bool:
        return mask
    return mask != 0


def _in_rows(values, receivers, num_nodes, mask, fill):
    """The slots of rows ``0 .. num_nodes-1`` (a kernel walks no other) and
    their rows, with masked slots' values set to ``fill``."""
    ids = receivers.long()
    if mask is not None:
        values = torch.where(mask[:, None], values,
                             torch.full_like(values, fill))
    keep = (ids >= 0) & (ids < num_nodes)
    return values[keep], ids[keep]


def _receivers_of(row_ptr, num_slots):
    """Each slot's row from the row pointers, on the host; slots past the
    last row get ``num_nodes`` (no row)."""
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    n = counts.shape[0]
    ids = torch.repeat_interleave(torch.arange(n, dtype=torch.int32), counts)
    tail = torch.full((num_slots - ids.shape[0],), n, dtype=torch.int32)
    return torch.cat([ids, tail])


def segment_max_sorted_plain(scores, receivers, num_nodes, *, mask=None):
    vals, ids = _in_rows(scores.float(), receivers, num_nodes, mask,
                         float("-inf"))
    out = torch.full((num_nodes, scores.shape[1]), float("-inf"),
                     dtype=torch.float32, device=scores.device)
    out = out.scatter_reduce(0, ids[:, None].expand_as(vals), vals, "amax")
    return out.to(scores.dtype)


def segment_max_wide_raw_plain(messages, receivers, num_nodes, *, mask=None,
                               empty_to_zero=False):
    vals, ids = _in_rows(messages.float(), receivers, num_nodes, mask,
                         NEG_SENTINEL)
    out = torch.full((num_nodes, messages.shape[1]), NEG_SENTINEL,
                     dtype=torch.float32, device=messages.device)
    out = out.scatter_reduce(0, ids[:, None].expand_as(vals), vals, "amax")
    if empty_to_zero:
        out = torch.where(out <= NEG_SENTINEL / 2, torch.zeros_like(out), out)
    return out


def segment_max_wide_bwd_plain(messages, maxv, g, receivers, num_nodes, *,
                               mask=None, ties_split=False):
    if num_nodes == 0:
        return torch.zeros_like(messages)
    ids = receivers.long()
    in_row = (ids >= 0) & (ids < num_nodes)
    rows = ids.clamp(0, num_nodes - 1)
    is_max = (messages.float() == maxv.float().index_select(0, rows))
    is_max &= in_row[:, None]
    if mask is not None:
        is_max &= mask[:, None]
    g = g.float()
    if ties_split:
        ties = torch.zeros_like(g).index_add_(0, rows, is_max.float())
        g = g / ties  # a column without a tie routes nothing
    dmsg = torch.where(is_max, g.index_select(0, rows), torch.zeros((), device=g.device))
    return dmsg.to(messages.dtype)


@functools.lru_cache(maxsize=1)
def _segment_max_library() -> ctypes.CDLL:
    lib = _build.load_library("segment_max")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.kgt_segment_max_sorted.argtypes = [
        vp, vp, i64, vp, vp, vp, vp, vp, i64, vp, i64, i32, i32, vp,
    ]
    lib.kgt_segment_max_sorted.restype = i32
    lib.kgt_segment_max_wide_sorted.argtypes = [
        vp, vp, vp, vp, i64, i64, i32, i32, vp,
    ]
    lib.kgt_segment_max_wide_sorted.restype = i32
    lib.kgt_segment_max_wide_bwd.argtypes = [
        vp, vp, vp, vp, vp, vp, i64, i64, i32, i32, vp,
    ]
    lib.kgt_segment_max_wide_bwd.restype = i32
    lib.kgt_cuda_error_string.argtypes = [i32]
    lib.kgt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_rows(name, t, shape, device):
    if t.dtype != torch.float32 or t.device != device or \
            tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous float32 {shape} tensor on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _segment_max_narrow(scores, receivers, row_ptr, num_nodes, mask):
    if not scores.is_cuda:
        return segment_max_sorted_plain(scores, receivers, num_nodes,
                                        mask=mask)
    device = scores.device
    _check_data("scores", scores)
    _check_index("row_ptr", row_ptr, num_nodes + 1, device)
    mask_ptr = _mask_arg(mask, scores.shape[0], device)
    k = scores.shape[1]
    out = torch.empty(num_nodes, k, dtype=scores.dtype, device=device)
    if out.numel() == 0:
        return out
    if scores.shape[0] == 0:  # no slot to walk: every row is empty
        return out.fill_(float("-inf"))
    lib = _segment_max_library()
    # The messages form's list: a split row's pieces run side by side.
    work = recv_bwd_work(row_ptr, split_piece=SPLIT_PIECE)
    n_fix = int(work.fix_rows.shape[0])
    part = tickets = None
    if n_fix:
        part = torch.empty(work.num_shares, k, dtype=torch.float32,
                           device=device)
        tickets = _split_row_tickets(row_ptr, n_fix * k)
    with torch.cuda.device(device):
        code = lib.kgt_segment_max_sorted(
            scores.data_ptr(), work.pieces.data_ptr(), work.num_pieces,
            mask_ptr, out.data_ptr(),
            None if part is None else part.data_ptr(),
            work.fix_rows.data_ptr(), work.fix_ptr.data_ptr(), n_fix,
            None if tickets is None else tickets.data_ptr(), num_nodes, k,
            int(scores.dtype == torch.bfloat16),
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on_error(lib, code, "segment_max_sorted")
    LAUNCH_COUNTS["segment_max_sorted"] += 1
    return out


def _segment_max_wide_fwd(messages, receivers, row_ptr, num_nodes, mask,
                          empty_to_zero):
    if not messages.is_cuda:
        return segment_max_wide_raw_plain(
            messages, receivers, num_nodes, mask=mask,
            empty_to_zero=empty_to_zero)
    device = messages.device
    _check_data("messages", messages)
    _check_index("row_ptr", row_ptr, num_nodes + 1, device)
    mask_ptr = _mask_arg(mask, messages.shape[0], device)
    f = messages.shape[1]
    out = torch.empty(num_nodes, f, dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    if messages.shape[0] == 0:  # no slot to walk: every row is empty
        return out.fill_(0.0 if empty_to_zero else NEG_SENTINEL)
    lib = _segment_max_library()
    with torch.cuda.device(device):
        code = lib.kgt_segment_max_wide_sorted(
            messages.data_ptr(), row_ptr.data_ptr(), mask_ptr, out.data_ptr(),
            num_nodes, f, int(empty_to_zero),
            int(messages.dtype == torch.bfloat16),
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on_error(lib, code, "segment_max_wide_sorted")
    LAUNCH_COUNTS["segment_max_wide_sorted"] += 1
    return out


def _segment_max_wide_bwd(messages, maxv, g, receivers, row_ptr, num_nodes,
                          mask, ties_split):
    if not messages.is_cuda:
        return segment_max_wide_bwd_plain(
            messages, maxv, g, receivers, num_nodes, mask=mask,
            ties_split=ties_split)
    device = messages.device
    _check_data("messages", messages)
    _check_index("row_ptr", row_ptr, num_nodes + 1, device)
    mask_ptr = _mask_arg(mask, messages.shape[0], device)
    f = messages.shape[1]
    _check_rows("the row max", maxv, (num_nodes, f), device)
    _check_rows("the cotangent", g, (num_nodes, f), device)
    dmsg = torch.empty_like(messages)
    if dmsg.numel() == 0 or num_nodes == 0:
        return dmsg.zero_()
    lib = _segment_max_library()
    with torch.cuda.device(device):
        code = lib.kgt_segment_max_wide_bwd(
            messages.data_ptr(), maxv.data_ptr(), g.data_ptr(),
            row_ptr.data_ptr(), mask_ptr, dmsg.data_ptr(), num_nodes, f,
            int(ties_split), int(messages.dtype == torch.bfloat16),
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on_error(lib, code, "segment_max_wide_bwd")
    LAUNCH_COUNTS["segment_max_wide_bwd"] += 1
    if ties_split:
        MODE_LAUNCH_COUNTS["segment_max_wide_bwd(ties_split)"] += 1
    return dmsg


class _SegmentMaxWide(torch.autograd.Function):
    """The wide segment max (f32 out) and its backward kernel; the cotangent
    goes to the elements equal to their row's max, whole or split evenly
    among a row's ties (``ties_split``)."""

    @staticmethod
    def forward(ctx, messages, receivers, row_ptr, num_nodes, mask,
                empty_to_zero, ties_split):
        messages = messages.contiguous()
        out = _segment_max_wide_fwd(messages, receivers, row_ptr, num_nodes,
                                    mask, empty_to_zero)
        ctx.save_for_backward(messages, out)
        ctx.index = (receivers, row_ptr, num_nodes, mask, ties_split)
        return out

    @staticmethod
    def backward(ctx, g):
        messages, out = ctx.saved_tensors
        receivers, row_ptr, num_nodes, mask, ties_split = ctx.index
        dmsg = _segment_max_wide_bwd(messages, out, g.float().contiguous(),
                                     receivers, row_ptr, num_nodes, mask,
                                     ties_split)
        return dmsg, None, None, None, None, None, None


def segment_max_sorted(scores, receivers, num_nodes, *, row_ptr=None,
                       mask=None):
    """Per-receiver max of narrow receiver-sorted ``[E, K]`` scores into
    ``[N, K]``, in the scores' type. A masked slot (``mask`` ``[E]``, bool or
    1/0) counts as ``-inf``; a row without an unmasked slot gives ``-inf``.
    ``row_ptr`` is required for CUDA tensors, as for the scatter. Not
    differentiable (the JAX package's kernel has no VJP either)."""
    if scores.ndim != 2:
        raise ValueError(f"scores must be [E, K], got {tuple(scores.shape)}")
    row_ptr = _row_ptr_or_raise(scores, receivers, num_nodes, row_ptr)
    return _segment_max_narrow(scores.contiguous(), receivers, row_ptr,
                               num_nodes, _bool_mask(mask))


def segment_max_wide_raw(messages, num_nodes, *, row_ptr, mask=None):
    """Per-row max of receiver-sorted ``[E, F]`` messages (f32 or bf16) into
    ``[N, F]`` f32, ``row_ptr`` ``[N+1]`` giving each row's slots; a row
    without an unmasked slot holds the ``-1e30`` sentinel. Not
    differentiable: :func:`segment_max_wide_sorted` is."""
    if messages.ndim != 2:
        raise ValueError(
            f"messages must be [E, F], got {tuple(messages.shape)}")
    receivers = None
    if not messages.is_cuda:
        receivers = _receivers_of(row_ptr, messages.shape[0])
    return _segment_max_wide_fwd(messages.contiguous(), receivers, row_ptr,
                                 num_nodes, _bool_mask(mask), False)


def segment_max_wide_sorted(messages, receivers, num_nodes, *, row_ptr=None,
                            mask=None, empty_to_zero=True):
    """Differentiable per-receiver max of wide receiver-sorted ``[E, F]``
    messages into ``[N, F]`` f32. Masked slots are skipped; an empty row is
    0, or the ``-1e30`` sentinel with ``empty_to_zero=False`` (partial maxes
    of split streams then combine with ``torch.maximum``). The backward is
    the JAX package's kernel rule: every unmasked element equal to its row's
    max receives the row's whole cotangent, ties included."""
    if messages.ndim != 2:
        raise ValueError(
            f"messages must be [E, F], got {tuple(messages.shape)}")
    row_ptr = _row_ptr_or_raise(messages, receivers, num_nodes, row_ptr)
    return _SegmentMaxWide.apply(messages, receivers, row_ptr, num_nodes,
                                 _bool_mask(mask), empty_to_zero, False)


def _segment_max_sorted_split(messages, receivers, num_nodes, *, row_ptr=None,
                              mask=None):
    """The layers' segment max: :func:`segment_max_wide_sorted` with empty
    rows at 0 and, in the backward, a row's cotangent split evenly among the
    elements tied at its max in each column (XLA's ``segment_max`` rule, and
    ``scatter_reduce``'s), counted by the same backward kernel."""
    row_ptr = _row_ptr_or_raise(messages, receivers, num_nodes, row_ptr)
    return _SegmentMaxWide.apply(messages, receivers, row_ptr, num_nodes,
                                 _bool_mask(mask), True, True)
