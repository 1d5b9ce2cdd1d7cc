"""The two-pass forward's aggregation (K10a,
``attend_cuda.attend_aggregate_sorted``) and the narrow segment max (K3,
``spmm_cuda.segment_max_sorted``) in their CUDA kernels' order, on the CPU,
against the JAX package.

K10a walks the pieces of rho's work list ``spmm_cuda.recv_bwd_work(row_ptr)``
(at most 32 slots of one row, every row at least one piece): each piece adds
``w * ht[sender]`` for its slots whose cached score is finite, in slot
order, with ``w = exp(s - m) / (l + eps) * keep`` and one fused
multiply-add a column; a piece that is its whole row stores it, rounded
once; a split row's pieces leave f32 shares that are added in piece order.
The numpy model below repeats that order and is held against the
reference's Pallas kernel in interpret mode, and bit for bit against a
walk of each whole row in slot order on every row whose finite scores lie
in one piece (the split rows' sums may differ in their last bits: ROADMAP
D15).

K3 walks the messages form's list ``recv_bwd_work(row_ptr,
split_piece=SPLIT_PIECE)`` (a longer row in pieces of 8), one thread per
(piece, pack of up to 16 bytes of a slot's heads) found from the flat index
by a multiply-high and a shift, blocks taking the list from its end; a
block copies the contiguous run of its pieces' slots into shared memory in
32 KB tiles, and each thread takes its piece's slots from the tiles; a
split row's shares are merged by a warp, 32 shares apart, then a butterfly.
Its index arithmetic (items, block runs, tiles, tickets) is held to cover
every (slot, head) once at K = 1, 4, 6 and 8 with aligned and unaligned
pointers, and its modelled max bit for bit against the Pallas kernel (a
max is exact in any order).

The stream has a 45-slot row, a 300-slot hub row, an empty row, a row whose
slots are all invalid (masked for K3) and a 40-slot padded tail.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from keras_geometric_tpu.kernels import attend_pallas, sddmm_pallas, spmm_pallas
from keras_geometric_tpu_torch.kernels import attend_cuda, spmm_cuda

torch.set_num_threads(1)

N, E_REAL, E = 48, 600, 640
ROW45, HUB, HUB_SLOTS = 7, 20, 300  # rows of more than one piece
EMPTY, DEAD = 3, 12  # a row without slots; a row whose slots are all invalid
PIECE = spmm_cuda.RECV_BWD_PIECE
SLOPE, EPS = 0.25, 1e-10
THREADS = 256  # lanes.cuh, kThreads
TILE_BYTES = 32 * 1024  # segment_max.cu, kTileBytes
SHARES_IN_FLIGHT = 8  # segment_max.cu, kSharesInFlight


def _stream(seed=0):
    """Receiver-sorted slots: ROW45 has 45, HUB 300, EMPTY none, DEAD 3
    invalid ones, the last row 40 padded slots after its 2 real ones;
    senders at random, the padded slots' the last row (as ``prepare_graph``
    pads)."""
    rng = np.random.default_rng(seed)
    others = np.setdiff1d(np.arange(N - 1), [ROW45, HUB, EMPTY, DEAD])
    rest = E_REAL - 45 - HUB_SLOTS - 3 - 2 - others.size
    recv = np.concatenate([
        np.full(45, ROW45), np.full(HUB_SLOTS, HUB), np.full(3, DEAD),
        others, rng.choice(others, rest), np.full(2, N - 1)])
    recv = np.sort(recv)
    recv = np.concatenate([recv, np.full(E - E_REAL, N - 1)]).astype(np.int32)
    row_ptr = np.searchsorted(recv, np.arange(N + 1)).astype(np.int32)
    lengths = np.diff(row_ptr)
    assert lengths[ROW45] == 45 and lengths[HUB] == HUB_SLOTS
    assert lengths[EMPTY] == 0 and lengths[DEAD] == 3
    assert lengths[N - 1] == 2 + E - E_REAL > PIECE
    send = rng.integers(0, N, E).astype(np.int32)
    send[E_REAL:] = N - 1
    valid = np.arange(E) < E_REAL
    valid[row_ptr[DEAD]:row_ptr[DEAD + 1]] = False
    tables = spmm_pallas.build_row_tables(recv, N, edge_chunk=128,
                                          row_block=32)
    return rng, recv, send, valid, row_ptr, tables


def _work(row_ptr, split_piece=None):
    return spmm_cuda.recv_bwd_work(torch.from_numpy(row_ptr),
                                   split_piece=split_piece)


# ---------------------------------------------------------------------------
# K10a
# ---------------------------------------------------------------------------


def _fma(a, b, c):
    """fmaf in f32: the product of two f32 values is exact in f64."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def _add_slot(o, s, m, denom, keep, hj):
    """One slot of a piece: o += w * hj per column (fused), w = exp(s - m) /
    denom * keep in f32, for the heads whose cached score is finite."""
    live = s > -np.inf
    with np.errstate(invalid="ignore", over="ignore"):
        ex = np.exp(s - m).astype(np.float32)
    w = ((ex / denom).astype(np.float32) * keep).astype(np.float32)
    w = np.where(live, w, np.float32(0))
    return np.where(live[:, None], _fma(w[:, None], hj, o), o)


def _k10a_model(scores, m, l, ht, send, keep, row_ptr, work):
    """K10a's output in its kernel's order over ``work``'s pieces (f32)."""
    n, d = ht.shape
    heads = m.shape[1]
    f = d // heads
    denom = (l + np.float32(EPS)).astype(np.float32)
    out = np.zeros((n, d), np.float32)
    shares = np.zeros((work.num_shares, d), np.float32)
    for row, lo, hi, share in work.pieces.numpy():
        o = np.zeros((heads, f), np.float32)
        for e in range(lo, hi):
            o = _add_slot(o, scores[e], m[row], denom[row], keep[e],
                          ht[send[e]].reshape(heads, f))
        if share < 0:
            out[row] = o.ravel()
        else:
            shares[share] = o.ravel()
    fix_ptr = work.fix_ptr.numpy()
    for k, row in enumerate(work.fix_rows.numpy()):
        acc = np.zeros(d, np.float32)
        for p in range(fix_ptr[k], fix_ptr[k + 1]):
            acc = (acc + shares[p]).astype(np.float32)
        out[row] = acc
    return out


def _serial_walk(scores, m, l, ht, send, keep, row_ptr):
    """Each whole row in slot order, with the same per-slot operations."""
    n, d = ht.shape
    heads = m.shape[1]
    denom = (l + np.float32(EPS)).astype(np.float32)
    out = np.zeros((n, d), np.float32)
    for row in range(n):
        o = np.zeros((heads, d // heads), np.float32)
        for e in range(row_ptr[row], row_ptr[row + 1]):
            o = _add_slot(o, scores[e], m[row], denom[row], keep[e],
                          ht[send[e]].reshape(heads, -1))
        out[row] = o.ravel()
    return out


def _round(x, dtype):
    """x rounded once to the data's type, back in f32."""
    if dtype == "float32":
        return x
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _k10a_inputs(heads, f, dtype, dropped, seed):
    rng, recv, send, valid, row_ptr, tables = _stream(seed)
    ht = _round((0.5 * rng.standard_normal((N, heads * f))).astype(
        np.float32), dtype)
    att = _round((0.3 * rng.standard_normal((heads, f))).astype(np.float32),
                 dtype)
    keep = np.ones((E, heads), np.float32)
    if dropped:
        keep = _round(np.where(rng.random((E, heads)) < 0.7, 1 / 0.7,
                               0.0).astype(np.float32), dtype)
    jt = jnp.dtype(dtype)
    ht_j = jnp.asarray(ht).astype(jt)
    with pltpu.force_tpu_interpret_mode():
        scores, m, l = sddmm_pallas.sddmm_stats_sorted(
            ht_j, jnp.take(ht_j, jnp.asarray(send), axis=0),
            jnp.asarray(att).astype(jt), tables=tables, num_nodes=N,
            edge_valid=jnp.asarray(valid), negative_slope=SLOPE)
    scores, m, l = (np.array(t, np.float32) for t in (scores, m, l))
    return dict(ht=ht, att=att, keep=keep, dropped=dropped, recv=recv,
                send=send, valid=valid, row_ptr=row_ptr, tables=tables,
                scores=scores, m=m[:N], l=l[:N])


def _lone_rows(c, work):
    """Rows whose finite scores all lie in one piece of ``work``."""
    pieces = work.pieces.numpy()
    finite = np.isfinite(c["scores"]).any(1)
    rows = []
    for row in range(N):
        mine = pieces[pieces[:, 0] == row]
        live = sum(bool(finite[lo:hi].any()) for _, lo, hi, _ in mine)
        if live <= 1:
            rows.append(row)
    return np.array(rows)


@pytest.mark.parametrize("dropped", [False, True], ids=["nodrop", "drop"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads,f", [(2, 8), (4, 4)])
def test_k10a_piece_order_matches_the_jax_kernel(heads, f, dtype, dropped):
    """(a) The model of K10a's order, rounded once to the data's type,
    against the Pallas kernel: f32 to 1e-4, bf16 to 2e-2 of the largest
    entry (ROADMAP D1 / D5); the empty and all-invalid rows are 0."""
    c = _k10a_inputs(heads, f, dtype, dropped, seed=heads + 10 * dropped)
    work = _work(c["row_ptr"])
    assert work.fix_rows.tolist() == [ROW45, HUB, N - 1]
    got = _round(_k10a_model(c["scores"], c["m"], c["l"], c["ht"],
                             c["send"], c["keep"], c["row_ptr"], work),
                 dtype)
    jt = jnp.dtype(dtype)
    ht_j = jnp.asarray(c["ht"]).astype(jt)
    with pltpu.force_tpu_interpret_mode():
        ref = attend_pallas.attend_aggregate_sorted(
            jnp.asarray(c["scores"]), jnp.asarray(c["m"]),
            jnp.asarray(c["l"]), jnp.take(ht_j, jnp.asarray(c["send"]),
                                          axis=0),
            tables=c["tables"], eps=EPS,
            drop_mask=(jnp.asarray(c["keep"]).astype(jt) if dropped
                       else None))
    ref = np.asarray(ref.astype(jnp.float32))[:N]
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got, ref, rtol=tol,
                               atol=tol * float(np.abs(ref).max()))
    assert not got[EMPTY].any() and not got[DEAD].any()
    assert np.abs(got[HUB]).max() > 0


@pytest.mark.parametrize("dropped", [False, True], ids=["nodrop", "drop"])
def test_k10a_one_piece_rows_are_a_serial_walk(dropped):
    """(b) On every row whose finite scores lie in one piece (rows of at most
    32 slots, and the padded tail, whose real slots come first) the piece
    order gives a serial slot-order walk's bits; the split rows with finite
    scores in several pieces differ by f32 rounding only."""
    c = _k10a_inputs(4, 4, "float32", dropped, seed=7)
    work = _work(c["row_ptr"])
    args = (c["scores"], c["m"], c["l"], c["ht"], c["send"], c["keep"],
            c["row_ptr"])
    pieces = _k10a_model(*args, work)
    serial = _serial_walk(*args)
    lone = _lone_rows(c, work)
    assert N - 1 in lone and ROW45 not in lone and HUB not in lone
    np.testing.assert_array_equal(pieces[lone], serial[lone])
    np.testing.assert_allclose(pieces, serial, rtol=1e-5,
                               atol=1e-6 * float(np.abs(serial).max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k10a_cpu_path_matches_the_model(dtype):
    """(c) The wrapper's CPU path (the plain version) on the same inputs
    agrees with the model of the kernel's order, with a dropout mask."""
    name = str(dtype)[6:]
    c = _k10a_inputs(2, 8, name, True, seed=3)
    work = _work(c["row_ptr"])
    model = _round(_k10a_model(c["scores"], c["m"], c["l"], c["ht"],
                               c["send"], c["keep"], c["row_ptr"], work),
                   name)
    out = attend_cuda.attend_aggregate_sorted(
        torch.from_numpy(c["scores"]), torch.from_numpy(c["m"]),
        torch.from_numpy(c["l"]), torch.from_numpy(c["ht"]).to(dtype),
        torch.from_numpy(c["send"]), torch.from_numpy(c["recv"]),
        torch.from_numpy(c["row_ptr"]), eps=EPS,
        drop_mask=torch.from_numpy(c["keep"]).to(dtype))
    assert out.dtype == dtype and out.shape == (N, 16)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    np.testing.assert_allclose(out.float().numpy(), model, rtol=tol,
                               atol=tol * float(np.abs(model).max()))


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------


def _fast_div(x, d):
    """make_fast_div / fast_div (csrc/fast_div.cuh) on numpy uint64."""
    if d == 1:
        return x
    log2 = (d - 1).bit_length()  # ceil(log2(d))
    mul = ((1 << (31 + log2)) + d - 1) // d
    assert mul < 1 << 32
    return ((x * np.uint64(mul)) >> np.uint64(32)) >> np.uint64(log2 - 1)


def _narrow_vec(k, size, scores_ptr, out_ptr, part_ptr):
    """kgt_segment_max_sorted's pack: pick_wide_vec (the widest of at most
    16 bytes that divides K, the scores' rows aligned to it and the output's
    as an f32 array's), narrowed until the shares' rows are aligned too."""
    vec = 16 // size
    while vec > 1 and (k % vec or scores_ptr % (vec * size)
                       or out_ptr % (vec * 4)):
        vec //= 2
    while vec > 1 and part_ptr % (vec * 4):
        vec //= 2
    return vec


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 4, 6, 8])
@pytest.mark.parametrize("aligned", [True, False])
def test_k3_index_arithmetic_covers_every_slot_and_head_once(k, dtype,
                                                             aligned):
    """(d) Thread t of block b serves item (blocks - 1 - b) * 256 + t (the
    list from its end); its piece item / chunks by a multiply-high and a
    shift, its pack c = item - piece * chunks, heads c * vec .. + vec of
    every slot of the piece. Integer division agrees, every (slot, head) of
    a row is covered once, each pack's bytes are aligned to it; the block's
    run of slots (its first item's piece's first slot to its last item's
    piece's end) holds every slot its threads read, and its tiles of
    32 KB / (pack bytes * chunks) slots hold every pack they index; the
    split rows' tickets k * chunks + c are distinct and in range."""
    _, _, _, _, row_ptr, _ = _stream(k)
    work = _work(row_ptr, spmm_cuda.SPLIT_PIECE)
    off = 0 if aligned else 1
    size = 2 if dtype == torch.bfloat16 else 4
    scores = torch.empty(E * k + off, dtype=dtype)[off:].view(E, k)
    out = torch.empty(N * k + off, dtype=dtype)[off:].view(N, k)
    part = torch.empty(work.num_shares * k, dtype=torch.float32)
    vec = _narrow_vec(k, size, scores.data_ptr(), out.data_ptr(),
                      part.data_ptr())
    widest = max(v for v in (8, 4, 2, 1) if k % v == 0 and v * size <= 16)
    assert vec == (widest if aligned else 1)
    chunks = k // vec
    n_items = work.num_pieces * chunks
    blocks = -(-n_items // THREADS)
    b, t = np.meshgrid(np.arange(blocks), np.arange(THREADS), indexing="ij")
    item = ((blocks - 1 - b) * THREADS + t).astype(np.uint64).ravel()
    item = item[item < n_items]
    assert np.unique(item).size == n_items
    p = _fast_div(item, chunks)
    np.testing.assert_array_equal(p, item // np.uint64(chunks))
    c = (item - p * np.uint64(chunks)).astype(np.int64)
    all_pieces = work.pieces.numpy()
    pieces = all_pieces[p.astype(np.int64)]
    tile_packs = TILE_BYTES // (vec * size)
    tile_slots = tile_packs // chunks
    assert tile_slots >= 1
    for blk in range(blocks):
        first = (blocks - 1 - blk) * THREADS
        last = min(first + THREADS, n_items) - 1
        run_lo = all_pieces[_fast_div(np.uint64(first), chunks)][1]
        run_hi = all_pieces[_fast_div(np.uint64(last), chunks)][2]
        mine = (item >= first) & (item <= last)
        assert (pieces[mine, 1] >= run_lo).all()
        assert (pieces[mine, 2] <= run_hi).all()
        for t0 in range(run_lo, run_hi, tile_slots):
            n_slots = min(run_hi - t0, tile_slots)
            for (_, lo, hi, _), cc in zip(pieces[mine], c[mine]):
                if max(lo, t0) < min(hi, t0 + n_slots):
                    top = (min(hi, t0 + n_slots) - 1 - t0) * chunks + cc
                    assert top < n_slots * chunks <= tile_packs
    covered = np.zeros((E, k), np.int64)
    for (row, lo, hi, _), first in zip(pieces, c * vec):
        assert row_ptr[row] <= lo <= hi <= row_ptr[row + 1]
        for e in range(lo, hi):
            covered[e, first:first + vec] += 1
            assert (scores.data_ptr() + (e * k + first) * size) % (
                vec * size) == 0
    assert (covered[:row_ptr[N]] == 1).all()
    split = pieces[:, 3] >= 0
    fix_rows = work.fix_rows.numpy()
    s_k = np.searchsorted(fix_rows, pieces[split, 0])
    np.testing.assert_array_equal(fix_rows[s_k], pieces[split, 0])
    tickets = s_k * chunks + c[split]
    assert tickets.max() < fix_rows.size * k
    assert np.unique(tickets).size == fix_rows.size * chunks


def _k3_model(scores, mask, row_ptr):
    """K3's maxes in its kernel's order: each piece's unmasked slots in slot
    order (tile by tile), a split row's shares merged by 32 lanes
    SHARES_IN_FLIGHT apart, then a butterfly."""
    work = _work(row_ptr, spmm_cuda.SPLIT_PIECE)
    n, k = row_ptr.shape[0] - 1, scores.shape[1]
    out = np.full((n, k), -np.inf, np.float32)
    shares = np.full((work.num_shares, k), -np.inf, np.float32)
    for row, lo, hi, share in work.pieces.numpy():
        acc = np.full(k, -np.inf, np.float32)
        for e in range(lo, hi):
            if mask is None or mask[e]:
                acc = np.fmax(acc, scores[e])
        if share < 0:
            out[row] = acc
        else:
            shares[share] = acc
    fix_ptr = work.fix_ptr.numpy()
    for i, row in enumerate(work.fix_rows.numpy()):
        first, stop = fix_ptr[i], fix_ptr[i + 1]
        lanes = np.full((32, k), -np.inf, np.float32)
        for lane in range(32):
            for s0 in range(first + lane, stop, 32 * SHARES_IN_FLIGHT):
                for u in range(SHARES_IN_FLIGHT):
                    if s0 + 32 * u < stop:
                        lanes[lane] = np.fmax(lanes[lane],
                                              shares[s0 + 32 * u])
        for off in (16, 8, 4, 2, 1):
            lanes = np.fmax(lanes, lanes[np.arange(32) ^ off])
        out[row] = lanes[0]
    return out


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 4, 8])
def test_k3_model_matches_the_jax_kernel_bit_for_bit(k, dtype, masked):
    """(e) The model of K3's order against the Pallas kernel, bit for bit:
    every row, the 300-slot hub and the padded tail included; the empty row
    and (masked) the all-masked row and the tail's padded slots are -inf;
    and the port's CPU path gives the same bits."""
    rng, recv, _, valid, row_ptr, tables = _stream(k)
    scores = _round(rng.standard_normal((E, k)).astype(np.float32), dtype)
    mask = valid if masked else None
    got = _k3_model(scores, mask, row_ptr)
    with pltpu.force_tpu_interpret_mode():
        want = spmm_pallas.segment_max_sorted(
            jnp.asarray(scores).astype(dtype), jnp.asarray(recv), N,
            tables=tables, mask=None if mask is None else jnp.asarray(mask))
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_array_equal(got, want)
    assert np.isinf(got[EMPTY]).all()
    if masked:
        assert np.isinf(got[DEAD]).all()
    cpu = spmm_cuda.segment_max_sorted(
        torch.from_numpy(scores).to(getattr(torch, dtype)),
        torch.from_numpy(recv), N, row_ptr=torch.from_numpy(row_ptr),
        mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(cpu.float().numpy(), got)
