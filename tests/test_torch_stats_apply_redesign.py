"""The two-pass forward's score-and-statistics kernel (K8,
``sddmm_cuda.sddmm_stats_sorted``) in its CUDA kernel's order, and the
normalisation (K6, ``softmax_cuda.softmax_apply_sorted``) in its kernel's
index arithmetic, on the CPU, against the JAX package.

K8 walks the pieces of ``spmm_cuda.recv_bwd_work(row_ptr)`` (at most 32
slots of one row, every row at least one piece), as the fused forward (K9)
does: each piece folds its finite scores in slot order with the online
step, a piece that is its whole row stores its ``(m, l)`` (``m`` 0 where no
score was finite), and a split row's pieces are merged in piece order with
K9's merge (the max of the pieces' ``m_p``, then ``l`` added piece by piece,
skipping a piece without a finite score). The model below repeats that
order in numpy f32 and is held against the reference's Pallas kernel run in
interpret mode, and bit for bit against the model of K9's order that
``tests/test_torch_kernel_redesign.py`` holds against K9's plain version,
on every row. The stream is ``tests/test_torch_softmax_sddmm_redesign.py``'s:
a 45-slot row, an empty row, a row whose slots are all invalid (its scores
all ``-inf``) and a 40-slot padded tail.

K6 lies on the flat (slot, pack) index, a pack being up to four
neighbouring heads, one pack a thread: its index arithmetic (a pack's slot
by a multiply-high and a shift, the scores' and alpha's offsets, the
receiver's ``(m, l)`` row) is held against integer division, every (slot,
head) is covered once, and the pack width follows the heads, the pointers'
alignment and the grid's size.

Inputs are multiples of 1/8 and the slope is 1/4, so every product and sum
of a score is exact in f32 and bf16 in any order: the scores and ``m`` are
held exactly. Tolerances: ``l`` 1e-5 (a different order of f32 sums of
exponentials, ROADMAP D1); alpha f32 1e-5, bf16 2e-2 of its largest entry
(ROADMAP D5: one rounding on each side).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from keras_geometric_tpu.kernels import sddmm_pallas, softmax_pallas, spmm_pallas
from keras_geometric_tpu_torch.kernels import sddmm_cuda, softmax_cuda, spmm_cuda
from test_torch_kernel_redesign import _piecewise_forward

torch.set_num_threads(1)

N, E_REAL, E = 40, 216, 256
HUB, HUB_SLOTS = 7, 45  # a row of more than one piece
EMPTY, DEAD = 3, 12  # a row without slots; a row whose slots are all invalid
PIECE = spmm_cuda.RECV_BWD_PIECE
SLOPE = 0.25
EPS = 1e-10
THREADS = 256  # lanes.cuh, kThreads


def _stream(seed=0):
    """``test_torch_softmax_sddmm_redesign._stream``: receiver-sorted slots,
    HUB has 45, EMPTY none, the last row 40 padded slots after its 2 real
    ones; senders at random, the padded slots' the last row (as
    ``prepare_graph`` pads), and the slots of DEAD and the padded tail
    invalid."""
    rng = np.random.default_rng(seed)
    others = np.setdiff1d(np.arange(N - 1), [HUB, EMPTY])
    recv = np.concatenate([
        np.full(HUB_SLOTS, HUB), others,
        rng.choice(others, E_REAL - HUB_SLOTS - others.size - 2),
        np.full(2, N - 1)])
    recv = np.sort(recv)
    recv = np.concatenate([recv, np.full(E - E_REAL, N - 1)]).astype(np.int32)
    row_ptr = np.searchsorted(recv, np.arange(N + 1)).astype(np.int32)
    assert row_ptr[HUB + 1] - row_ptr[HUB] == HUB_SLOTS > PIECE
    assert row_ptr[EMPTY] == row_ptr[EMPTY + 1]
    assert row_ptr[N] - row_ptr[N - 1] == 2 + E - E_REAL > PIECE
    assert row_ptr[DEAD + 1] > row_ptr[DEAD]
    send = rng.integers(0, N, E).astype(np.int32)
    send[E_REAL:] = N - 1
    valid = np.arange(E) < E_REAL
    valid[row_ptr[DEAD]:row_ptr[DEAD + 1]] = False
    tables = spmm_pallas.build_row_tables(recv, N, edge_chunk=128,
                                          row_block=32)
    return rng, recv, send, valid, row_ptr, tables


def _dyadic(rng, shape, top=16):
    """Multiples of 1/8 in [-top/8, top/8]: exact in bf16 and f32."""
    return (rng.integers(-top, top + 1, shape) / 8.0).astype(np.float32)


def _scores(ht, send, recv, att, valid):
    """GATv2 scores in f32, -inf on invalid slots (exact: dyadic inputs)."""
    heads, f = att.shape
    pre = (ht[recv] + ht[send]).reshape(-1, heads, f)
    z = np.where(pre > 0, pre, np.float32(SLOPE) * pre)
    s = (z * att[None]).sum(-1, dtype=np.float32)
    return np.where(valid[:, None], s, -np.inf).astype(np.float32)


def _k8_model(scores, row_ptr, exp=np.exp):
    """K8's (m, l) in its kernel's order: each piece of the work list folds
    its finite scores in slot order with online_step (lanes.cuh); a piece
    that is its whole row stores (m, l), m as 0 where no score was finite;
    a split row's pieces are merged in piece order, skipping a piece
    without a finite score (merge_split_stats, recv_pieces.cuh). The heads
    of a piece are held side by side; ``exp`` takes a float32 array."""
    work = spmm_cuda.recv_bwd_work(torch.from_numpy(row_ptr))
    n, k = row_ptr.shape[0] - 1, scores.shape[1]
    m_out = np.zeros((n, k), np.float32)
    l_out = np.zeros((n, k), np.float32)
    parts = [None] * work.num_shares
    with np.errstate(invalid="ignore"):  # -inf - -inf, masked below
        for row, lo, hi, share in work.pieces.numpy():
            m = np.full(k, -np.inf, np.float32)
            l = np.zeros(k, np.float32)
            for s in scores[lo:hi]:
                live = s > -np.inf
                m_new = np.where(live, np.maximum(m, s), m)
                scale = exp(m - m_new)
                p = exp(s - m_new)
                l = np.where(live, l * scale + p, l).astype(np.float32)
                m = m_new
            if share >= 0:
                parts[share] = (m, l)
                continue
            m_out[row] = np.where(m > -np.inf, m, 0.0)
            l_out[row] = l
        fix_ptr = work.fix_ptr.numpy()
        for i, row in enumerate(work.fix_rows.numpy()):
            mine = parts[fix_ptr[i]:fix_ptr[i + 1]]
            m = np.max([mp for mp, _ in mine], axis=0)
            l = np.zeros(k, np.float32)
            for mp, lp in mine:
                w = exp(mp - m)
                l = np.where(mp > -np.inf, l + lp * w, l).astype(np.float32)
            m_out[row] = np.where(m > -np.inf, m, 0.0)
            l_out[row] = l
    return m_out, l_out


def _torch_exp(x):
    return torch.exp(torch.from_numpy(np.ascontiguousarray(x))).numpy()


def _inputs(heads, f, seed):
    rng, recv, send, valid, row_ptr, tables = _stream(seed)
    ht = _dyadic(rng, (N, heads * f))
    att = _dyadic(rng, (heads, f))
    return ht, att, recv, send, valid, row_ptr, tables


def _jax_stats(ht, att, send, valid, tables, dtype):
    dt = jnp.dtype(dtype)
    ht_j = jnp.asarray(ht).astype(dt)
    hj = jnp.take(ht_j, jnp.asarray(send), axis=0)
    with pltpu.force_tpu_interpret_mode():
        res = sddmm_pallas.sddmm_stats_sorted(
            ht_j, hj, jnp.asarray(att).astype(dt), tables=tables,
            num_nodes=N, edge_valid=jnp.asarray(valid), negative_slope=SLOPE)
    return tuple(np.asarray(r, np.float32) for r in res)


@pytest.mark.parametrize("heads,f", [(2, 8), (4, 4), (1, 5)])
def test_k8_piece_order_matches_the_jax_kernel(heads, f):
    """(a) The model of K8's order against the Pallas kernel: scores and m
    exactly, l to 1e-5; the empty row and the all-invalid row are zeros."""
    ht, att, recv, send, valid, row_ptr, tables = _inputs(heads, f, heads)
    scores = _scores(ht, send, recv, att, valid)
    m, l = _k8_model(scores, row_ptr)
    ref_scores, ref_m, ref_l = _jax_stats(ht, att, send, valid, tables,
                                          "float32")
    np.testing.assert_array_equal(scores, ref_scores)
    np.testing.assert_array_equal(m, ref_m[:N])
    np.testing.assert_allclose(l, ref_l[:N], rtol=1e-5, atol=1e-5)
    for row in (EMPTY, DEAD):
        assert not m[row].any() and not l[row].any()
    assert spmm_cuda.recv_bwd_work(
        torch.from_numpy(row_ptr)).fix_rows.tolist() == [HUB, N - 1]


def _hub_stream(seed):
    """A stream with a 5,000-slot hub row and a 511-slot padded tail
    (``test_torch_kernel_redesign._hub_graph``'s shape), smaller otherwise."""
    rng = np.random.default_rng(seed)
    n, hub, tail = 24, 5_000, 511
    allowed = np.array([i for i in range(n) if i % 5 != 2 and i != 7])
    recv = np.sort(np.concatenate([rng.choice(allowed, 120),
                                   np.full(hub, 7)])).astype(np.int32)
    e_real = recv.shape[0]
    recv = np.concatenate([recv, np.full(tail, n - 1, np.int32)])
    send = rng.integers(0, n, recv.shape[0]).astype(np.int32)
    send[e_real:] = n - 1
    valid = np.arange(recv.shape[0]) < e_real
    row_ptr = np.searchsorted(recv, np.arange(n + 1)).astype(np.int32)
    return rng, n, recv, send, valid, row_ptr


@pytest.mark.parametrize("stream", ["redesign", "hub"])
def test_k8_order_is_k9s_order_bit_for_bit(stream):
    """(b) The model of K8's order gives, on every row, the bits of the
    model of K9's forward order (``_piecewise_forward``) on K9's scores:
    one-piece rows, the split 45-slot or 5,000-slot hub, the padded tail,
    the empty and the all-invalid rows. Both take torch's exp."""
    heads, f = 2, 4
    if stream == "redesign":
        rng, recv, send, valid, row_ptr, _ = _stream(11)
        n = N
    else:
        rng, n, recv, send, valid, row_ptr = _hub_stream(12)
    ht = torch.from_numpy(rng.standard_normal((n, heads * f))
                          .astype(np.float32))
    att = torch.from_numpy(rng.standard_normal((heads, f)).astype(np.float32))
    work = spmm_cuda.recv_bwd_work(torch.from_numpy(row_ptr))
    assert work.num_shares > 0
    _, k9_scores, k9_m, k9_l = _piecewise_forward(ht, send, att, valid, None,
                                                  work)
    m, l = _k8_model(k9_scores.numpy(), row_ptr, exp=_torch_exp)
    np.testing.assert_array_equal(m, k9_m.numpy())
    np.testing.assert_array_equal(l, k9_l.numpy())
    assert np.isfinite(l).all() and (l[np.diff(row_ptr) > 0].any())


def _fast_div(x, d):
    """make_fast_div / fast_div (csrc/fast_div.cuh) on numpy uint64."""
    if d == 1:
        return x
    log2 = (d - 1).bit_length()  # ceil(log2(d))
    mul = ((1 << (31 + log2)) + d - 1) // d
    assert mul < 1 << 32
    return ((x * np.uint64(mul)) >> np.uint64(32)) >> np.uint64(log2 - 1)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [1, 4, 6, 8])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("sms", [0, 1, 10**6])
def test_k6_flat_index_arithmetic(heads, out_dtype, aligned, sms):
    """(c) K6's threads: thread t of block b serves the flat index
    i = b * 256 + t; its slot i / packs by a multiply-high and a shift, its
    pack c = i - slot * packs, its heads c * vec .. c * vec + vec; the
    scores' and alpha's byte offsets i * vec times the element size, the
    (m, l) row recv[slot] * heads + c * vec. Integer division agrees and
    every (slot, head) is covered once. The pack is the widest the heads and
    the pointers allow where the grid gives the card's SMs (``sms``) two
    blocks each, narrower otherwise."""
    e = 301
    rng = np.random.default_rng(heads)
    recv = np.sort(rng.integers(0, 50, e)).astype(np.int64)
    off = 0 if aligned else 1

    def tensor(rows, dtype):
        flat = torch.empty(rows * heads + off, dtype=dtype)
        return flat[off:].view(rows, heads)

    scores, m, l = (tensor(r, torch.float32) for r in (e, 50, 50))
    alpha = tensor(e, out_dtype)
    vec = softmax_cuda._apply_vec(heads, e, sms, scores, m, l, alpha)
    widest = 1 if not aligned else max(v for v in (4, 2, 1) if heads % v == 0)
    if sms == 0:  # any grid fills no card: the widest pack
        assert vec == widest
    elif sms == 10**6:  # no grid fills it: single heads
        assert vec == 1
    else:
        assert vec <= widest and heads % vec == 0
        assert vec == 1 or -(-e * (heads // vec) // THREADS) >= 2 * sms
    packs = heads // vec
    n_items = e * packs
    blocks = -(-n_items // THREADS)
    b, t = np.meshgrid(np.arange(blocks), np.arange(THREADS), indexing="ij")
    i = (b * THREADS + t).astype(np.uint64).ravel()
    i = i[i < n_items]
    assert i.size == n_items  # every item once
    slot = _fast_div(i, packs)
    np.testing.assert_array_equal(slot, i // np.uint64(packs))
    c = (i - slot * np.uint64(packs)).astype(np.int64)
    slot = slot.astype(np.int64)
    first = c * vec  # the pack's first head
    size = 2 if out_dtype == torch.bfloat16 else 4
    np.testing.assert_array_equal(i.astype(np.int64) * vec * 4,
                                  (slot * heads + first) * 4)
    np.testing.assert_array_equal(i.astype(np.int64) * vec * size,
                                  (slot * heads + first) * size)
    row = recv[slot] * heads + first
    np.testing.assert_array_equal(row // heads, recv[slot])
    covered = np.zeros((e, heads), np.int64)
    for j in range(vec):
        np.add.at(covered, (slot, first + j), 1)
    assert (covered == 1).all()
    # Every pack's bytes are aligned to the pack: 16 bytes of f32 at 4.
    for t_ in (scores, m, l):
        assert t_.data_ptr() % (vec * 4) == 0
    assert alpha.data_ptr() % (vec * size) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads,f", [(2, 8), (4, 4)])
def test_cpu_paths_match_the_jax_functions(heads, f, dtype):
    """(d) The port's CPU paths (the plain versions) against the JAX
    functions: K8's scores and m exactly, l to 1e-5; K6's alpha f32 to
    1e-5, bf16 to 2e-2 of its largest entry; -inf slots give alpha 0."""
    ht, att, recv, send, valid, row_ptr, tables = _inputs(heads, f, 7)
    tdt = getattr(torch, dtype)
    scores, m, l = sddmm_cuda.sddmm_stats_sorted(
        torch.from_numpy(ht).to(tdt), torch.from_numpy(send),
        torch.from_numpy(recv), torch.from_numpy(row_ptr),
        torch.from_numpy(att).to(tdt), edge_valid=torch.from_numpy(valid),
        negative_slope=SLOPE)
    ref_scores, ref_m, ref_l = _jax_stats(ht, att, send, valid, tables, dtype)
    np.testing.assert_array_equal(scores.numpy(), ref_scores)
    np.testing.assert_array_equal(m.numpy(), ref_m[:N])
    np.testing.assert_allclose(l.numpy(), ref_l[:N], rtol=1e-5, atol=1e-5)
    # The model's order gives the same statistics.
    mm, ll = _k8_model(scores.numpy(), row_ptr)
    np.testing.assert_array_equal(mm, m.numpy())
    np.testing.assert_allclose(ll, l.numpy(), rtol=1e-5, atol=1e-5)

    for out_dtype in (torch.float32, torch.bfloat16):
        alpha = softmax_cuda.softmax_apply_sorted(
            scores, m, l, torch.from_numpy(recv), eps=EPS,
            out_dtype=out_dtype)
        jdt = jnp.float32 if out_dtype == torch.float32 else jnp.bfloat16
        with pltpu.force_tpu_interpret_mode():
            ref = softmax_pallas.softmax_apply_sorted(
                jnp.asarray(scores.numpy()), jnp.asarray(m.numpy()),
                jnp.asarray(l.numpy()), tables=tables, eps=EPS,
                out_dtype=jdt)
        ref = np.asarray(ref.astype(jnp.float32))
        got = alpha.float().numpy()
        assert alpha.dtype == out_dtype and got.shape == (E, heads)
        assert not got[~valid].any() and not ref[~valid].any()
        tol = 1e-5 if out_dtype == torch.float32 else 2e-2
        np.testing.assert_allclose(got, ref, rtol=tol,
                                   atol=tol * float(np.abs(ref).max()))
