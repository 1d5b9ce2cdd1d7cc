"""The composed path's softmax statistics (K5, ``softmax_cuda.
softmax_stats_sorted``) and score backward (K7b, ``sddmm_cuda.
sddmm_bwd_sorted``) in their CUDA kernels' order of summation, on the CPU,
against the JAX package.

Both kernels walk the pieces of the receiver-sorted stream
(``spmm_cuda.recv_bwd_work(row_ptr)``: at most 32 slots of one row; K7b's
list cuts a row longer than that into pieces of
``sddmm_cuda.BWD_SPLIT_PIECE`` slots). K5
folds each piece's scores in slot order with the online step and merges a
split row's pieces in piece order, as the fused forward does; K7b keeps
each group's ``datt`` partial over the pieces it strides to, sums a
block's groups in group order into one row per block, and sums those rows
with the fixed tree of ``reduce_partials`` (``csrc/lanes.cuh``). The models
below repeat those orders in numpy f32 (K7b's for several grids, with the
kernel's index arithmetic from a group's registers to its block's row) and
are held against the reference's Pallas kernels run in interpret mode, on a
stream with a 45-slot row, an empty row, a row whose scores are all
``-inf`` and a 40-slot padded tail. The tests also pin that
``GraphContext.sddmm_scores``'s backward hands K7b ``row_ptr`` and that a
tensor on the card without it is refused.

Tolerances: f32 1e-5, of the largest entry for ``d_pre`` and ``datt``
(a different order of f32 sums; the reference's softmax statistics are
run with their one-hot products at ``HIGHEST`` precision, not their
default two bf16 passes, ROADMAP D1); bf16 ``d_pre`` 2e-2 of its largest
entry (ROADMAP D5 / D7: the reference rounds ``ds`` and each term to bf16,
the port once at the store). Bits: a row of at most 32 slots, and
a row whose finite scores lie in one piece, get a serial walk's ``(m, l)``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import keras_geometric_tpu_torch as kgt_torch
from keras_geometric_tpu.kernels import sddmm_pallas, softmax_pallas, spmm_pallas
from keras_geometric_tpu_torch.kernels import sddmm_cuda, softmax_cuda, spmm_cuda

torch.set_num_threads(1)

N, E_REAL, E = 40, 216, 256
HUB, HUB_SLOTS = 7, 45  # a row of more than one piece
EMPTY, DEAD = 3, 12  # a row without slots; a row whose scores are all -inf
PIECE = spmm_cuda.RECV_BWD_PIECE
SLOPE = 0.2
THREADS, SLAB, MAX_PER_LANE = 256, 256, 8  # lanes.cuh
BWD_GRID_PER_SM = 6  # sddmm.cu, kBwdGridPerSm


def _stream(seed=0):
    """Receiver-sorted slots: HUB has 45, EMPTY none, the last row holds 40
    padded slots after its real ones."""
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
    tables = spmm_pallas.build_row_tables(recv, N, edge_chunk=128,
                                          row_block=32)
    return rng, recv, row_ptr, tables


def _work(row_ptr):
    return spmm_cuda.recv_bwd_work(torch.from_numpy(row_ptr))


def _k7b_work(row_ptr):
    return spmm_cuda.recv_bwd_work(torch.from_numpy(row_ptr),
                                   split_piece=sddmm_cuda.BWD_SPLIT_PIECE)


def _scores(k, seed=1):
    rng, recv, row_ptr, tables = _stream(seed)
    s = (3.0 * rng.standard_normal((E, k))).astype(np.float32)
    s[E_REAL:] = -np.inf  # the padded tail
    s[row_ptr[DEAD]:row_ptr[DEAD + 1]] = -np.inf
    assert row_ptr[DEAD + 1] > row_ptr[DEAD]
    return s, recv, row_ptr, tables


def _online(scores_col, m=np.float32(-np.inf), l=np.float32(0.0)):
    """online_step (lanes.cuh) over finite scores in slot order, in f32."""
    for s in scores_col:
        if s > -np.inf:
            m_new = np.maximum(m, s)
            l = l * np.exp(np.float32(m - m_new)) + np.exp(
                np.float32(s - m_new))
            m = m_new
    return np.float32(m), np.float32(l)


def _k5_model(scores, row_ptr):
    """K5's (m, l): each piece walked in slot order; a split row's pieces
    merged in piece order, skipping a piece without a finite score."""
    work = _work(row_ptr)
    k = scores.shape[1]
    m = np.zeros((N, k), np.float32)
    l = np.zeros((N, k), np.float32)
    part = np.zeros((work.num_shares, k, 2), np.float32)
    for row, lo, hi, share in work.pieces.numpy():
        for h in range(k):
            pm, pl_ = _online(scores[lo:hi, h])
            if share < 0:
                m[row, h] = pm if pm > -np.inf else 0.0
                l[row, h] = pl_
            else:
                part[share, h] = pm, pl_
    fix_ptr = work.fix_ptr.numpy()
    for i, row in enumerate(work.fix_rows.numpy()):
        for h in range(k):
            shares = part[fix_ptr[i]:fix_ptr[i + 1], h]
            mm = np.float32(np.max(shares[:, 0]))
            ll = np.float32(0.0)
            for pm, pl_ in shares:
                if pm > -np.inf:
                    ll = ll + pl_ * np.exp(np.float32(pm - mm))
            m[row, h] = mm if mm > -np.inf else 0.0
            l[row, h] = ll
    return m, l


@pytest.mark.parametrize("k", [1, 4, 8])
def test_k5_piece_order_matches_the_jax_kernel(monkeypatch, k):
    # The reference's statistics at f32 precision: its one-hot products
    # otherwise keep ~16 mantissa bits ("split2", ROADMAP D1).
    monkeypatch.setattr(
        softmax_pallas, "_dots", lambda hit, data, precision, dims:
        spmm_pallas._dots(hit, data, jax.lax.Precision.HIGHEST, dims))
    scores, _, row_ptr, tables = _scores(k, seed=k)
    with pltpu.force_tpu_interpret_mode():
        ref_m, ref_l = softmax_pallas.softmax_stats_sorted(
            jnp.asarray(scores), N, tables=tables)
    m, l = _k5_model(scores, row_ptr)
    np.testing.assert_allclose(m, np.asarray(ref_m), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(l, np.asarray(ref_l), rtol=1e-5, atol=1e-5)
    # The rows without a finite score (empty, all -inf): m = l = 0.
    for row in (EMPTY, DEAD):
        assert not m[row].any() and not l[row].any()
    # The CPU path (the plain version) agrees too.
    got = softmax_cuda.softmax_stats_sorted(
        torch.from_numpy(scores), torch.from_numpy(_stream(k)[1]),
        torch.from_numpy(row_ptr), N)
    np.testing.assert_allclose(got[0].numpy(), m, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), l, rtol=1e-5, atol=1e-5)


def test_k5_rows_of_one_piece_get_a_serial_walks_bits():
    scores, _, row_ptr, _ = _scores(4, seed=9)
    m, l = _k5_model(scores, row_ptr)
    lengths = np.diff(row_ptr)
    serial = np.zeros((N, 4, 2), np.float32)
    for r in range(N):
        for h in range(4):
            pm, pl_ = _online(scores[row_ptr[r]:row_ptr[r + 1], h])
            serial[r, h] = (pm if pm > -np.inf else 0.0), pl_
    one = lengths <= PIECE
    assert (~one).sum() == 2  # the hub and the padded tail row
    np.testing.assert_array_equal(m[one], serial[one, :, 0])
    np.testing.assert_array_equal(l[one], serial[one, :, 1])
    # The tail row is split, but its finite scores lie in its first piece
    # (the later pieces hold only padding): the merge keeps those bits.
    np.testing.assert_array_equal(m[N - 1], serial[N - 1, :, 0])
    np.testing.assert_array_equal(l[N - 1], serial[N - 1, :, 1])
    # The hub's two pieces are merged: within f32 rounding of the walk.
    np.testing.assert_allclose(l[HUB], serial[HUB, :, 1], rtol=1e-6)
    np.testing.assert_array_equal(m[HUB], serial[HUB, :, 0])


def _layout(f, elem):
    """pick_layout (lanes.cuh) for 16-byte aligned data."""
    vec = 16 // elem
    while vec > 1 and f % vec:
        vec //= 2
    slabs = -(-f // SLAB)
    if slabs > 1:
        return vec, 32, MAX_PER_LANE // vec, slabs
    packs = f // vec
    lph = 1
    while lph < packs and lph < 32:
        lph *= 2
    nj = 1
    while nj < -(-packs // lph):
        nj *= 2
    return vec, lph, nj, slabs


def _grid(n_pieces, per_row, lph, sms):
    """blocks_for_fixed_grid (lanes.cuh) at K7b's blocks a SM."""
    groups = THREADS // lph
    blocks = min(sms * BWD_GRID_PER_SM, -(-n_pieces * per_row // groups))
    return -(-blocks // per_row) * per_row


def _datt_model(z_ds, pieces, heads, f, elem, sms):
    """K7b's datt from the per-slot terms z * ds [E, heads*f] (f32): each
    group's registers over its items, the block's rows from its groups'
    registers by the kernel's index arithmetic, then reduce_partials."""
    vec, lph, nj, slabs = _layout(f, elem)
    per_row = heads * slabs
    groups = THREADS // lph
    blocks = _grid(len(pieces), per_row, lph, sms)
    n_groups = blocks * groups
    d = heads * f
    # buf[block, thread, pack, value]: a lane's partial of its columns.
    buf = np.zeros((blocks, THREADS, nj, vec), np.float32)
    for gid in range(n_groups):
        hk = gid % per_row
        k, h = hk // heads, hk % heads
        fk = min(SLAB, f - k * SLAB) if slabs > 1 else f
        col0 = h * f + k * SLAB
        acc = np.zeros(fk, np.float32)
        for item in range(gid, len(pieces) * per_row, n_groups):
            _, lo, hi, _ = pieces[item // per_row]
            for e in range(lo, hi):
                acc = acc + z_ds[e, col0:col0 + fk]
        block, g = divmod(gid, groups)
        for c in range(fk):
            pack = c // vec
            t, j = pack % lph, pack // lph
            buf[block, g * lph + t, j, c % vec] = acc[c]
    flat = buf.reshape(blocks, -1)
    rows = np.zeros((blocks, d), np.float32)
    for b in range(blocks):
        first = b * groups
        for c in range(d):
            hc, ch = divmod(c, f)
            k = ch // SLAB if slabs > 1 else 0
            cc = ch - k * SLAB
            r = k * heads + hc
            pack = cc // vec
            at = ((pack % lph) * nj + pack // lph) * vec + (cc - pack * vec)
            g = (r - first % per_row + per_row) % per_row
            while g < groups:
                rows[b, c] = rows[b, c] + flat[b, g * lph * nj * vec + at]
                g += per_row
    # reduce_partials: thread t sums rows t, t + 256, ... then a tree.
    out = np.zeros(d, np.float32)
    for c in range(d):
        lane = np.zeros(THREADS, np.float32)
        for p in range(blocks):
            lane[p % THREADS] = lane[p % THREADS] + rows[p, c]
        off = THREADS // 2
        while off:
            lane[:off] = lane[:off] + lane[off:2 * off]
            off //= 2
        out[c] = lane[0]
    return out


def _k7b_case(heads, f, seed):
    rng, recv, row_ptr, tables = _stream(seed)
    d = heads * f
    ht = rng.standard_normal((N, d)).astype(np.float32)
    hj = rng.standard_normal((E, d)).astype(np.float32)
    att = rng.standard_normal((heads, f)).astype(np.float32)
    ds = rng.standard_normal((E, heads)).astype(np.float32)
    ds[E_REAL:] = 0.0  # alpha is 0 on padded slots
    return recv, row_ptr, tables, ht, hj, att, ds


def _terms(recv, ht, hj, att, ds):
    """Per slot: z * ds and d_pre, in f32, as the kernel forms them."""
    heads, f = att.shape
    pre = (ht[recv] + hj).reshape(-1, heads, f)
    pos = pre > 0
    z = np.where(pos, pre, np.float32(SLOPE) * pre)
    g = ds[:, :, None]
    d_pre = g * att[None] * np.where(pos, np.float32(1.0), np.float32(SLOPE))
    return (z * g).reshape(len(recv), -1), d_pre.reshape(len(recv), -1)


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("heads,f,elem", [(4, 16, 4), (2, 6, 4), (4, 8, 2),
                                          (1, 320, 2)])
def test_k7b_datt_order_matches_the_jax_kernel(heads, f, elem, sms):
    recv, row_ptr, tables, ht, hj, att, ds = _k7b_case(heads, f, 20 + f)
    pieces = _k7b_work(row_ptr).pieces.numpy()
    z_ds, d_pre = _terms(recv, ht, hj, att, ds)
    datt = _datt_model(z_ds, pieces, heads, f, elem, sms)
    with pltpu.force_tpu_interpret_mode():
        ref_d_pre, ref_datt = sddmm_pallas.sddmm_bwd_sorted(
            jnp.asarray(ht), jnp.asarray(hj), jnp.asarray(att),
            jnp.asarray(ds), tables=tables, negative_slope=SLOPE)
    ref_datt = np.asarray(ref_datt).reshape(-1)
    scale = np.abs(ref_datt).max()
    np.testing.assert_allclose(datt, ref_datt, rtol=1e-5, atol=1e-5 * scale)
    ref_d_pre = np.asarray(ref_d_pre)
    np.testing.assert_allclose(d_pre, ref_d_pre, rtol=1e-5,
                               atol=1e-5 * np.abs(ref_d_pre).max())
    # Every slot of every piece counted once, in any grid.
    np.testing.assert_allclose(datt, z_ds.astype(np.float64).sum(0),
                               rtol=1e-5, atol=1e-5 * scale)


def test_k7b_bf16_d_pre_and_the_cpu_path_match_the_jax_kernel():
    recv, row_ptr, tables, ht, hj, att, ds = _k7b_case(4, 8, 31)
    bf = lambda a: torch.from_numpy(a).bfloat16()  # noqa: E731
    ht_b, hj_b, att_b = bf(ht), bf(hj), bf(att)
    with pltpu.force_tpu_interpret_mode():
        ref_d_pre, ref_datt = sddmm_pallas.sddmm_bwd_sorted(
            jnp.asarray(ht_b.float().numpy(), jnp.bfloat16),
            jnp.asarray(hj_b.float().numpy(), jnp.bfloat16),
            jnp.asarray(att_b.float().numpy(), jnp.bfloat16),
            jnp.asarray(ds), tables=tables, negative_slope=SLOPE)
    # The kernel's terms on the bf16 inputs, d_pre rounded once.
    z_ds, d_pre = _terms(recv, ht_b.float().numpy(), hj_b.float().numpy(),
                         att_b.float().numpy(), ds)
    ref = np.asarray(ref_d_pre.astype(jnp.float32))
    got = torch.from_numpy(d_pre).bfloat16().float().numpy()
    np.testing.assert_allclose(got, ref, atol=2e-2 * np.abs(ref).max())
    datt = _datt_model(z_ds, _work(row_ptr).pieces.numpy(), 4, 8, 2, 132)
    ref_datt = np.asarray(ref_datt.astype(jnp.float32)).reshape(-1)
    np.testing.assert_allclose(datt, ref_datt,
                               atol=2e-2 * np.abs(ref_datt).max())
    # The CPU path: the plain version, which ignores row_ptr.
    p_d_pre, p_datt = sddmm_cuda.sddmm_bwd_sorted(
        ht_b, hj_b, att_b, torch.from_numpy(ds), torch.from_numpy(recv),
        negative_slope=SLOPE, row_ptr=torch.from_numpy(row_ptr))
    assert p_d_pre.dtype == p_datt.dtype == torch.bfloat16
    np.testing.assert_allclose(p_d_pre.float().numpy(), ref,
                               atol=2e-2 * np.abs(ref).max())


def test_k7b_pieces_cover_every_slot_once_with_its_receiver():
    """K7b reads each slot's receiver row from its piece and writes every
    slot's d_pre: the pieces cover [0, E) once, in order; a row of at most
    32 slots is one piece, a longer one (the 45-slot row, the padded tail)
    comes in pieces of BWD_SPLIT_PIECE slots."""
    _, recv, row_ptr, _ = _stream(3)
    pieces = _k7b_work(row_ptr).pieces.numpy()
    np.testing.assert_array_equal(pieces[1:, 1], pieces[:-1, 2])
    assert pieces[0, 1] == 0 and pieces[-1, 2] == E
    np.testing.assert_array_equal(
        np.repeat(pieces[:, 0], pieces[:, 2] - pieces[:, 1]), recv)
    lengths = np.diff(row_ptr)
    split = sddmm_cuda.BWD_SPLIT_PIECE
    for row in range(N):
        mine = pieces[pieces[:, 0] == row]
        sizes = mine[:, 2] - mine[:, 1]
        if lengths[row] <= PIECE:
            assert len(mine) == 1 and sizes[0] == lengths[row]
        else:
            assert len(mine) == -(-lengths[row] // split)
            assert (sizes[:-1] == split).all() and 0 < sizes[-1] <= split
    # The other walks' list is untouched, and each list is kept apart.
    assert _work(row_ptr).pieces.shape[0] < pieces.shape[0]
    rp = torch.from_numpy(row_ptr)
    first = spmm_cuda.recv_bwd_work(rp, split_piece=split)
    assert spmm_cuda.recv_bwd_work(rp, split_piece=split) is first
    assert spmm_cuda.recv_bwd_work(rp) is not first
    assert spmm_cuda.recv_bwd_work(rp, split_piece=split) is first
    with pytest.raises(ValueError, match="split_piece"):
        spmm_cuda.recv_bwd_work(rp, split_piece=PIECE + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_context_hands_the_score_backward_its_row_ptr(monkeypatch, dtype):
    rng = np.random.default_rng(5)
    n, e, heads, f = 30, 120, 2, 4
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    ctx = kgt_torch.prepare_graph(ei.astype(np.int32), n,
                                  add_self_loops=True, edge_chunk=64,
                                  device="cpu")
    ht = torch.from_numpy(rng.standard_normal((n, heads * f))).to(dtype)
    att = torch.from_numpy(rng.standard_normal((heads, f))).to(dtype)
    ht.requires_grad_(True)
    att.requires_grad_(True)
    hj = ht.detach()[ctx.senders.long()].clone().requires_grad_(True)
    seen = {}
    real = sddmm_cuda.sddmm_bwd_sorted

    def spy(*args, **kwargs):
        seen.update(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(sddmm_cuda, "sddmm_bwd_sorted", spy)
    scores = ctx.sddmm_scores(ht, hj, att)
    g = torch.from_numpy(rng.standard_normal(scores.shape)).float()
    g = g.masked_fill(~ctx.edge_mask[:, None], 0.0)
    (scores * g).sum().backward()
    assert seen["row_ptr"] is ctx.row_ptr
    # The gradients are the plain version's.
    d_pre, datt = sddmm_cuda.sddmm_bwd_sorted_plain(
        ht.detach(), hj.detach(), att.detach(), g, ctx.receivers)
    assert torch.equal(hj.grad, d_pre) and torch.equal(att.grad, datt)


def test_score_backward_refuses_a_card_tensor_without_row_ptr():
    on_card = types.SimpleNamespace(is_cuda=True, shape=(4, 6))
    recv = torch.tensor([0, 0, 2, 3], dtype=torch.int32)
    with pytest.raises(ValueError, match="row_ptr is required"):
        sddmm_cuda.sddmm_bwd_sorted(on_card, on_card, torch.ones(2, 3),
                                    torch.ones(4, 2), recv)
