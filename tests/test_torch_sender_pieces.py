"""The sender-order walks in pieces: the fused-gather scatter (K1, the
attention's permute finish) and the attention's sender backward (K10d).

Both walk ``recv_bwd_work(row_ptr_bwd)``, the pieces of the sender-sorted
stream: every sender row cut into pieces of at most ``RECV_BWD_PIECE``
slots, so that neither a hub sender nor the padded tail (which
``prepare_graph`` gives sender = receiver = the last node, so that in sender
order it piles into the last sender's row) is walked serially. A whole-row
piece stores its row; a split row's pieces leave f32 shares that a second
launch adds in piece order.

The graph here has ``_hub_graph``'s shape (``test_torch_kernel_redesign``):
64 nodes, a 5,000-slot hub (here a sender), 249 other edges, and a 511-slot
padded tail, prepared by ``prepare_graph`` so that ``row_ptr_bwd``,
``bwd_perm`` and ``receivers_ss`` are the real ones. Plain emulations of
the two walks (each piece alone, shares added in piece order) are held
against the plain versions and the JAX package's Pallas kernels in
interpret mode: the finish against ``scatter_sum_sorted(take(v, perm))`` at
``Precision.HIGHEST`` (f32 1e-5; bf16 2e-2 of the largest entry), the sender
backward against ``attend_send_bwd_sorted`` fed the chained gathers the
reference's ``ops/csr.py`` builds (1e-4, the reference's two-pass bf16
split of f32 operands). On the CPU the wrappers take their plain versions
and count no launch; the kernels themselves are held against those plain
versions on the card by ``chip_smoke.py``. Each caller's choice of walk is
pinned too: the GCN's operator takes the row walk (``pieces=False``), the
gather's VJP and the attention's permute finish the pieces.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import keras_geometric_tpu_torch as kgt
from keras_geometric_tpu.kernels import attend_pallas, spmm_pallas
from keras_geometric_tpu.ops.csr import chain_after
from keras_geometric_tpu_torch.kernels import attend_cuda, spmm_cuda

torch.set_num_threads(1)

SLOPE, EPS = 0.2, 1e-10
N, HUB, OTHERS, TAIL, HUB_SENDER = 64, 5_000, 249, 511, 7
HEADS, F = 2, 4
PIECE = spmm_cuda.RECV_BWD_PIECE


def _hub_sender_context():
    """``prepare_graph`` over a hub sender (HUB slots), OTHERS random edges
    whose senders skip every fifth node (empty sender rows), and a padded
    tail of TAIL slots (``edge_chunk`` makes the stream 5,760 slots)."""
    rng = np.random.default_rng(0)
    allowed = np.array([i for i in range(N) if i % 5 != 2 and i != HUB_SENDER])
    send = np.concatenate([np.full(HUB, HUB_SENDER), rng.choice(allowed, OTHERS)])
    recv = rng.integers(0, N, send.shape[0])
    edges = np.stack([send, recv]).astype(np.int32)
    return kgt.prepare_graph(edges, N, edge_chunk=1_920, device="cpu")


@pytest.fixture(scope="module")
def ctx():
    return _hub_sender_context()


def test_hub_sender_context_has_the_shape_the_tests_need(ctx):
    lengths = np.diff(ctx.row_ptr_bwd.numpy())
    e = ctx.senders.shape[0]
    assert e == HUB + OTHERS + TAIL and e % 128 == 0
    assert lengths[HUB_SENDER] == HUB and (lengths == 0).any()
    assert lengths[N - 1] >= TAIL
    # In sender order the padded slots come last, after the last sender's
    # real slots.
    valid_ss = ctx.edge_mask_ss.numpy()
    assert valid_ss[-TAIL:].sum() == 0 and valid_ss[:-TAIL].all()


def test_sender_work_covers_every_slot_once_in_order(ctx):
    row_ptr = ctx.row_ptr_bwd.numpy()
    work = spmm_cuda.recv_bwd_work(ctx.row_ptr_bwd)
    p = work.pieces.numpy()
    rows, lo, hi, share = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
    assert np.array_equal(np.unique(rows), np.arange(N))
    assert np.all(np.diff(rows) >= 0)
    assert np.array_equal(lo[1:], hi[:-1]) and lo[0] == 0
    assert hi[-1] == row_ptr[-1] and np.all(hi - lo <= PIECE)
    for r in range(N):
        mine = rows == r
        assert lo[mine][0] == row_ptr[r] and hi[mine][-1] == row_ptr[r + 1]
    lengths = np.diff(row_ptr)
    counts = np.bincount(rows, minlength=N)
    # Every row of at most PIECE slots is one piece, its whole row.
    assert np.all(counts[lengths <= PIECE] == 1)
    assert np.all(share[lengths[rows] <= PIECE] == -1)
    # The hub sender and the padded tail's row are split, in order.
    split = work.fix_rows.numpy()
    assert HUB_SENDER in split and N - 1 in split
    assert np.array_equal(split, np.nonzero(lengths > PIECE)[0])
    assert np.array_equal(np.diff(work.fix_ptr.numpy()), counts[split])
    assert np.array_equal(share[share >= 0], np.arange(work.num_shares))


def test_one_work_list_per_row_ptr_for_both_modules(ctx):
    """The finish and the sender backward share the list of row_ptr_bwd."""
    assert attend_cuda.recv_bwd_work is spmm_cuda.recv_bwd_work
    first = spmm_cuda.recv_bwd_work(ctx.row_ptr_bwd)
    assert attend_cuda.recv_bwd_work(ctx.row_ptr_bwd) is first
    assert attend_cuda.RECV_BWD_PIECE == PIECE


def _walk(work, n, width, slot_terms):
    """A piece walk in plain torch: ``slot_terms(lo, hi)`` gives a piece's
    per-slot f32 terms ``[hi - lo, width]``, summed in slot order; a
    whole-row piece is its row, a split row the sum of its pieces' shares in
    piece order. Returns the f32 rows (before the epilogue and rounding)."""
    out = torch.zeros(n, width)
    shares = torch.zeros(work.num_shares, width)
    for row, lo, hi, share in work.pieces.tolist():
        acc = torch.zeros(width)
        for term in slot_terms(lo, hi):
            acc = acc + term
        if share < 0:
            out[row] = acc
        else:
            shares[share] = acc
    for k, row in enumerate(work.fix_rows.tolist()):
        total = torch.zeros(width)
        for p in range(int(work.fix_ptr[k]), int(work.fix_ptr[k + 1])):
            total = total + shares[p]
        out[row] = total
    return out


def _finish_walk(v, idx, weights, self_weight, work, n):
    """K1's fused-gather piece walk over ``idx``: weights[e] * v[idx[e]]."""
    vf = v.float()
    w = None if weights is None else weights.float()

    def terms(lo, hi):
        rows = vf.index_select(0, idx[lo:hi].long())
        return rows if w is None else rows * w[lo:hi, None]

    out = _walk(work, n, v.shape[1], terms)
    if self_weight is not None:
        out = out + vf[:n] * self_weight.float()[:, None]
    return out.to(v.dtype)


def _held(got, want, tol, what=""):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted",
                                                          "weighted"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_piecewise_finish_equals_the_plain_version_and_jax(ctx, dtype,
                                                          weighted):
    rng = np.random.default_rng(3)
    e = ctx.senders.shape[0]
    v = torch.from_numpy(
        rng.standard_normal((e, HEADS * F)).astype(np.float32)).to(dtype)
    weights = None
    if weighted:  # as the banded finish weighs its residual (0 on padding)
        weights = torch.from_numpy(
            rng.uniform(0.1, 1.0, e).astype(np.float32)) * ctx.edge_mask_ss
    work = spmm_cuda.recv_bwd_work(ctx.row_ptr_bwd)
    walked = _finish_walk(v, ctx.bwd_perm, weights, None, work, N)
    plain = spmm_cuda.gather_scatter_sum_sorted_plain(
        v, ctx.bwd_perm, ctx.senders_sorted, N, weights=weights)
    # What the wrapper takes on the CPU, in either walk.
    for pieces in (True, False):
        got = spmm_cuda.gather_scatter_sum_sorted(
            v, ctx.bwd_perm, ctx.senders_sorted, ctx.row_ptr_bwd, N,
            weights=weights, pieces=pieces)
        assert torch.equal(got, plain)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    _held(walked, plain.float().numpy(), tol, "walk vs plain")
    with pltpu.force_tpu_interpret_mode():
        ref = spmm_pallas.scatter_sum_sorted(
            jnp.take(jnp.asarray(v.float().numpy()),
                     jnp.asarray(ctx.bwd_perm.numpy()), axis=0),
            jnp.asarray(ctx.senders_sorted.numpy()), N,
            weights=None if weights is None else jnp.asarray(weights.numpy()),
            precision=jax.lax.Precision.HIGHEST)
    _held(walked, ref, tol, "walk vs the Pallas scatter")


@pytest.mark.parametrize("orientation", ["senders", "receivers"])
def test_piecewise_gcn_spmm_with_its_diagonal_equals_the_plain_version(
        orientation):
    """The GCN's fused gather (weights and the densified diagonal's
    epilogue) in both orientations, over a stream whose padded tail (weight
    0) sits in the last row of each."""
    rng = np.random.default_rng(5)
    a, b = rng.integers(0, N, 700), rng.integers(0, N, 700)
    edges = np.stack([np.concatenate([a, b]), np.concatenate([b, a])])
    c = kgt.prepare_graph(edges.astype(np.int32), N, add_self_loops=True,
                          gcn_normalize=True, symmetric=True,
                          densify_self_loops=True, edge_chunk=512,
                          device="cpu")
    h = torch.from_numpy(rng.standard_normal((N, 8)).astype(np.float32))
    if orientation == "senders":
        idx, rows, row_ptr, w = (c.receivers_ss, c.senders_sorted,
                                 c.row_ptr_bwd, c.edge_weight_ss)
    else:
        idx, rows, row_ptr, w = c.senders, c.receivers, c.row_ptr, c.edge_weight
    work = spmm_cuda.recv_bwd_work(row_ptr)
    assert N - 1 in work.fix_rows.tolist()  # the padded tail is split
    walked = _finish_walk(h, idx, w, c.self_weight, work, N)
    plain = spmm_cuda.gather_scatter_sum_sorted_plain(
        h, idx, rows, N, weights=w, self_weight=c.self_weight)
    _held(walked, plain.numpy(), 1e-5)


def test_rows_that_are_one_piece_sum_as_a_row_walk_bit_for_bit(ctx):
    """A row of at most PIECE slots is one piece, summed in slot order as a
    walk of the whole row sums it; only split rows sum in another order."""
    rng = np.random.default_rng(9)
    v = torch.from_numpy(rng.standard_normal(
        (ctx.senders.shape[0], 6)).astype(np.float32))
    split = spmm_cuda.recv_bwd_work(ctx.row_ptr_bwd)
    whole = spmm_cuda.recv_bwd_work(ctx.row_ptr_bwd, HUB + TAIL)
    assert whole.num_shares == 0
    a = _finish_walk(v, ctx.bwd_perm, None, None, split, N)
    b = _finish_walk(v, ctx.bwd_perm, None, None, whole, N)
    one = np.diff(ctx.row_ptr_bwd.numpy()) <= PIECE
    assert torch.equal(a[one], b[one])


def _stats(ctx, t):
    """The forward's m, l and rho over the receiver-sorted stream."""
    graph = (ctx.senders, ctx.receivers, ctx.row_ptr)
    _, scores, m, l = attend_cuda.sddmm_stats_agg_sorted_plain(
        t["ht"], *graph, t["att"], edge_valid=ctx.edge_mask,
        drop_mask=t["drop"], negative_slope=SLOPE, eps=EPS)
    rho = attend_cuda.attend_rho_sorted_plain(
        t["g"], scores, m, l, t["ht"], *graph, eps=EPS, drop_mask=t["drop"])
    return m, l, rho


def _send_walk(ctx, t, m, l, rho, drop_ss, work):
    """K10d's piece walk in plain torch: per slot of a sender j's piece with
    receiver r, alpha * keep * g[r] + d_pre recomputed from ht[r], ht[j],
    att and the receiver's (m, l, rho); a padded slot adds nothing."""
    ht, g, att = t["ht"], t["g"], t["att"]
    r_ss = ctx.receivers_ss.long()
    s_ss = ctx.senders_sorted.long()
    valid = ctx.edge_mask_ss

    def terms(lo, hi):
        r, j = r_ss[lo:hi], s_ss[lo:hi]
        hr = ht[r].view(-1, HEADS, F)
        hs = ht[j].view(-1, HEADS, F)
        gr = g[r].view(-1, HEADS, F)
        pre = hr + hs
        s = (att * torch.where(pre > 0, pre, SLOPE * pre)).sum(-1)
        alpha = torch.exp(torch.clamp(s - m[r], max=0.0)) / (l[r] + EPS)
        keep = torch.ones_like(alpha) if drop_ss is None else drop_ss[lo:hi]
        dalpha = (gr * hs).sum(-1)
        ds = alpha * (keep * dalpha - rho[r])
        d_pre = ds[..., None] * att * torch.where(pre > 0, 1.0, SLOPE)
        term = ((alpha * keep)[..., None] * gr + d_pre).reshape(-1, HEADS * F)
        return [term[i] for i in range(hi - lo) if valid[lo + i] != 0]

    return _walk(work, N, HEADS * F, terms)


@pytest.mark.parametrize("drop", [False, True], ids=["nodrop", "drop"])
def test_piecewise_sender_backward_equals_the_plain_version_and_jax(ctx,
                                                                   drop):
    rng = np.random.default_rng(11)
    e, d = ctx.senders.shape[0], HEADS * F
    c = dict(ht=0.5 * rng.standard_normal((N, d)),
             att=0.5 * rng.standard_normal((HEADS, F)),
             g=rng.standard_normal((N, d)),
             drop=((rng.random((e, HEADS)) < 0.7) / 0.7) if drop else None)
    c = {k: None if a is None else a.astype(np.float32) for k, a in c.items()}
    t = {k: None if a is None else torch.from_numpy(a) for k, a in c.items()}
    m, l, rho = _stats(ctx, t)
    perm = ctx.bwd_perm.long()
    drop_ss = None if t["drop"] is None else t["drop"][perm]
    work = spmm_cuda.recv_bwd_work(ctx.row_ptr_bwd)
    walked = _send_walk(ctx, t, m, l, rho, drop_ss, work)
    args = (t["ht"], t["g"], ctx.receivers_ss, ctx.senders_sorted,
            ctx.row_ptr_bwd, t["att"], m, l, rho)
    kw = dict(eps=EPS, negative_slope=SLOPE, valid_ss=ctx.edge_mask_ss,
              drop_ss=drop_ss)
    plain = attend_cuda.attend_send_bwd_sorted_plain(*args, **kw)
    assert torch.equal(attend_cuda.attend_send_bwd_sorted(*args, **kw), plain)
    _held(walked, plain.numpy(), 1e-4, "walk vs plain")
    # The permute finish gives the same: v summed by sender.
    _, _, v = attend_cuda.attend_recv_bwd_full_sorted_plain(
        t["ht"], t["g"], ctx.senders, ctx.receivers, ctx.row_ptr, t["att"],
        None, m, l, rho, eps=EPS, negative_slope=SLOPE, drop_mask=t["drop"],
        edge_valid=ctx.edge_mask)
    _held(walked, _finish_walk(v, ctx.bwd_perm, None, None, work, N).numpy(),
          1e-4, "walk vs the permute finish's walk")

    # The reference, fed the receivers' rows and statistics as its ops/csr.py
    # gathers them (chained takes).
    r_ss = jnp.asarray(ctx.receivers_ss.numpy())
    ht_j, g_j = jnp.asarray(c["ht"]), jnp.asarray(c["g"])
    stats = jnp.concatenate([jnp.asarray(m.numpy()), jnp.asarray(l.numpy()),
                             jnp.asarray(rho.numpy())], axis=1)
    g_r = jnp.take(g_j, r_ss, axis=0)
    ht_r = jnp.take(ht_j, chain_after(r_ss, g_r), axis=0)
    stats_r = jnp.take(stats, chain_after(r_ss, ht_r), axis=0)
    bwd_tables = spmm_pallas.build_row_tables(
        ctx.senders_sorted.numpy(), N, edge_chunk=128, row_block=32)
    with pltpu.force_tpu_interpret_mode():
        ref = attend_pallas.attend_send_bwd_sorted(
            ht_j, g_r, ht_r, stats_r, jnp.asarray(c["att"]),
            tables=bwd_tables, eps=EPS, negative_slope=SLOPE,
            valid_ss=jnp.asarray(ctx.edge_mask_ss.numpy()),
            drop_ss=None if drop_ss is None else jnp.asarray(drop_ss.numpy()))
    _held(walked, np.asarray(ref)[:N], 1e-4, "walk vs the Pallas kernel")


def test_cpu_wrappers_count_no_launch(ctx):
    spmm_cuda.reset_launch_counts()
    attend_cuda.reset_launch_counts()
    v = torch.ones(ctx.senders.shape[0], 3)
    for pieces in (True, False):
        spmm_cuda.gather_scatter_sum_sorted(
            v, ctx.bwd_perm, ctx.senders_sorted, ctx.row_ptr_bwd, N,
            pieces=pieces)
    assert not any(spmm_cuda.LAUNCH_COUNTS.values())
    assert not any(spmm_cuda.MODE_LAUNCH_COUNTS.values())
    assert "gather_scatter_sum_sorted(rows)" in spmm_cuda.MODE_LAUNCH_COUNTS
    spmm_cuda.MODE_LAUNCH_COUNTS["gather_scatter_sum_sorted(rows)"] = 3
    spmm_cuda.reset_launch_counts()
    assert not any(spmm_cuda.MODE_LAUNCH_COUNTS.values())


def test_each_caller_takes_its_walk(monkeypatch):
    """The choice of walk is made per caller: the GCN's operator (both
    orientations) takes the row walk, the gather's VJP and the attention's
    permute finish the piece walk."""
    from keras_geometric_tpu_torch.ops import csr

    taken = []
    real = spmm_cuda.gather_scatter_sum_sorted

    def spy(*args, **kwargs):
        taken.append(kwargs.get("pieces", True))
        return real(*args, **kwargs)

    monkeypatch.setattr(spmm_cuda, "gather_scatter_sum_sorted", spy)
    rng = np.random.default_rng(13)
    a, b = rng.integers(0, N, 300), rng.integers(0, N, 300)
    sym = np.stack([np.concatenate([a, b]), np.concatenate([b, a])])
    h = torch.randn(N, 4, dtype=torch.float32, requires_grad=True)
    for kwargs, edges in ((dict(symmetric=True, densify_self_loops=True), sym),
                          ({}, np.stack([a, b]))):
        c = kgt.prepare_graph(edges.astype(np.int32), N, add_self_loops=True,
                              gcn_normalize=True, device="cpu", **kwargs)
        taken.clear()
        c.spmm(h).sum().backward()
        assert taken == [False, False]
    c = kgt.prepare_graph(np.stack([a, b]).astype(np.int32), N, device="cpu")
    taken.clear()
    c.gather(h).sum().backward()
    assert taken == [True]
    c = kgt.prepare_graph(np.stack([a, b]).astype(np.int32), N,
                          add_self_loops=True, device="cpu")
    ht = torch.randn(N, HEADS * F, requires_grad=True)
    att = torch.randn(HEADS, F, requires_grad=True)
    taken.clear()
    c.attend(ht, att).sum().backward()
    assert taken == [True]
