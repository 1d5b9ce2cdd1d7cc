"""The host side of the band kernel's routes and of the attention kernels'
work list, and the forward, rho and the receiver backward walked in pieces.

``band_route`` picks the banded SpMM's instantiation from the type and the
shapes alone: the TMA + wgmma kernel for bf16 at row blocks of 256 and ``W %
64 == 0`` (``x`` by its tensor map where ``F % 8 == 0``, by 1-D copies at any
other ``F``), the wmma kernel for any other bf16 shape, the FMA kernel for
f32.

``recv_bwd_work`` cuts the receiver-sorted stream into pieces of at most
``piece`` slots, so that no group of the forward (K9), rho (K10b) or the
receiver backward (K10c) walks a long row serially. The graph here has a
5,000-slot hub row and a 511-slot padded tail in the last row (as
``prepare_graph`` pads a stream). Plain emulations of the kernels' walks,
each piece alone and a split row's pieces combined in piece order (K9: the
flash-decoding merge of each piece's ``(m_p, l_p, o_p)``, skipping a piece
without a finite score; K10b and K10c: the sum of the shares), are held
against the plain versions and the JAX package's Pallas kernels in
interpret mode (f32: 1e-4, the reference's two-pass bf16 split of f32
operands; bf16: 2e-2; sums held against their largest entry). The padded
tail row, whose real slots all lie in its first piece, gets its unsplit
result bit for bit.

The ``cuda``-marked tests run the kernels on a card: the wgmma band kernel at
F = 40 and 128 (``x`` by its tensor map) and at F = 7 (``x`` by 1-D copies)
against the plain version; the
forward, rho and the receiver backward on the hub graph in every mode,
against their plain versions, recomputed scores giving the cached scores'
results bit for bit and two launches giving the same bits; and the
forward's scores, ``m`` and ``l`` equal to the score-and-statistics
kernel's bit for bit on every row (both walk the same pieces and merge a
split row in piece order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from keras_geometric_tpu.kernels import attend_pallas, sddmm_pallas, spmm_pallas
from keras_geometric_tpu_torch.kernels import attend_cuda, band_cuda, sddmm_cuda

torch.set_num_threads(1)

SLOPE, EPS = 0.2, 1e-10
HUB, TAIL = 5_000, 511


@pytest.mark.parametrize("f,window,row_block,dtype,route", [
    (128, 1024, 256, torch.bfloat16, "wgmma"),
    (40, 1024, 256, torch.bfloat16, "wgmma"),
    (8, 512, 256, torch.bfloat16, "wgmma"),
    (256, 1024, 256, torch.bfloat16, "wgmma"),
    (7, 1024, 256, torch.bfloat16, "wgmma_flat"),
    (1, 1024, 256, torch.bfloat16, "wgmma_flat"),
    (44, 1024, 256, torch.bfloat16, "wgmma_flat"),
    (128, 1024, 128, torch.bfloat16, "wmma"),
    (128, 288, 256, torch.bfloat16, "wmma"),
    (128, 1024, 256, torch.float32, "fma"),
    (40, 512, 256, torch.float32, "fma"),
])
def test_band_route_follows_type_and_shapes(f, window, row_block, dtype,
                                            route):
    assert band_cuda.band_route(f, window, row_block, dtype) == route


def test_band_route_refuses_other_types():
    with pytest.raises(TypeError):
        band_cuda.band_route(8, 1024, 256, torch.float16)


def test_band_matmul_on_the_cpu_counts_no_route():
    plan, _ = band_cuda.build_band_plan(np.array([0, 1]), np.array([1, 0]),
                                        None, 1_024, window=512)
    band_cuda.reset_launch_counts()
    x = torch.ones(1_024, 8, dtype=torch.bfloat16)
    y = band_cuda.band_matmul(x, plan.band.to(torch.bfloat16), plan.base_idx,
                              512, 256)
    assert y[0].tolist() == [1.0] * 8 and y[1].tolist() == [1.0] * 8
    assert not any(band_cuda.MODE_LAUNCH_COUNTS.values())
    assert set(band_cuda.MODE_LAUNCH_COUNTS) == {
        "band_spmm(wgmma)", "band_spmm(wgmma_flat)", "band_spmm(wmma)",
        "band_spmm(fma)"}


def _hub_graph(seed=0, n=64, hub_row=7, others=249):
    """Receiver-sorted stream: row ``hub_row`` has HUB slots, the others
    share ``others`` random slots (some rows stay empty), and TAIL padded
    slots sit in the last row, as prepare_graph pads a stream; the slot count
    is a multiple of 128."""
    rng = np.random.default_rng(seed)
    allowed = np.array([i for i in range(n) if i % 5 != 2 and i != hub_row])
    recv = np.sort(np.concatenate([
        rng.choice(allowed, others), np.full(HUB, hub_row)])).astype(np.int32)
    e_real = recv.shape[0]
    recv = np.concatenate([recv, np.full(TAIL, n - 1, np.int32)])
    send = rng.integers(0, n, recv.shape[0]).astype(np.int32)
    send[e_real:] = n - 1
    valid = np.arange(recv.shape[0]) < e_real
    row_ptr = np.searchsorted(recv, np.arange(n + 1)).astype(np.int32)
    return n, recv, send, valid, row_ptr


def test_hub_graph_has_the_shape_the_tests_need():
    n, recv, send, valid, row_ptr = _hub_graph()
    lengths = np.diff(row_ptr)
    assert recv.shape[0] % 128 == 0
    assert lengths.max() == HUB and (~valid).sum() == TAIL
    assert lengths[-1] >= TAIL and (lengths == 0).any()


@pytest.mark.parametrize("piece", [1, 7, 32, 64, 511, 5_000, 6_000])
def test_recv_bwd_work_covers_every_slot_once_in_order(piece):
    n, _, _, _, row_ptr = _hub_graph()
    work = attend_cuda.recv_bwd_work(torch.from_numpy(row_ptr), piece)
    p = work.pieces.numpy()
    rows, lo, hi, share = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
    # Every row has a piece, rows in order; within a row the pieces tile
    # its slots in order; every slot once.
    assert np.array_equal(np.unique(rows), np.arange(n))
    assert np.all(np.diff(rows) >= 0)
    assert np.all(hi - lo <= piece) and np.all(hi >= lo)
    assert np.array_equal(lo[1:], hi[:-1]) and lo[0] == 0
    assert hi[-1] == row_ptr[-1]
    for r in range(n):
        mine = rows == r
        assert lo[mine][0] == row_ptr[r] and hi[mine][-1] == row_ptr[r + 1]
        assert np.all(hi[mine][:-1] - lo[mine][:-1] == piece)
    # Shares: -1 for a whole row, else consecutive per split row, matching
    # fix_rows / fix_ptr.
    counts = np.bincount(rows, minlength=n)
    split_rows = np.nonzero(counts > 1)[0]
    assert np.array_equal(work.fix_rows.numpy(), split_rows)
    assert np.all(share[counts[rows] == 1] == -1)
    shares = share[counts[rows] > 1]
    assert np.array_equal(shares, np.arange(shares.shape[0]))
    assert work.num_shares == shares.shape[0]
    ptr = work.fix_ptr.numpy()
    assert ptr[0] == 0 and np.array_equal(np.diff(ptr), counts[split_rows])
    assert work.pieces.dtype == torch.int32 and work.pieces.is_contiguous()
    if piece < TAIL:
        assert n - 1 in split_rows and 7 in split_rows


def test_recv_bwd_work_is_kept_with_its_row_ptr():
    _, _, _, _, row_ptr = _hub_graph()
    rp = torch.from_numpy(row_ptr)
    first = attend_cuda.recv_bwd_work(rp)
    assert attend_cuda.recv_bwd_work(rp) is first
    assert first.piece == attend_cuda.RECV_BWD_PIECE
    assert attend_cuda.recv_bwd_work(rp, 64) is not first
    rp.add_(0)  # a write to row_ptr builds the list anew
    assert attend_cuda.recv_bwd_work(rp, 64).pieces.shape[0] < (
        first.pieces.shape[0])


def _inputs(seed, n, e, heads, f, drop):
    rng = np.random.default_rng(seed)
    d = heads * f
    return dict(
        ht=rng.standard_normal((n, d)).astype(np.float32),
        att=rng.standard_normal((heads, f)).astype(np.float32),
        g=rng.standard_normal((n, d)).astype(np.float32),
        drop=((rng.random((e, heads)) < 0.7) / 0.7).astype(np.float32)
        if drop else None,
    )


def _piecewise_recv_bwd(ht, g, send, att, scores, m, l, rho, work, drop):
    """The kernel's walk in plain torch: each piece sums its slots' d_pre in
    f32 alone; a whole-row piece is its row's dht, a split row's dht is its
    pieces' shares added in piece order; v per slot (0 on a padded slot);
    datt over every slot."""
    n, d = ht.shape
    heads, f = att.shape
    dht = torch.zeros(n, d)
    v = torch.zeros(send.shape[0], d)
    datt = torch.zeros(heads, f)
    shares = torch.zeros(work.num_shares, d)
    for row, lo, hi, share in work.pieces.tolist():
        acc = torch.zeros(heads, f)
        hi_row = ht[row].view(heads, f)
        g_row = g[row].view(heads, f)
        for e in range(lo, hi):
            s = scores[e]
            live = s > -np.inf
            if not live.any():
                continue  # a padded slot: v stays 0
            hj = ht[send[e]].view(heads, f)
            keep = torch.ones(heads) if drop is None else drop[e]
            alpha = torch.where(live, torch.exp(s - m[row]), 0.0) / (
                l[row] + EPS)
            dalpha = (g_row * hj).sum(-1)
            ds = alpha * (keep * dalpha - rho[row])
            pre = hi_row + hj
            d_pre = ds[:, None] * att * torch.where(pre > 0, 1.0, SLOPE)
            acc += d_pre
            datt += torch.where(pre > 0, pre, SLOPE * pre) * ds[:, None]
            v[e] = ((alpha * keep)[:, None] * g_row + d_pre).flatten()
        if share < 0:
            dht[row] = acc.flatten()
        else:
            shares[share] = acc.flatten()
    for k, row in enumerate(work.fix_rows.tolist()):
        total = torch.zeros(d)
        for p in range(int(work.fix_ptr[k]), int(work.fix_ptr[k + 1])):
            total = total + shares[p]
        dht[row] = total
    return dht, datt, v


@pytest.mark.parametrize("drop", [False, True], ids=["nodrop", "drop"])
def test_piecewise_walk_equals_the_plain_version_and_jax(drop):
    heads, f = 2, 4
    n, recv, send, valid, row_ptr = _hub_graph(seed=3)
    e = recv.shape[0]
    c = _inputs(11, n, e, heads, f, drop)
    t = {k: None if a is None else torch.from_numpy(a) for k, a in c.items()}
    graph = (torch.from_numpy(send), torch.from_numpy(recv),
             torch.from_numpy(row_ptr))
    _, scores, m, l = attend_cuda.sddmm_stats_agg_sorted_plain(
        t["ht"], *graph, t["att"], edge_valid=torch.from_numpy(valid),
        drop_mask=t["drop"], negative_slope=SLOPE, eps=EPS)
    rho = attend_cuda.attend_rho_sorted_plain(
        t["g"], scores, m, l, t["ht"], *graph, eps=EPS, drop_mask=t["drop"])
    plain = attend_cuda.attend_recv_bwd_full_sorted_plain(
        t["ht"], t["g"], *graph, t["att"], scores, m, l, rho, eps=EPS,
        negative_slope=SLOPE, drop_mask=t["drop"])
    work = attend_cuda.recv_bwd_work(graph[2], attend_cuda.RECV_BWD_PIECE)
    walked = _piecewise_recv_bwd(t["ht"], t["g"], send, t["att"], scores, m,
                                 l, rho, work, t["drop"])
    for got, want in zip(walked, plain):
        scale = max(1.0, float(want.abs().max()))
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5 * scale)
    assert not walked[2][~torch.from_numpy(valid)].any()

    tables = spmm_pallas.build_row_tables(recv, n, edge_chunk=128,
                                          row_block=32)
    ht_j = jnp.asarray(c["ht"])
    hj = jnp.take(ht_j, jnp.asarray(send), axis=0)
    drop_j = None if c["drop"] is None else jnp.asarray(c["drop"])
    with pltpu.force_tpu_interpret_mode():
        _, j_scores, j_m, j_l = sddmm_pallas.sddmm_stats_agg_sorted(
            ht_j, hj, jnp.asarray(c["att"]), tables=tables, num_nodes=n,
            edge_valid=jnp.asarray(valid), negative_slope=SLOPE, eps=EPS,
            drop_mask=drop_j)
        j_rho = attend_pallas.attend_rho_sorted(
            jnp.asarray(c["g"]), j_scores, j_m, j_l, hj, tables=tables,
            eps=EPS, drop_mask=drop_j)
        ref = attend_pallas.attend_recv_bwd_full_sorted(
            ht_j, jnp.asarray(c["g"]), hj, jnp.asarray(c["att"]), j_scores,
            j_m, j_l, j_rho, tables=tables, eps=EPS, negative_slope=SLOPE,
            drop_mask=drop_j)
    ref_dht, ref_datt, ref_v = (np.asarray(a, np.float32) for a in ref)
    for got, want in ((walked[0], ref_dht[:n]), (walked[1], ref_datt),
                      (walked[2], ref_v)):
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [40, 128, 7])
def test_cuda_band_routes_match_plain_version(f):
    """On a card: the banded SpMM at the arxiv widths (the wgmma route) and
    at F = 7 (the wgmma_flat route, and the wmma kernel on the same inputs),
    over a band whose last row block's window reaches the array's end,
    against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(f)
    n_pad, window = 4_096, 1_024
    s = rng.integers(0, n_pad, 40_000)
    r = np.clip(s + rng.integers(-400, 400, s.shape[0]), 0, n_pad - 1)
    plan, _ = band_cuda.build_band_plan(s, r, None, n_pad, window=window)
    band = plan.band.to(dev, torch.bfloat16)
    base_idx = plan.base_idx.to(dev)
    x = torch.from_numpy(rng.standard_normal((n_pad, f)).astype(
        np.float32)).to(dev, torch.bfloat16)
    band_cuda.reset_launch_counts()
    got = band_cuda.band_matmul(x, band, base_idx, window, 256)
    again = band_cuda.band_matmul(x, band, base_idx, window, 256)
    want = band_cuda.band_matmul_plain(x, band, base_idx, window, 256)
    torch.cuda.synchronize()
    route = "wgmma" if f % 8 == 0 else "wgmma_flat"
    assert band_cuda.MODE_LAUNCH_COUNTS[f"band_spmm({route})"] == 2
    assert torch.equal(got, again)
    mass = band_cuda.band_matmul_plain(x.abs(), band.abs(), base_idx, window,
                                       256).float()
    err = (got.float() - want.float()).abs()
    assert bool((err <= 2.0 ** -7 * mass + 1e-6).all())
    if f % 8:
        wmma = band_cuda._band_matmul_on("wmma", x, band, base_idx, window,
                                         256)
        torch.cuda.synchronize()
        assert band_cuda.MODE_LAUNCH_COUNTS["band_spmm(wmma)"] == 1
        err = (wmma.float() - want.float()).abs()
        assert bool((err <= 2.0 ** -7 * mass + 1e-6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,f", [(4, 64), (8, 6), (1, 320)])
def test_cuda_recv_bwd_on_the_hub_graph(heads, f, dtype):
    """On a card, over the hub row and the padded tail: the forward and rho
    that feed the receiver backward, in every mode
    (``_check_forward_and_rho_on_card``); then the receiver backward in
    every mode, against the plain version; scores recomputed inside the
    kernel give the cached scores' dht, datt and v bit for bit; two launches
    give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    n, recv, send, valid, row_ptr = _hub_graph(seed=5)
    e = recv.shape[0]
    c = _inputs(17, n, e, heads, f, True)
    t = {k: torch.from_numpy(a).to(dev, dtype) for k, a in c.items()}
    graph = tuple(torch.from_numpy(a).to(dev) for a in (send, recv, row_ptr))
    edge_valid = torch.from_numpy(valid).to(dev)
    _check_forward_and_rho_on_card(t, graph, edge_valid, row_ptr, dtype)
    _, scores, m, l = attend_cuda.sddmm_stats_agg_sorted(
        t["ht"], *graph, t["att"], edge_valid=edge_valid, drop_mask=t["drop"])
    rho = attend_cuda.attend_rho_sorted(t["g"], scores, m, l, t["ht"], *graph,
                                        drop_mask=t["drop"])
    args = (t["ht"], t["g"], *graph, t["att"])
    kw = dict(drop_mask=t["drop"])
    cached = attend_cuda.attend_recv_bwd_full_sorted(
        *args, scores, m, l, rho, **kw)
    again = attend_cuda.attend_recv_bwd_full_sorted(
        *args, scores, m, l, rho, **kw)
    recomputed = attend_cuda.attend_recv_bwd_full_sorted(
        *args, None, m, l, rho, edge_valid=edge_valid, **kw)
    no_v = attend_cuda.attend_recv_bwd_full_sorted(
        *args, None, m, l, rho, edge_valid=edge_valid, emit_v=False, **kw)
    plain = attend_cuda.attend_recv_bwd_full_sorted_plain(
        *args, scores, m, l, rho, **kw)
    torch.cuda.synchronize()
    for a, b, r, p in zip(cached, again, recomputed, plain):
        assert torch.equal(a, b) and torch.equal(a, r)
        scale = max(1.0, float(p.float().abs().max()))
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        np.testing.assert_allclose(a.float().cpu().numpy(),
                                   p.float().cpu().numpy(), rtol=tol,
                                   atol=tol * scale)
    assert torch.equal(no_v[0], cached[0]) and torch.equal(no_v[1], cached[1])
    assert not cached[2][~edge_valid].any()


def _one_piece_rows(row_ptr, valid, piece):
    """Rows whose valid slots all lie in one piece of ``piece`` slots (or
    that have none)."""
    rows = np.zeros(row_ptr.shape[0] - 1, bool)
    for r in range(rows.shape[0]):
        at = np.nonzero(valid[row_ptr[r]:row_ptr[r + 1]])[0] // piece
        rows[r] = at.size == 0 or at.min() == at.max()
    return rows


def _piecewise_forward(ht, send, att, valid, drop, work):
    """K9's walk in plain torch: each piece runs the online softmax over its
    valid slots alone, in slot order; a whole-row piece gives its row's out,
    m and l; a split row merges its pieces' (m_p, l_p, o_p) in piece order,
    skipping a piece without a finite score. Scores are -inf on padded
    slots."""
    n, d = ht.shape
    heads, f = att.shape
    out = torch.zeros(n, heads, f)
    m_out = torch.zeros(n, heads)
    l_out = torch.zeros(n, heads)
    scores = torch.full((send.shape[0], heads), -np.inf)
    parts = [None] * work.num_shares
    for row, lo, hi, share in work.pieces.tolist():
        m = torch.full((heads,), -np.inf)
        l = torch.zeros(heads)
        o = torch.zeros(heads, f)
        hi_row = ht[row].view(heads, f)
        for e in range(lo, hi):
            if not valid[e]:
                continue  # never gathered
            hj = ht[send[e]].view(heads, f)
            pre = hi_row + hj
            s = (att * torch.where(pre > 0, pre, SLOPE * pre)).sum(-1)
            scores[e] = s
            keep = torch.ones(heads) if drop is None else drop[e]
            m_new = torch.maximum(m, s)
            scale = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * scale + p
            o = o * scale[:, None] + (p * keep)[:, None] * hj
            m = m_new
        if share >= 0:
            parts[share] = (m, l, o)
            continue
        out[row] = o / (l + EPS)[:, None]
        m_out[row] = torch.where(m > -np.inf, m, 0.0)
        l_out[row] = l
    for k, row in enumerate(work.fix_rows.tolist()):
        mine = parts[int(work.fix_ptr[k]):int(work.fix_ptr[k + 1])]
        m = torch.stack([mp for mp, _, _ in mine]).max(0).values
        l = torch.zeros(heads)
        o = torch.zeros(heads, f)
        for mp, lp, op in mine:
            live = mp > -np.inf
            w = torch.exp(mp - m)
            l = torch.where(live, l + lp * w, l)
            o = torch.where(live[:, None], o + op * w[:, None], o)
        out[row] = o / (l + EPS)[:, None]
        m_out[row] = torch.where(m > -np.inf, m, 0.0)
        l_out[row] = l
    return out.reshape(n, d), scores, m_out, l_out


def _piecewise_rho(g, ht, send, scores, m, l, drop, work):
    """K10b's walk in plain torch: each piece sums alpha * keep * dalpha over
    its slots with a finite score alone; a split row's rho is its pieces'
    shares added in piece order."""
    n, d = ht.shape
    heads = m.shape[1]
    f = d // heads
    rho = torch.zeros(n, heads)
    shares = torch.zeros(work.num_shares, heads)
    for row, lo, hi, share in work.pieces.tolist():
        acc = torch.zeros(heads)
        g_row = g[row].view(heads, f)
        for e in range(lo, hi):
            s = scores[e]
            if not (s > -np.inf).any():
                continue  # a padded slot: never gathered
            hj = ht[send[e]].view(heads, f)
            alpha = torch.exp(s - m[row]) / (l[row] + EPS)
            keep = torch.ones(heads) if drop is None else drop[e]
            acc = acc + alpha * keep * (g_row * hj).sum(-1)
        if share < 0:
            rho[row] = acc
        else:
            shares[share] = acc
    for k, row in enumerate(work.fix_rows.tolist()):
        total = torch.zeros(heads)
        for p in range(int(work.fix_ptr[k]), int(work.fix_ptr[k + 1])):
            total = total + shares[p]
        rho[row] = total
    return rho


def _held(got, want, tol, what):
    """Equal -inf entries, the rest within ``tol`` of the largest entry."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert np.array_equal(np.isneginf(got), np.isneginf(want)), what
    got, want = (np.where(np.isneginf(a), 0.0, a) for a in (got, want))
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


@pytest.mark.parametrize("drop", [False, True], ids=["nodrop", "drop"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_piecewise_forward_and_rho_equal_the_plain_versions_and_jax(dtype,
                                                                    drop):
    heads, f = 2, 4
    n, recv, send, valid, row_ptr = _hub_graph(seed=7)
    e = recv.shape[0]
    c = _inputs(13, n, e, heads, f, drop)
    # The inputs rounded to the working type; the walks sum in f32.
    t = {k: None if a is None else
         torch.from_numpy(a).to(getattr(torch, dtype)).float()
         for k, a in c.items()}
    graph = (torch.from_numpy(send), torch.from_numpy(recv),
             torch.from_numpy(row_ptr))
    work = attend_cuda.recv_bwd_work(graph[2])
    assert work.fix_rows.tolist() == [7, n - 1]  # the hub and the tail
    walked = _piecewise_forward(t["ht"], send, t["att"], valid, t["drop"],
                                work)
    plain = attend_cuda.sddmm_stats_agg_sorted_plain(
        t["ht"], *graph, t["att"], edge_valid=torch.from_numpy(valid),
        drop_mask=t["drop"], negative_slope=SLOPE, eps=EPS)
    for got, want, what in zip(walked, plain, ("out", "scores", "m", "l")):
        _held(got.numpy(), want.numpy(), 1e-4, f"{what} against plain")
    _, scores, m, l = plain
    rho = _piecewise_rho(t["g"], t["ht"], send, scores, m, l, t["drop"],
                         work)
    _held(rho.numpy(), attend_cuda.attend_rho_sorted_plain(
        t["g"], scores, m, l, t["ht"], *graph, eps=EPS,
        drop_mask=t["drop"]).numpy(), 1e-4, "rho against plain")

    tables = spmm_pallas.build_row_tables(recv, n, edge_chunk=128,
                                          row_block=32)
    jd = jnp.dtype(dtype)
    ht_j = jnp.asarray(c["ht"]).astype(jd)
    hj = jnp.take(ht_j, jnp.asarray(send), axis=0)
    drop_j = None if c["drop"] is None else jnp.asarray(c["drop"]).astype(jd)
    with pltpu.force_tpu_interpret_mode():
        j_out, j_scores, j_m, j_l = sddmm_pallas.sddmm_stats_agg_sorted(
            ht_j, hj, jnp.asarray(c["att"]).astype(jd), tables=tables,
            num_nodes=n, edge_valid=jnp.asarray(valid), negative_slope=SLOPE,
            eps=EPS, drop_mask=drop_j)
        j_rho = attend_pallas.attend_rho_sorted(
            jnp.asarray(c["g"]).astype(jd), j_scores, j_m, j_l, hj,
            tables=tables, eps=EPS, drop_mask=drop_j)
    tol = 1e-4 if dtype == "float32" else 2e-2
    for got, want, what in zip(walked + (rho,),
                               (j_out[:n], j_scores, j_m, j_l, j_rho[:n]),
                               ("out", "scores", "m", "l", "rho")):
        _held(got.numpy(), np.asarray(want.astype(jnp.float32)), tol,
              f"{what} against the Pallas kernel")


@pytest.mark.parametrize("drop", [False, True], ids=["nodrop", "drop"])
def test_rows_whose_scores_lie_in_one_piece_merge_bit_for_bit(drop):
    """The piecewise walk against the same walk with every row one piece:
    every row whose finite scores lie in one piece (the padded tail row
    among them) bit for bit, the split hub row to rounding."""
    heads, f = 2, 4
    n, recv, send, valid, row_ptr = _hub_graph(seed=7)
    c = _inputs(21, n, recv.shape[0], heads, f, drop)
    t = {k: None if a is None else torch.from_numpy(a) for k, a in c.items()}
    rp = torch.from_numpy(row_ptr)
    split = attend_cuda.recv_bwd_work(rp)
    whole = attend_cuda.recv_bwd_work(rp, HUB + TAIL)
    assert whole.num_shares == 0 and split.num_shares > 0
    one = _one_piece_rows(row_ptr, valid, attend_cuda.RECV_BWD_PIECE)
    assert one[n - 1] and not one[7]  # the padded tail, the hub
    a = _piecewise_forward(t["ht"], send, t["att"], valid, t["drop"], split)
    b = _piecewise_forward(t["ht"], send, t["att"], valid, t["drop"], whole)
    assert torch.equal(a[1], b[1])  # scores: per slot
    for x, y in zip(a[:1] + a[2:], b[:1] + b[2:]):
        assert torch.equal(x[one], y[one])
        _held(x.numpy(), y.numpy(), 1e-5, "the hub row")
    rho_a = _piecewise_rho(t["g"], t["ht"], send, a[1], a[2], a[3],
                           t["drop"], split)
    rho_b = _piecewise_rho(t["g"], t["ht"], send, a[1], a[2], a[3],
                           t["drop"], whole)
    assert torch.equal(rho_a[one], rho_b[one])
    _held(rho_a.numpy(), rho_b.numpy(), 1e-5, "the hub row's rho")
    empty = np.diff(row_ptr) == 0
    assert empty.any() and not a[0][empty].any() and not a[2][empty].any()
    assert not a[3][empty].any() and not rho_a[empty].any()


def _check_forward_and_rho_on_card(t, graph, edge_valid, row_ptr, dtype):
    """The forward (with and without its scores) and rho (cached and
    recomputed) on a card over the hub row and the padded tail, with and
    without dropout, against their plain versions; two launches give the
    same bits, the recomputed rho the cached one's; the scores, m and l
    equal the score-and-statistics kernel's bit for bit on every row (it
    walks the same pieces and merges split rows the same way); empty rows
    are zeros."""
    empty = torch.from_numpy(np.diff(row_ptr) == 0).to(edge_valid.device)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    args = (t["ht"], *graph, t["att"])
    for drop in (None, t["drop"]):
        kw = dict(edge_valid=edge_valid, drop_mask=drop)
        fwd = attend_cuda.sddmm_stats_agg_sorted(*args, **kw)
        again = attend_cuda.sddmm_stats_agg_sorted(*args, **kw)
        no_scores = attend_cuda.sddmm_stats_agg_sorted(*args,
                                                       emit_scores=False, **kw)
        plain = attend_cuda.sddmm_stats_agg_sorted_plain(*args, **kw)
        s8, m8, l8 = sddmm_cuda.sddmm_stats_sorted(*args,
                                                   edge_valid=edge_valid)
        out, scores, m, l = fwd
        rho = attend_cuda.attend_rho_sorted(t["g"], scores, m, l, t["ht"],
                                            *graph, drop_mask=drop)
        rho_again = attend_cuda.attend_rho_sorted(
            t["g"], scores, m, l, t["ht"], *graph, drop_mask=drop)
        rho_re = attend_cuda.attend_rho_sorted(
            t["g"], None, m, l, t["ht"], *graph, att=t["att"], **kw)
        rho_plain = attend_cuda.attend_rho_sorted_plain(
            t["g"], scores, m, l, t["ht"], *graph, drop_mask=drop)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(fwd, again))
        assert all(torch.equal(a, b)
                   for a, b in zip(no_scores, (out, m, l)))
        for a, b, what in zip(fwd, plain, ("out", "scores", "m", "l")):
            _held(a.float().cpu().numpy(), b.float().cpu().numpy(), tol, what)
        assert torch.equal(s8, scores) and torch.equal(m8, m)
        assert torch.equal(l8, l)
        assert torch.equal(rho, rho_again) and torch.equal(rho, rho_re)
        _held(rho.cpu().numpy(), rho_plain.cpu().numpy(), tol, "rho")
        for x in (out, m, l, rho):
            assert not x[empty].any()
