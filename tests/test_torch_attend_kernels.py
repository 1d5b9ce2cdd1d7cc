"""Port parity: the fused GATv2 attention kernels of keras_geometric_tpu_torch
(forward ``sddmm_stats_agg_sorted``, ``attend_rho_sorted``,
``attend_recv_bwd_full_sorted``) against the JAX package's Pallas kernels in
interpret mode.

On the CPU the port's wrappers take their plain PyTorch versions, so these
tests pin the kernels' contract (padded slots, empty rows, rows whose slots
are all invalid, dropout on the numerator only, ``-inf`` scores on invalid
slots, ``m`` stored as 0 without a finite score); the CUDA kernels themselves
are held against the same plain versions on the card by ``chip_smoke.py``.

The port gathers the sender rows itself and takes ``senders``; the reference
takes ``hj = ht[senders]``, which is made here on the JAX side. Each backward
kernel is fed the reference forward's ``scores``, ``m``, ``l`` (and ``rho``)
on both sides, so it is held alone.

Tolerances: f32 1e-4 (the reference's f32 kernels split each operand into two
bf16 passes and keep ~16 mantissa bits; the port sums in f32); bf16 2e-2
absolute and relative (the reference rounds ``exp * hj`` and ``d_pre`` to bf16
before its sums, the port rounds once at the store). Sums of rounded terms
(``d ht``, ``datt``) are held to that tolerance times their largest entry: the
reference's error follows the size of the terms, not of the sum.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from keras_geometric_tpu.kernels import attend_pallas, sddmm_pallas, spmm_pallas
from keras_geometric_tpu_torch.kernels import attend_cuda

torch.set_num_threads(1)

SHAPES = [(1, 8), (2, 3), (4, 8)]  # (heads, F per head)
DTYPES = ["float32", "bfloat16"]
DROP = [False, True]
SLOPE, EPS = 0.2, 1e-10


def _tol(dtype):
    if dtype == "float32":
        return dict(rtol=1e-4, atol=1e-4)
    return dict(rtol=2e-2, atol=2e-2)


def _case(seed, heads, f, dtype, drop, *, last_row_real=True):
    """Receiver-sorted stream with empty rows (every 5th node), padded slots
    inside the last row, and (``last_row_real=False``) a last row whose slots
    are all padding."""
    rng = np.random.default_rng(seed)
    n, e_real, e = 48, 200, 256
    hi = n if last_row_real else n - 1
    allowed = np.array([i for i in range(hi) if i % 5 != 2])
    recv = np.sort(rng.choice(allowed, e_real)).astype(np.int32)
    recv = np.concatenate([recv, np.full(e - e_real, n - 1, np.int32)])
    send = rng.integers(0, n, e).astype(np.int32)
    valid = np.arange(e) < e_real
    d = heads * f
    case = dict(
        n=n, e=e, e_real=e_real, heads=heads, f=f, dtype=dtype, recv=recv,
        send=send, valid=valid,
        ht=rng.standard_normal((n, d)).astype(np.float32),
        att=rng.standard_normal((heads, f)).astype(np.float32),
        g=rng.standard_normal((n, d)).astype(np.float32),
        drop=((rng.random((e, heads)) < 0.7) / 0.7).astype(np.float32)
        if drop else None,
        tables=spmm_pallas.build_row_tables(recv, n, edge_chunk=128,
                                            row_block=32),
        row_ptr=np.searchsorted(recv, np.arange(n + 1)).astype(np.int32),
    )
    return case


def _j(a, dtype="float32"):
    return None if a is None else jnp.asarray(a).astype(jnp.dtype(dtype))


def _t(a, dtype=None):
    if a is None:
        return None
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(getattr(torch, dtype))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a.astype(jnp.float32))


def _jax_forward(c):
    dt = c["dtype"]
    ht = _j(c["ht"], dt)
    hj = jnp.take(ht, jnp.asarray(c["send"]), axis=0)
    with pltpu.force_tpu_interpret_mode():
        out, scores, m, l = sddmm_pallas.sddmm_stats_agg_sorted(
            ht, hj, _j(c["att"], dt), tables=c["tables"], num_nodes=c["n"],
            edge_valid=_j(c["valid"]), negative_slope=SLOPE, eps=EPS,
            drop_mask=_j(c["drop"], dt),
        )
    return out[:c["n"]], scores, m, l


def _graph_args(c):
    return _t(c["send"]), _t(c["recv"]), _t(c["row_ptr"])


@pytest.mark.parametrize("drop", DROP, ids=["nodrop", "drop"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("heads,f", SHAPES)
def test_sddmm_stats_agg_sorted_matches_jax(heads, f, dtype, drop):
    c = _case(heads * 10 + f, heads, f, dtype, drop)
    ref_out, ref_scores, ref_m, ref_l = _jax_forward(c)
    out, scores, m, l = attend_cuda.sddmm_stats_agg_sorted(
        _t(c["ht"], dtype), *_graph_args(c), _t(c["att"], dtype),
        edge_valid=_t(c["valid"]), drop_mask=_t(c["drop"], dtype),
        negative_slope=SLOPE, eps=EPS)
    tol = _tol(dtype)
    assert out.dtype == getattr(torch, dtype) and out.shape == ref_out.shape
    assert scores.dtype == m.dtype == l.dtype == torch.float32
    np.testing.assert_allclose(_np(out), _np(ref_out), **tol)
    valid = c["valid"]
    np.testing.assert_allclose(_np(scores)[valid], _np(ref_scores)[valid],
                               **tol)
    assert np.all(_np(scores)[~valid] == -np.inf)
    assert np.all(_np(ref_scores)[~valid] == -np.inf)
    np.testing.assert_allclose(_np(m), _np(ref_m), **tol)
    np.testing.assert_allclose(_np(l), _np(ref_l), **tol)
    # Empty rows: no score seen, so m is stored as 0, l and out are 0.
    empty = np.setdiff1d(np.arange(c["n"]), c["recv"][valid])
    assert empty.size
    assert not _np(m)[empty].any() and not _np(l)[empty].any()
    assert not _np(out)[empty].any()


@pytest.mark.parametrize("dtype", DTYPES)
def test_row_whose_slots_are_all_invalid_is_an_empty_row(dtype):
    c = _case(7, 2, 8, dtype, True, last_row_real=False)
    ref_out, ref_scores, ref_m, ref_l = _jax_forward(c)
    out, scores, m, l = attend_cuda.sddmm_stats_agg_sorted(
        _t(c["ht"], dtype), *_graph_args(c), _t(c["att"], dtype),
        edge_valid=_t(c["valid"]), drop_mask=_t(c["drop"], dtype))
    last = c["n"] - 1
    for got, ref in ((out, ref_out), (m, ref_m), (l, ref_l)):
        assert not _np(got)[last].any() and not _np(ref)[last].any()
    np.testing.assert_allclose(_np(out), _np(ref_out), **_tol(dtype))


@pytest.mark.parametrize("drop", DROP, ids=["nodrop", "drop"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("heads,f", SHAPES)
def test_attend_rho_sorted_matches_jax(heads, f, dtype, drop):
    c = _case(100 + heads * 10 + f, heads, f, dtype, drop)
    _, scores, m, l = _jax_forward(c)
    ht = _j(c["ht"], dtype)
    hj = jnp.take(ht, jnp.asarray(c["send"]), axis=0)
    with pltpu.force_tpu_interpret_mode():
        ref = attend_pallas.attend_rho_sorted(
            _j(c["g"], dtype), scores, m, l, hj, tables=c["tables"], eps=EPS,
            drop_mask=_j(c["drop"], dtype))[:c["n"]]
    rho = attend_cuda.attend_rho_sorted(
        _t(c["g"], dtype), _t(scores), _t(m), _t(l), _t(c["ht"], dtype),
        *_graph_args(c), eps=EPS, drop_mask=_t(c["drop"], dtype))
    assert rho.dtype == torch.float32 and rho.shape == (c["n"], heads)
    np.testing.assert_allclose(_np(rho), _np(ref), **_tol(dtype))


@pytest.mark.parametrize("drop", DROP, ids=["nodrop", "drop"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("heads,f", SHAPES)
def test_attend_recv_bwd_full_sorted_matches_jax(heads, f, dtype, drop):
    c = _case(200 + heads * 10 + f, heads, f, dtype, drop)
    n = c["n"]
    _, scores, m, l = _jax_forward(c)
    ht = _j(c["ht"], dtype)
    hj = jnp.take(ht, jnp.asarray(c["send"]), axis=0)
    with pltpu.force_tpu_interpret_mode():
        rho = attend_pallas.attend_rho_sorted(
            _j(c["g"], dtype), scores, m, l, hj, tables=c["tables"], eps=EPS,
            drop_mask=_j(c["drop"], dtype))
        ref_dht, ref_datt, ref_v = attend_pallas.attend_recv_bwd_full_sorted(
            ht, _j(c["g"], dtype), hj, _j(c["att"], dtype), scores, m, l, rho,
            tables=c["tables"], eps=EPS, negative_slope=SLOPE,
            drop_mask=_j(c["drop"], dtype))
    dht, datt, v = attend_cuda.attend_recv_bwd_full_sorted(
        _t(c["ht"], dtype), _t(c["g"], dtype), *_graph_args(c),
        _t(c["att"], dtype), _t(scores), _t(m), _t(l), _t(rho[:n]), eps=EPS,
        negative_slope=SLOPE, drop_mask=_t(c["drop"], dtype))
    tol = _tol(dtype)
    assert dht.dtype == v.dtype == getattr(torch, dtype)
    assert datt.shape == (heads, f) and v.shape == (c["e"], heads * f)
    np.testing.assert_allclose(_np(v), _np(ref_v), **tol)
    assert not _np(v)[~c["valid"]].any()  # invalid slots send nothing back
    # d ht sums a row's edges and datt every edge: the tolerance scales with
    # the largest entry.
    for got, ref in ((dht, ref_dht[:n]), (datt, ref_datt)):
        scale = max(1.0, float(np.abs(_np(ref)).max()))
        np.testing.assert_allclose(_np(got), _np(ref), rtol=tol["rtol"],
                                   atol=tol["atol"] * scale)


def test_plain_versions_agree_with_a_loop_over_rows():
    """The plain versions against the definition written as Python loops, in
    float64: an oracle that shares no code with either package."""
    c = _case(3, 2, 3, "float32", True)
    n, heads, f = c["n"], 2, 3
    ht, att, g = (c[k].astype(np.float64) for k in ("ht", "att", "g"))
    out = np.zeros((n, heads, f))
    rho = np.zeros((n, heads))
    alpha = np.zeros((c["e"], heads))
    htv = ht.reshape(n, heads, f)
    for r in range(n):
        slots = [e for e in range(c["row_ptr"][r], c["row_ptr"][r + 1])
                 if c["valid"][e]]
        if not slots:
            continue
        pre = htv[r][None] + htv[c["send"][slots]]
        s = (np.where(pre > 0, pre, SLOPE * pre) * att[None]).sum(-1)
        ex = np.exp(s - s.max(0))
        a = ex / (ex.sum(0) + EPS)
        alpha[slots] = a
        keep = c["drop"][slots]
        out[r] = ((a * keep)[:, :, None] * htv[c["send"][slots]]).sum(0)
        dalpha = (g.reshape(n, heads, f)[r][None]
                  * htv[c["send"][slots]]).sum(-1)
        rho[r] = (a * keep * dalpha).sum(0)
    got_out, scores, m, l = attend_cuda.sddmm_stats_agg_sorted_plain(
        _t(c["ht"]), *_graph_args(c), _t(c["att"]),
        edge_valid=_t(c["valid"]), drop_mask=_t(c["drop"]))
    np.testing.assert_allclose(_np(got_out), out.reshape(n, -1), atol=1e-5)
    got_rho = attend_cuda.attend_rho_sorted_plain(
        _t(c["g"]), scores, m, l, _t(c["ht"]), *_graph_args(c),
        drop_mask=_t(c["drop"]))
    np.testing.assert_allclose(_np(got_rho), rho, atol=1e-5)
    got_alpha = torch.exp(scores - m[_t(c["recv"]).long()]) / (
        l[_t(c["recv"]).long()] + EPS)
    np.testing.assert_allclose(_np(got_alpha), alpha, atol=1e-6)


def test_wrappers_check_their_arguments_like_the_kernel_would():
    """Argument checks run before any launch, so they can be exercised on
    CPU tensors by calling them directly."""
    c = _case(5, 2, 8, "float32", False)
    ht, att = _t(c["ht"]), _t(c["att"])
    send, _, row_ptr = _graph_args(c)
    assert attend_cuda._check_graph(ht, send, row_ptr, att) == (
        c["n"], 2, 8, c["e"])
    with pytest.raises(ValueError, match=r"\[H, F\]"):
        attend_cuda._check_graph(ht, send, row_ptr, att[:, :5])
    with pytest.raises(TypeError, match="int32"):
        attend_cuda._check_graph(ht, send.long(), row_ptr, att)
    with pytest.raises(ValueError, match="row_ptr"):
        attend_cuda._check_graph(ht, send, row_ptr[:-1], att)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        attend_cuda._check_graph(ht.double(), send, row_ptr, att)
    # Heads wider than 256 columns are taken (the kernels walk them in
    # 256-column slabs).
    wide = torch.zeros(c["n"], 257)
    assert attend_cuda._check_graph(wide, send, row_ptr, wide[:1]) == (
        c["n"], 1, 257, c["e"])
    with pytest.raises(TypeError, match="float32"):
        attend_cuda._check_like("scores", torch.zeros(4, 2).double(), (4, 2),
                                torch.float32, ht.device)
    with pytest.raises(ValueError, match="contiguous"):
        attend_cuda._check_like("m", torch.zeros(2, 4).T, (4, 2),
                                torch.float32, ht.device)


@pytest.mark.cuda
@pytest.mark.parametrize("drop", DROP, ids=["nodrop", "drop"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("heads,f", [(4, 64), (4, 40), (8, 6), (1, 7)])
def test_cuda_kernels_match_plain_versions(heads, f, dtype, drop):
    """On a card: each CUDA kernel against its plain version (the same check
    ``chip_smoke.py`` makes at larger sizes), and ``GraphContext.attend``'s
    backward through the kernels. Skips without a CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c = _case(300 + heads * 10 + f, heads, f, dtype, drop)
    dev = torch.device("cuda")
    on = lambda a, dt=None: None if a is None else _t(a, dt).to(dev)
    ht, att, g = on(c["ht"], dtype), on(c["att"], dtype), on(c["g"], dtype)
    graph = tuple(t.to(dev) for t in _graph_args(c))
    kw = dict(edge_valid=on(c["valid"]), drop_mask=on(c["drop"], dtype))
    attend_cuda.reset_launch_counts()
    got = attend_cuda.sddmm_stats_agg_sorted(ht, *graph, att, **kw)
    want = attend_cuda.sddmm_stats_agg_sorted_plain(ht, *graph, att, **kw)
    _, scores, m, l = want
    rho = attend_cuda.attend_rho_sorted_plain(
        g, scores, m, l, ht, *graph, drop_mask=kw["drop_mask"])
    pairs = list(zip(got, want))
    pairs.append((attend_cuda.attend_rho_sorted(
        g, scores, m, l, ht, *graph, drop_mask=kw["drop_mask"]), rho))
    pairs += zip(
        attend_cuda.attend_recv_bwd_full_sorted(
            ht, g, *graph, att, scores, m, l, rho,
            drop_mask=kw["drop_mask"]),
        attend_cuda.attend_recv_bwd_full_sorted_plain(
            ht, g, *graph, att, scores, m, l, rho,
            drop_mask=kw["drop_mask"]))
    torch.cuda.synchronize()
    assert [attend_cuda.LAUNCH_COUNTS[name] for name in (
        "sddmm_stats_agg_sorted", "attend_rho_sorted",
        "attend_recv_bwd_full_sorted")] == [1, 1, 1]
    for a, b in pairs:
        a, b = _np(a.cpu()), _np(b.cpu())
        assert np.array_equal(np.isinf(a), np.isinf(b))
        a, b = np.where(np.isinf(a), 0, a), np.where(np.isinf(b), 0, b)
        scale = max(1.0, float(np.abs(b).max()))
        tol = _tol(dtype)
        np.testing.assert_allclose(a, b, rtol=tol["rtol"],
                                   atol=tol["atol"] * scale)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        attend_cuda.sddmm_stats_agg_sorted(ht.double(), *graph, att.double())
