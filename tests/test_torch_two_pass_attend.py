"""Port parity for the attention kernels that no default path reaches: the
two-pass forward (``sddmm_stats_sorted`` then ``attend_aggregate_sorted``),
the sender-side backward ``attend_send_bwd_sorted``, and the other modes of
the fused kernels (the forward without its score stream, rho and the
receiver backward recomputing the scores, the receiver backward without
``v``), against the JAX package's Pallas kernels in interpret mode.

On the CPU the port's wrappers take their plain PyTorch versions, so these
tests pin the kernels' contract; the CUDA kernels are held against the same
plain versions on the card (the ``cuda`` cases here, and ``chip_smoke.py``).

The port's kernels gather the rows they need; the reference's take them
gathered, so the reference is fed ``hj = ht[senders]`` and, for the sender
backward, ``g_r = g[receivers_ss]``, ``ht_r = ht[receivers_ss]`` and
``stats_r = (m | l | rho)[receivers_ss]``, made here. The backward kernels
are fed the reference forward's scores and statistics on both sides, so each
kernel is held alone.

Tolerances: f32 1e-4 (the reference's f32 kernels split each operand into
two bf16 passes; ROADMAP D1); bf16 2e-2 (the reference rounds its terms to
bf16 before its sums, the port once at the store; ROADMAP D5); each relative
and times the result's largest entry (at least 1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from keras_geometric_tpu.kernels import attend_pallas, sddmm_pallas, spmm_pallas
from keras_geometric_tpu_torch.kernels import attend_cuda, sddmm_cuda

torch.set_num_threads(1)

DTYPES = ["float32", "bfloat16"]
DROP = [False, True]
HEADS, F = 2, 8
SLOPE, EPS = 0.2, 1e-10


def _case(seed, dtype, drop):
    """Receiver-sorted stream with empty rows (every 5th node) and padded
    slots in the last row whose sender is the last row too (as
    ``prepare_graph`` pads), and the same stream in sender-sorted order."""
    rng = np.random.default_rng(seed)
    n, e_real, e = 48, 200, 256
    allowed = np.array([i for i in range(n) if i % 5 != 2])
    recv = np.sort(rng.choice(allowed, e_real)).astype(np.int32)
    recv = np.concatenate([recv, np.full(e - e_real, n - 1, np.int32)])
    send = rng.integers(0, n, e).astype(np.int32)
    send[e_real:] = n - 1
    valid = np.arange(e) < e_real
    perm = np.argsort(send, kind="stable").astype(np.int32)
    d = HEADS * F
    drop_mask = (((rng.random((e, HEADS)) < 0.7) / 0.7).astype(np.float32)
                 if drop else None)
    c = dict(
        n=n, e=e, dtype=dtype, recv=recv, send=send, valid=valid, perm=perm,
        ht=rng.standard_normal((n, d)).astype(np.float32),
        att=rng.standard_normal((HEADS, F)).astype(np.float32),
        g=rng.standard_normal((n, d)).astype(np.float32),
        drop=drop_mask,
        tables=spmm_pallas.build_row_tables(recv, n, edge_chunk=128,
                                            row_block=32),
        row_ptr=np.searchsorted(recv, np.arange(n + 1)).astype(np.int32),
        s_ss=send[perm], r_ss=recv[perm], valid_ss=valid[perm],
        drop_ss=None if drop_mask is None else drop_mask[perm],
    )
    c["row_ptr_bwd"] = np.searchsorted(
        c["s_ss"], np.arange(n + 1)).astype(np.int32)
    c["bwd_tables"] = spmm_pallas.build_row_tables(
        c["s_ss"], n, edge_chunk=128, row_block=32)
    return c


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


def _close(got, want, dtype, what=""):
    tol = 1e-4 if dtype == "float32" else 2e-2
    want = _np(want)
    scale = max(1.0, float(np.abs(want[np.isfinite(want)]).max()))
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _graph(c):
    return _t(c["send"]), _t(c["recv"]), _t(c["row_ptr"])


def _jax_forward(c, emit_scores=True):
    dt = c["dtype"]
    ht = _j(c["ht"], dt)
    hj = jnp.take(ht, jnp.asarray(c["send"]), axis=0)
    with pltpu.force_tpu_interpret_mode():
        res = sddmm_pallas.sddmm_stats_agg_sorted(
            ht, hj, _j(c["att"], dt), tables=c["tables"], num_nodes=c["n"],
            edge_valid=_j(c["valid"]), negative_slope=SLOPE, eps=EPS,
            drop_mask=_j(c["drop"], dt), emit_scores=emit_scores)
    return (res[0][:c["n"]],) + tuple(res[1:])


def _jax_rho(c, scores, m, l, **kw):
    dt = c["dtype"]
    ht = _j(c["ht"], dt)
    hj = jnp.take(ht, jnp.asarray(c["send"]), axis=0)
    with pltpu.force_tpu_interpret_mode():
        return attend_pallas.attend_rho_sorted(
            _j(c["g"], dt), scores, m, l, hj, tables=c["tables"], eps=EPS,
            drop_mask=_j(c["drop"], dt), **kw)[:c["n"]]


# ---------------------------------------------------------------------------
# The two-pass forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_sddmm_stats_sorted_matches_jax(dtype):
    c = _case(1, dtype, False)
    ht = _j(c["ht"], dtype)
    hj = jnp.take(ht, jnp.asarray(c["send"]), axis=0)
    with pltpu.force_tpu_interpret_mode():
        ref_scores, ref_m, ref_l = sddmm_pallas.sddmm_stats_sorted(
            ht, hj, _j(c["att"], dtype), tables=c["tables"],
            num_nodes=c["n"], edge_valid=_j(c["valid"]),
            negative_slope=SLOPE)
    scores, m, l = sddmm_cuda.sddmm_stats_sorted(
        _t(c["ht"], dtype), *_graph(c), _t(c["att"], dtype),
        edge_valid=_t(c["valid"]), negative_slope=SLOPE)
    assert scores.dtype == m.dtype == l.dtype == torch.float32
    assert scores.shape == (c["e"], HEADS) and m.shape == (c["n"], HEADS)
    valid = c["valid"]
    assert np.all(_np(scores)[~valid] == -np.inf)
    assert np.all(_np(ref_scores)[~valid] == -np.inf)
    _close(_np(scores)[valid], _np(ref_scores)[valid], dtype, "scores")
    _close(m, ref_m, dtype, "m")
    _close(l, ref_l, dtype, "l")
    empty = np.setdiff1d(np.arange(c["n"]), c["recv"][valid])
    assert empty.size and not _np(m)[empty].any()
    assert not _np(l)[empty].any()


@pytest.mark.parametrize("drop", DROP, ids=["nodrop", "drop"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_attend_aggregate_sorted_matches_jax(dtype, drop):
    c = _case(2, dtype, drop)
    _, scores, m, l = _jax_forward(c)
    ht = _j(c["ht"], dtype)
    hj = jnp.take(ht, jnp.asarray(c["send"]), axis=0)
    with pltpu.force_tpu_interpret_mode():
        ref = attend_pallas.attend_aggregate_sorted(
            scores, m, l, hj, tables=c["tables"], eps=EPS,
            drop_mask=_j(c["drop"], dtype))[:c["n"]]
    out = attend_cuda.attend_aggregate_sorted(
        _t(scores), _t(m), _t(l), _t(c["ht"], dtype), *_graph(c), eps=EPS,
        drop_mask=_t(c["drop"], dtype))
    assert out.dtype == getattr(torch, dtype) and out.shape == ref.shape
    _close(out, ref, dtype)


@pytest.mark.parametrize("drop", DROP, ids=["nodrop", "drop"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_two_pass_forward_equals_the_fused_forward(dtype, drop):
    """``sddmm_stats_sorted`` then ``attend_aggregate_sorted`` computes what
    ``sddmm_stats_agg_sorted`` does: the scores and statistics exactly, the
    output to rounding (it divides per slot, the fused forward once per
    row); and both against the reference's fused forward."""
    c = _case(3, dtype, drop)
    ht, att = _t(c["ht"], dtype), _t(c["att"], dtype)
    kw = dict(edge_valid=_t(c["valid"]), negative_slope=SLOPE)
    drop_mask = _t(c["drop"], dtype)
    scores, m, l = sddmm_cuda.sddmm_stats_sorted(ht, *_graph(c), att, **kw)
    out = attend_cuda.attend_aggregate_sorted(scores, m, l, ht, *_graph(c),
                                              eps=EPS, drop_mask=drop_mask)
    f_out, f_scores, f_m, f_l = attend_cuda.sddmm_stats_agg_sorted(
        ht, *_graph(c), att, eps=EPS, drop_mask=drop_mask, **kw)
    for a, b in ((scores, f_scores), (m, f_m), (l, f_l)):
        assert torch.equal(a, b)
    np.testing.assert_allclose(_np(out), _np(f_out), rtol=1e-5,
                               atol=1e-5 if dtype == "float32" else 2e-2)
    ref_out, *_ = _jax_forward(c)
    _close(out, ref_out, dtype)


# ---------------------------------------------------------------------------
# The sender-side backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("drop", DROP, ids=["nodrop", "drop"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_attend_send_bwd_sorted_matches_jax(dtype, drop):
    c = _case(4, dtype, drop)
    n = c["n"]
    _, scores, m, l = _jax_forward(c)
    rho = _jax_rho(c, scores, m, l)
    r_ss = jnp.asarray(c["r_ss"])
    stats = jnp.concatenate([m, l, rho], axis=1)
    ht = _j(c["ht"], dtype)
    with pltpu.force_tpu_interpret_mode():
        ref = attend_pallas.attend_send_bwd_sorted(
            ht, jnp.take(_j(c["g"], dtype), r_ss, axis=0),
            jnp.take(ht, r_ss, axis=0), jnp.take(stats, r_ss, axis=0),
            _j(c["att"], dtype), tables=c["bwd_tables"], eps=EPS,
            negative_slope=SLOPE, valid_ss=_j(c["valid_ss"]),
            drop_ss=_j(c["drop_ss"], dtype))[:n]
    out = attend_cuda.attend_send_bwd_sorted(
        _t(c["ht"], dtype), _t(c["g"], dtype), _t(c["r_ss"]), _t(c["s_ss"]),
        _t(c["row_ptr_bwd"]), _t(c["att"], dtype), _t(m), _t(l), _t(rho),
        eps=EPS, negative_slope=SLOPE,
        valid_ss=_t(c["valid_ss"]).float(), drop_ss=_t(c["drop_ss"], dtype))
    assert out.dtype == getattr(torch, dtype) and out.shape == ref.shape
    _close(out, ref, dtype)


@pytest.mark.parametrize("drop", DROP, ids=["nodrop", "drop"])
def test_send_finish_equals_the_permute_finish(drop):
    """The sender backward gives what the permute finish gives: ``v`` from
    the receiver backward summed by sender (f32, another order)."""
    c = _case(5, "float32", drop)
    ht, g, att = _t(c["ht"]), _t(c["g"]), _t(c["att"])
    graph = _graph(c)
    drop_mask = _t(c["drop"])
    _, scores, m, l = attend_cuda.sddmm_stats_agg_sorted(
        ht, *graph, att, edge_valid=_t(c["valid"]), drop_mask=drop_mask)
    rho = attend_cuda.attend_rho_sorted(g, scores, m, l, ht, *graph,
                                        drop_mask=drop_mask)
    _, _, v = attend_cuda.attend_recv_bwd_full_sorted(
        ht, g, *graph, att, scores, m, l, rho, drop_mask=drop_mask)
    want = torch.zeros_like(ht).index_add_(0, graph[0].long(), v)
    got = attend_cuda.attend_send_bwd_sorted(
        ht, g, _t(c["r_ss"]), _t(c["s_ss"]), _t(c["row_ptr_bwd"]), att, m, l,
        rho, valid_ss=_t(c["valid_ss"]).float(), drop_ss=_t(c["drop_ss"]))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    # The padded slots pile into the last row in sender order and add
    # nothing there.
    assert c["s_ss"][-1] == c["n"] - 1


# ---------------------------------------------------------------------------
# The other modes of the fused kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_without_the_score_stream_matches_jax(dtype):
    c = _case(6, dtype, True)
    ref_out, ref_m, ref_l = _jax_forward(c, emit_scores=False)
    args = (_t(c["ht"], dtype), *_graph(c), _t(c["att"], dtype))
    kw = dict(edge_valid=_t(c["valid"]), drop_mask=_t(c["drop"], dtype),
              negative_slope=SLOPE, eps=EPS)
    res = attend_cuda.sddmm_stats_agg_sorted(*args, emit_scores=False, **kw)
    assert len(res) == 3
    out, m, l = res
    for got, ref, what in ((out, ref_out, "out"), (m, ref_m, "m"),
                           (l, ref_l, "l")):
        _close(got, ref, dtype, what)
    cached = attend_cuda.sddmm_stats_agg_sorted(*args, **kw)
    for a, b in zip(res, (cached[0], cached[2], cached[3])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("drop", DROP, ids=["nodrop", "drop"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rho_recomputing_the_scores_matches_jax(dtype, drop):
    c = _case(7, dtype, drop)
    _, scores, m, l = _jax_forward(c)
    ref = _jax_rho(c, None, m, l, rows=_j(c["ht"], dtype),
                   att=_j(c["att"], dtype), negative_slope=SLOPE,
                   edge_valid=_j(c["valid"]))
    rho = attend_cuda.attend_rho_sorted(
        _t(c["g"], dtype), None, _t(m), _t(l), _t(c["ht"], dtype),
        *_graph(c), eps=EPS, drop_mask=_t(c["drop"], dtype),
        att=_t(c["att"], dtype), negative_slope=SLOPE,
        edge_valid=_t(c["valid"]))
    _close(rho, ref, dtype)
    # Over the port's own forward, the recomputed scores are the cached ones
    # bit for bit, and so is rho.
    ht, g, att = _t(c["ht"], dtype), _t(c["g"], dtype), _t(c["att"], dtype)
    _, p_scores, p_m, p_l = attend_cuda.sddmm_stats_agg_sorted(
        ht, *_graph(c), att, edge_valid=_t(c["valid"]), negative_slope=SLOPE)
    kw = dict(eps=EPS, drop_mask=_t(c["drop"], dtype))
    assert torch.equal(
        attend_cuda.attend_rho_sorted(g, p_scores, p_m, p_l, ht, *_graph(c),
                                      **kw),
        attend_cuda.attend_rho_sorted(g, None, p_m, p_l, ht, *_graph(c),
                                      att=att, negative_slope=SLOPE,
                                      edge_valid=_t(c["valid"]), **kw))
    with pytest.raises(ValueError, match="att="):
        attend_cuda.attend_rho_sorted(
            _t(c["g"], dtype), None, _t(m), _t(l), _t(c["ht"], dtype),
            *_graph(c))


@pytest.mark.parametrize("cached", [True, False], ids=["scores", "recompute"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_receiver_backward_without_v_matches_jax(dtype, cached):
    c = _case(8, dtype, True)
    n = c["n"]
    _, scores, m, l = _jax_forward(c)
    rho = _jax_rho(c, scores, m, l)
    ht = _j(c["ht"], dtype)
    hj = jnp.take(ht, jnp.asarray(c["send"]), axis=0)
    with pltpu.force_tpu_interpret_mode():
        ref_dht, ref_datt = attend_pallas.attend_recv_bwd_full_sorted(
            ht, _j(c["g"], dtype), hj, _j(c["att"], dtype),
            scores if cached else None, m, l, rho, tables=c["tables"],
            eps=EPS, negative_slope=SLOPE, drop_mask=_j(c["drop"], dtype),
            emit_v=False, edge_valid=_j(c["valid"]))
    args = (_t(c["ht"], dtype), _t(c["g"], dtype), *_graph(c),
            _t(c["att"], dtype), _t(scores) if cached else None, _t(m),
            _t(l), _t(rho))
    kw = dict(eps=EPS, negative_slope=SLOPE, drop_mask=_t(c["drop"], dtype),
              edge_valid=_t(c["valid"]))
    res = attend_cuda.attend_recv_bwd_full_sorted(*args, emit_v=False, **kw)
    assert len(res) == 2
    dht, datt = res
    _close(dht, ref_dht[:n], dtype, "d ht")
    _close(datt, ref_datt, dtype, "d att")
    # The same dht and datt as with v.
    with_v = attend_cuda.attend_recv_bwd_full_sorted(*args, **kw)
    assert torch.equal(dht, with_v[0]) and torch.equal(datt, with_v[1])


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("drop", DROP, ids=["nodrop", "drop"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("heads,f", [(4, 64), (4, 40), (8, 6), (1, 7)])
def test_cuda_kernels_match_plain_versions(heads, f, dtype, drop):
    """On a card: the score-and-statistics kernel, the aggregation, the
    sender backward and the three mode branches against their plain
    versions, each launched once; skips without a CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c = _case(9, dtype, drop)
    dev = torch.device("cuda")
    rng = np.random.default_rng(10)
    d = heads * f

    def on(a, dt=None):
        return None if a is None else _t(a, dt).to(dev)

    ht = on(rng.standard_normal((c["n"], d)).astype(np.float32), dtype)
    g = on(rng.standard_normal((c["n"], d)).astype(np.float32), dtype)
    att = on(rng.standard_normal((heads, f)).astype(np.float32), dtype)
    drop_mask = drop_ss = None
    if drop:
        mask = ((rng.random((c["e"], heads)) < 0.7) / 0.7).astype(np.float32)
        drop_mask, drop_ss = on(mask, dtype), on(mask[c["perm"]], dtype)
    graph = tuple(t.to(dev) for t in _graph(c))
    valid = on(c["valid"])
    ss = (on(c["r_ss"]), on(c["s_ss"]), on(c["row_ptr_bwd"]))
    valid_ss = on(c["valid_ss"]).float()
    attend_cuda.reset_launch_counts()
    sddmm_cuda.reset_launch_counts()
    pairs = []

    def both(fn, plain, *args, **kw):
        pairs.append((fn(*args, **kw), plain(*args, **kw)))
        return pairs[-1][1]

    scores, m, l = both(sddmm_cuda.sddmm_stats_sorted,
                        sddmm_cuda.sddmm_stats_sorted_plain, ht, *graph, att,
                        edge_valid=valid)
    both(attend_cuda.attend_aggregate_sorted,
         attend_cuda.attend_aggregate_sorted_plain, scores, m, l, ht, *graph,
         drop_mask=drop_mask)
    both(attend_cuda.sddmm_stats_agg_sorted,
         attend_cuda.sddmm_stats_agg_sorted_plain, ht, *graph, att,
         edge_valid=valid, drop_mask=drop_mask, emit_scores=False)
    rho = both(attend_cuda.attend_rho_sorted,
               attend_cuda.attend_rho_sorted_plain, g, None, m, l, ht,
               *graph, drop_mask=drop_mask, att=att, edge_valid=valid)
    both(attend_cuda.attend_recv_bwd_full_sorted,
         attend_cuda.attend_recv_bwd_full_sorted_plain, ht, g, *graph, att,
         None, m, l, rho, drop_mask=drop_mask, emit_v=False,
         edge_valid=valid)
    both(attend_cuda.attend_send_bwd_sorted,
         attend_cuda.attend_send_bwd_sorted_plain, ht, g, *ss, att, m, l,
         rho, valid_ss=valid_ss, drop_ss=drop_ss)
    torch.cuda.synchronize()
    assert sddmm_cuda.LAUNCH_COUNTS["sddmm_stats_sorted"] == 1
    assert all(v == 1 for v in attend_cuda.LAUNCH_COUNTS.values())
    assert all(v == 1 for v in attend_cuda.MODE_LAUNCH_COUNTS.values())
    for got, want in pairs:
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for a, b in zip(got, want):
            a, b = _np(a.cpu()), _np(b.cpu())
            assert np.array_equal(np.isinf(a), np.isinf(b))
            a, b = np.where(np.isinf(a), 0, a), np.where(np.isinf(b), 0, b)
            _close(a, b, dtype)
