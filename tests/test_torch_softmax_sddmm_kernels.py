"""Port parity: the composed GATv2 attention path's kernels of
keras_geometric_tpu_torch (``softmax_stats_sorted``, ``softmax_apply_sorted``,
``sddmm_scores_sorted``, ``sddmm_bwd_sorted``) against the JAX package's
Pallas kernels in interpret mode.

On the CPU the port's wrappers take their plain PyTorch versions, so these
tests pin the kernels' contract (padded slots at ``-inf``, empty rows, a row
whose scores are all ``-inf``, ``m`` stored as 0 without a finite score,
alpha in the requested type, ``d_pre`` in ``hj``'s type, ``datt`` in
``att``'s); the CUDA kernels themselves are held against the same plain
versions on the card by ``chip_smoke.py`` and by the ``cuda``-marked test
below.

The port's signatures take ``row_ptr`` / ``receivers`` where the reference
takes its TPU work-list tables, built here by ``build_row_tables`` from the
same receivers.

Tolerances: f32 1e-4 (the reference's f32 kernels split each operand into two
bf16 passes and keep ~16 mantissa bits; the port sums in f32); bf16 2e-2
absolute and relative (the reference rounds each score term ``z * att`` and
``ds`` to bf16 before its sums, the port rounds once at the store). ``datt``,
a sum over every slot, is held to that tolerance times its largest entry.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from keras_geometric_tpu.kernels import sddmm_pallas, softmax_pallas, spmm_pallas
from keras_geometric_tpu_torch.kernels import sddmm_cuda, softmax_cuda

torch.set_num_threads(1)

HEADS_K = [1, 4, 8]  # K of the softmax kernels
SHAPES = [(1, 8), (2, 3), (4, 8)]  # (heads, F per head) of the score kernels
DTYPES = ["float32", "bfloat16"]
SLOPE, EPS = 0.2, 1e-10
N, E_REAL, E = 48, 200, 256
DEAD = 10  # a row with slots whose scores are all -inf (all_inf cases)


def _tol(dtype):
    if dtype == "float32":
        return dict(rtol=1e-4, atol=1e-4)
    return dict(rtol=2e-2, atol=2e-2)


def _stream(seed):
    """Receiver-sorted stream with empty rows (every 5th node) and padded
    slots inside the last row."""
    rng = np.random.default_rng(seed)
    allowed = np.array([i for i in range(N) if i % 5 != 2])
    recv = np.sort(rng.choice(allowed, E_REAL)).astype(np.int32)
    recv = np.concatenate([recv, np.full(E - E_REAL, N - 1, np.int32)])
    return rng, dict(
        recv=recv,
        valid=np.arange(E) < E_REAL,
        row_ptr=np.searchsorted(recv, np.arange(N + 1)).astype(np.int32),
        tables=spmm_pallas.build_row_tables(recv, N, edge_chunk=128,
                                            row_block=32),
    )


def _scores(seed, k, all_inf_row):
    rng, c = _stream(seed)
    scores = (3.0 * rng.standard_normal((E, k))).astype(np.float32)
    scores[~c["valid"]] = -np.inf
    if all_inf_row:
        lo, hi = c["row_ptr"][DEAD], c["row_ptr"][DEAD + 1]
        assert hi > lo
        scores[lo:hi] = -np.inf
    return scores, c


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(getattr(torch, dtype))


def _j(a, dtype="float32"):
    return jnp.asarray(a).astype(jnp.dtype(dtype))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a.astype(jnp.float32))


def _rows_without_a_finite_score(scores, c):
    finite = np.isfinite(scores).any(axis=1)
    return np.setdiff1d(np.arange(N), c["recv"][finite])


@pytest.mark.parametrize("all_inf", [False, True], ids=["", "all_inf_row"])
@pytest.mark.parametrize("k", HEADS_K)
def test_softmax_stats_sorted_matches_jax(k, all_inf):
    scores, c = _scores(k, k, all_inf)
    with pltpu.force_tpu_interpret_mode():
        ref_m, ref_l = softmax_pallas.softmax_stats_sorted(
            jnp.asarray(scores), N, tables=c["tables"])
    m, l = softmax_cuda.softmax_stats_sorted(
        _t(scores), _t(c["recv"]), _t(c["row_ptr"]), N)
    assert m.dtype == l.dtype == torch.float32 and m.shape == (N, k)
    np.testing.assert_allclose(_np(m), _np(ref_m), **_tol("float32"))
    np.testing.assert_allclose(_np(l), _np(ref_l), **_tol("float32"))
    # Empty rows, the padded last row and (all_inf) the -inf row: m = l = 0.
    dead = _rows_without_a_finite_score(scores, c)
    assert N - 1 in dead and (DEAD in dead) == all_inf
    for got, ref in ((m, ref_m), (l, ref_l)):
        assert not _np(got)[dead].any() and not _np(ref)[dead].any()


@pytest.mark.parametrize("out_dtype", DTYPES)
@pytest.mark.parametrize("k", HEADS_K)
def test_softmax_apply_sorted_matches_jax(k, out_dtype):
    scores, c = _scores(100 + k, k, True)
    with pltpu.force_tpu_interpret_mode():
        m, l = softmax_pallas.softmax_stats_sorted(
            jnp.asarray(scores), N, tables=c["tables"])
        ref = softmax_pallas.softmax_apply_sorted(
            jnp.asarray(scores), m, l, tables=c["tables"], eps=EPS,
            out_dtype=jnp.dtype(out_dtype))
    alpha = softmax_cuda.softmax_apply_sorted(
        _t(scores), _t(m), _t(l), _t(c["recv"]), eps=EPS,
        out_dtype=getattr(torch, out_dtype))
    assert alpha.dtype == getattr(torch, out_dtype) and alpha.shape == (E, k)
    np.testing.assert_allclose(_np(alpha), _np(ref), **_tol(out_dtype))
    # -inf slots (padding, the dead row) weigh exactly 0.
    assert not _np(alpha)[~np.isfinite(scores)].any()
    # Every row with a finite score sums to 1 (with the port's own
    # statistics: the reference's f32 ones keep ~16 mantissa bits).
    own = softmax_cuda.softmax_apply_sorted(
        _t(scores), *softmax_cuda.softmax_stats_sorted(
            _t(scores), _t(c["recv"]), _t(c["row_ptr"]), N),
        _t(c["recv"]), eps=EPS, out_dtype=getattr(torch, out_dtype))
    sums = np.zeros((N, k))
    np.add.at(sums, c["recv"], _np(own))
    live = np.setdiff1d(np.arange(N), _rows_without_a_finite_score(scores, c))
    np.testing.assert_allclose(sums[live], 1.0,
                               rtol=1e-5 if out_dtype == "float32" else 3e-2)


def _sddmm_case(seed, heads, f, dtype):
    rng, c = _stream(seed)
    d = heads * f
    c.update(
        ht=rng.standard_normal((N, d)).astype(np.float32),
        hj=rng.standard_normal((E, d)).astype(np.float32),
        att=rng.standard_normal((heads, f)).astype(np.float32),
        ds=rng.standard_normal((E, heads)).astype(np.float32),
    )
    c["ds"][~c["valid"]] = 0.0  # alpha is 0 on padded slots
    return c


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("heads,f", SHAPES)
def test_sddmm_scores_sorted_matches_jax(heads, f, dtype):
    c = _sddmm_case(heads * 10 + f, heads, f, dtype)
    with pltpu.force_tpu_interpret_mode():
        ref = sddmm_pallas.sddmm_scores_sorted(
            _j(c["ht"], dtype), _j(c["hj"], dtype), _j(c["att"], dtype),
            tables=c["tables"], negative_slope=SLOPE)
    scores = sddmm_cuda.sddmm_scores_sorted(
        _t(c["ht"], dtype), _t(c["hj"], dtype), _t(c["att"], dtype),
        _t(c["recv"]), negative_slope=SLOPE)
    assert scores.dtype == torch.float32 and scores.shape == (E, heads)
    np.testing.assert_allclose(_np(scores), _np(ref), **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("heads,f", SHAPES)
def test_sddmm_bwd_sorted_matches_jax(heads, f, dtype):
    c = _sddmm_case(100 + heads * 10 + f, heads, f, dtype)
    with pltpu.force_tpu_interpret_mode():
        ref_d_pre, ref_datt = sddmm_pallas.sddmm_bwd_sorted(
            _j(c["ht"], dtype), _j(c["hj"], dtype), _j(c["att"], dtype),
            jnp.asarray(c["ds"]), tables=c["tables"], negative_slope=SLOPE)
    d_pre, datt = sddmm_cuda.sddmm_bwd_sorted(
        _t(c["ht"], dtype), _t(c["hj"], dtype), _t(c["att"], dtype),
        _t(c["ds"]), _t(c["recv"]), negative_slope=SLOPE)
    tol = _tol(dtype)
    assert d_pre.dtype == datt.dtype == getattr(torch, dtype)
    assert d_pre.shape == (E, heads * f) and datt.shape == (heads, f)
    np.testing.assert_allclose(_np(d_pre), _np(ref_d_pre), **tol)
    assert not _np(d_pre)[~c["valid"]].any()  # ds = 0 there
    scale = max(1.0, float(np.abs(_np(ref_datt)).max()))
    np.testing.assert_allclose(_np(datt), _np(ref_datt), rtol=tol["rtol"],
                               atol=tol["atol"] * scale)


def test_plain_versions_agree_with_a_loop_over_rows():
    """The plain versions against the definitions written as Python loops in
    float64: an oracle that shares no code with either package."""
    scores, c = _scores(3, 2, True)
    m = np.zeros((N, 2))
    l = np.zeros((N, 2))
    alpha = np.zeros((E, 2))
    for r in range(N):
        s = scores[c["row_ptr"][r]:c["row_ptr"][r + 1]].astype(np.float64)
        for k in range(2):
            finite = s[:, k][np.isfinite(s[:, k])]
            if finite.size:
                m[r, k] = finite.max()
                l[r, k] = np.exp(finite - m[r, k]).sum()
    for e in range(E):
        r = c["recv"][e]
        alpha[e] = np.exp(scores[e] - m[r]) / (l[r] + EPS)
    got_m, got_l = softmax_cuda.softmax_stats_sorted_plain(
        _t(scores), _t(c["recv"]), N)
    np.testing.assert_allclose(_np(got_m), m, atol=1e-6)
    np.testing.assert_allclose(_np(got_l), l, rtol=1e-6)
    got = softmax_cuda.softmax_apply_sorted_plain(
        _t(scores), got_m, got_l, _t(c["recv"]), eps=EPS)
    np.testing.assert_allclose(_np(got), alpha, atol=1e-6)

    s = _sddmm_case(4, 2, 3, "float32")
    ht, hj, att, ds = (s[k].astype(np.float64) for k in ("ht", "hj", "att",
                                                          "ds"))
    want_s = np.zeros((E, 2))
    want_d_pre = np.zeros((E, 6))
    want_datt = np.zeros((2, 3))
    for e in range(E):
        for h in range(2):
            for f in range(3):
                pre = ht[s["recv"][e], h * 3 + f] + hj[e, h * 3 + f]
                z = pre if pre > 0 else SLOPE * pre
                want_s[e, h] += att[h, f] * z
                want_d_pre[e, h * 3 + f] = (
                    ds[e, h] * att[h, f] * (1.0 if pre > 0 else SLOPE))
                want_datt[h, f] += z * ds[e, h]
    args = (_t(s["ht"]), _t(s["hj"]), _t(s["att"]))
    np.testing.assert_allclose(
        _np(sddmm_cuda.sddmm_scores_sorted_plain(*args, _t(s["recv"]))),
        want_s, atol=1e-5)
    d_pre, datt = sddmm_cuda.sddmm_bwd_sorted_plain(
        *args, _t(s["ds"]), _t(s["recv"]))
    np.testing.assert_allclose(_np(d_pre), want_d_pre, atol=1e-5)
    np.testing.assert_allclose(_np(datt), want_datt, atol=1e-4)


def test_wrappers_check_their_arguments_like_the_kernel_would():
    """Argument checks run before any launch, so they can be exercised on
    CPU tensors by calling them directly."""
    c = _sddmm_case(5, 2, 8, "float32")
    ht, hj, att, recv = _t(c["ht"]), _t(c["hj"]), _t(c["att"]), _t(c["recv"])
    assert sddmm_cuda._check_operands(ht, hj, att, recv) == (2, 8, E)
    with pytest.raises(TypeError, match="like ht"):
        sddmm_cuda._check_operands(ht, hj.bfloat16(), att, recv)
    with pytest.raises(ValueError, match=r"hj must be \[E, 16\]"):
        sddmm_cuda._check_operands(ht, hj[:, :8].contiguous(), att, recv)
    with pytest.raises(ValueError, match=r"\[H, F\]"):
        sddmm_cuda._check_operands(ht, hj, att[:, :5], recv)
    with pytest.raises(ValueError, match="receivers"):
        sddmm_cuda._check_operands(ht, hj, att, recv[:-1])
    with pytest.raises(TypeError, match="int32"):
        sddmm_cuda._check_operands(ht, hj, att, recv.long())
    # Heads wider than 256 columns are taken (the kernels walk them in
    # 256-column slabs).
    wide = torch.zeros(4, 257)
    assert sddmm_cuda._check_operands(wide, wide, wide[:1], recv[:4]) == (
        1, 257, 4)
    assert softmax_cuda._check_scores(torch.zeros(E, 4)) == (E, 4)
    with pytest.raises(TypeError, match="float32"):
        softmax_cuda._check_scores(torch.zeros(E, 4, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match=r"\[E, K\]"):
        softmax_cuda._check_scores(torch.zeros(E))
    with pytest.raises(ValueError, match="contiguous"):
        softmax_cuda._check_scores(torch.zeros(4, E).T)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("heads,f", [(4, 64), (4, 40), (8, 8), (8, 6), (1, 7)])
def test_cuda_kernels_match_plain_versions(heads, f, dtype):
    """On a card: each CUDA kernel against its plain version (the same check
    ``chip_smoke.py`` makes at larger sizes), and the composed context ops'
    backward through the kernels. Skips without a CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    c = _sddmm_case(300 + heads * 10 + f, heads, f, dtype)
    scores, _ = _scores(300 + heads, heads, True)
    recv, row_ptr = _t(c["recv"]).to(dev), _t(c["row_ptr"]).to(dev)
    s = _t(scores).to(dev)
    args = [_t(c[k], dtype).to(dev) for k in ("ht", "hj", "att")]
    ds = _t(c["ds"]).to(dev)
    softmax_cuda.reset_launch_counts()
    sddmm_cuda.reset_launch_counts()
    m, l = softmax_cuda.softmax_stats_sorted_plain(s, recv, N)
    pairs = [
        (softmax_cuda.softmax_stats_sorted(s, recv, row_ptr, N), (m, l)),
        ((softmax_cuda.softmax_apply_sorted(s, m, l, recv),),
         (softmax_cuda.softmax_apply_sorted_plain(s, m, l, recv),)),
        ((sddmm_cuda.sddmm_scores_sorted(*args, recv, row_ptr=row_ptr),),
         (sddmm_cuda.sddmm_scores_sorted_plain(*args, recv),)),
        (sddmm_cuda.sddmm_bwd_sorted(*args, ds, recv, row_ptr=row_ptr),
         sddmm_cuda.sddmm_bwd_sorted_plain(*args, ds, recv)),
    ]
    torch.cuda.synchronize()
    assert all(v == 1 for v in softmax_cuda.LAUNCH_COUNTS.values())
    # The two kernels launched here, by name: the module also counts the
    # score-and-statistics kernel, which this test does not launch.
    assert sddmm_cuda.LAUNCH_COUNTS["sddmm_scores_sorted"] == 1
    assert sddmm_cuda.LAUNCH_COUNTS["sddmm_bwd_sorted"] == 1
    tol = _tol(dtype)
    for got, want in pairs:
        for a, b in zip(got, want):
            a, b = _np(a.cpu()), _np(b.cpu())
            scale = max(1.0, float(np.abs(b).max()))
            np.testing.assert_allclose(a, b, rtol=tol["rtol"],
                                       atol=tol["atol"] * scale)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        sddmm_cuda.sddmm_scores_sorted(args[0].double(), args[1].double(),
                                       args[2], recv, row_ptr=row_ptr)
