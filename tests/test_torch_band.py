"""Port parity for the locality tier's kernels and contexts: the band SpMM and
the window scatter (plain versions against the JAX package's Pallas kernels
in interpret mode, forward and gradient), ``GraphContext.spmm`` /
``spmm_mean`` / ``attend`` on ``band_window`` / ``attend_window`` contexts,
and ``GATv2Conv`` on a band context, against the JAX package on the same
numpy inputs. Weights are carried over with ``convert.params_from_jax``; the
whole ``jax.grad`` runs inside the interpret mode.

Tolerances: the kernels' plain versions against the Pallas kernels 2e-5
(f32: both sum exact f32 products, in another order) and one bf16 unit in
the last place (bf16: both round the f32 sum once); contexts and the GCN
1e-4 (the reference's ``spmm`` parity bound); anything through the
reference's attention kernels value 1e-4, gradients rtol 1e-3 / atol 3e-3
(its f32 attention kernels split operands into two bf16 passes); the port's
banded contexts against its own plain contexts 1e-5 (the same sums, grouped
by tier).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import keras_geometric_tpu_torch as kgt_torch
from keras_geometric_tpu.kernels import band_pallas
from keras_geometric_tpu.nn.gatv2_conv import GATv2Conv as JGATv2Conv
from keras_geometric_tpu.ops.csr import prepare_graph as j_prepare
from keras_geometric_tpu.ops.precompute import (
    precompute_propagation as j_precompute,
)
from keras_geometric_tpu_torch import convert
from keras_geometric_tpu_torch.kernels import band_cuda, spmm_cuda

torch.set_num_threads(1)

N = 700
KERNEL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
          torch.bfloat16: dict(rtol=2.0 ** -7, atol=1e-3)}
CONTEXT = dict(rtol=1e-4, atol=1e-4)
ATTEND_VALUE = dict(rtol=1e-4, atol=1e-4)
ATTEND_GRAD = dict(rtol=1e-3, atol=3e-3)
SELF = dict(rtol=1e-5, atol=1e-5)


def _local_edges(n=N, e=4000, seed=0, directed=False, far_frac=0.2):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, e // 2)
    s = np.clip(r + rng.integers(-100, 100, e // 2), 0, n - 1)
    far = rng.random(e // 2) < far_frac
    s[far] = rng.integers(0, n, int(far.sum()))
    if directed:
        return np.stack([s, r]).astype(np.int32)
    return np.stack([np.concatenate([s, r]),
                     np.concatenate([r, s])]).astype(np.int32)


def _np(t):
    return t.detach().float().numpy()


def _to_jax(a, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype == torch.bfloat16 else
                       jnp.float32)


def _to_torch(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


# ---------------------------------------------------------------------------
# The kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,f", [(256, 1), (512, 7), (512, 16)])
@pytest.mark.parametrize("directed", [False, True])
def test_band_spmm_matches_jax_kernel(directed, window, f, dtype):
    ei = _local_edges(directed=directed)
    n_pad = 1_024
    w = np.random.default_rng(1).uniform(0.1, 1.0, 2_000).astype(np.float32)
    if not directed:  # the mirror edge carries the same weight: B^T = B
        w = np.concatenate([w, w])
    plan, local = band_cuda.build_band_plan(ei[0], ei[1], w, n_pad,
                                            window=window)
    j_plan, _ = band_pallas.build_band_plan(ei[0], ei[1], w, n_pad,
                                            window=window)
    plan_t = j_plan_t = None
    if directed:
        plan_t, _ = band_cuda.build_band_plan(ei[1], ei[0], w, n_pad,
                                              window=window)
        j_plan_t, _ = band_pallas.build_band_plan(ei[1], ei[0], w, n_pad,
                                                  window=window)
    assert 0 < local.sum() < local.shape[0]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((n_pad, f)).astype(np.float32)
    g = rng.standard_normal((n_pad, f)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        y_j, vjp = jax.vjp(
            lambda h: band_pallas.band_spmm(h, j_plan, j_plan_t),
            _to_jax(x, dtype))
        (dx_j,) = vjp(_to_jax(g, dtype))
    if dtype == torch.bfloat16:
        plan = plan.__class__(**{**plan.__dict__,
                                 "band": plan.band.to(dtype)})
    xt = _to_torch(x, dtype).requires_grad_(True)
    y = band_cuda.band_spmm(xt, plan, plan_t)
    y.backward(_to_torch(g, dtype))
    assert y.dtype == xt.grad.dtype == dtype
    np.testing.assert_allclose(_np(y), np.asarray(y_j, np.float32),
                               **KERNEL[dtype])
    np.testing.assert_allclose(_np(xt.grad), np.asarray(dx_j, np.float32),
                               **KERNEL[dtype])
    # The backward is the forward over the transposed band.
    dense = plan.band.float().numpy()
    base = plan.base_idx.numpy().astype(np.int64) * (window // 2)
    full = np.zeros((n_pad, n_pad), np.float32)
    for row in range(n_pad):
        b = base[row // plan.row_block]
        full[row, b:b + window] = dense[row]
    if dtype == torch.float32:
        np.testing.assert_allclose(_np(y), full @ x, **KERNEL[dtype])
        np.testing.assert_allclose(_np(xt.grad), full.T @ g, **KERNEL[dtype])


def test_band_spmm_empty_blocks_and_double_backward():
    n_pad, window = 1_024, 512
    # Edges only inside the first row block: the other blocks' bands are 0.
    s = np.array([0, 1, 5, 200, 17])
    r = np.array([3, 0, 9, 100, 250])
    plan, local = band_cuda.build_band_plan(s, r, None, n_pad, window=window)
    assert local.all() and not plan.band[256:].any()
    x = torch.randn(n_pad, 3, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    y = band_cuda.band_spmm(x, plan, plan)
    assert not y[256:].any()
    g = torch.randn(n_pad, 3, requires_grad=True)
    (dx,) = torch.autograd.grad(y, x, g, create_graph=True)
    (dg,) = torch.autograd.grad(dx.sum(), g)
    ones = band_cuda.band_spmm(torch.ones(n_pad, 3), plan, plan)
    np.testing.assert_allclose(dg.numpy(), ones.numpy(), **SELF)
    with pytest.raises(ValueError, match="n_pad"):
        band_cuda.band_spmm(torch.ones(n_pad - 1, 3), plan)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,far_frac,f", [(1500, 0.25, 8), (300, 0.25, 16),
                                          (1500, 1.0, 8)])
def test_window_scatter_sum_matches_jax_kernel(e, far_frac, f, dtype):
    """Includes a plan with windows it visits only to zero them (e=300) and
    one where every slot is off-window (far_frac=1 after a random
    numbering leaves some chunks without a majority window)."""
    rng = np.random.default_rng(3)
    n, window, chunk = 1_024, 256, 256
    r = np.sort(rng.integers(0, n, e))
    s = np.clip(r + rng.integers(-120, 120, e), 0, n - 1)
    far = rng.random(e) < far_frac
    s[far] = rng.integers(0, n, int(far.sum()))
    e_pad = -(-e // chunk) * chunk
    senders = np.concatenate([s, np.full(e_pad - e, n - 1)])
    eligible = np.arange(e_pad) < e
    plan, _, tab = band_cuda.build_window_scatter_plan(
        senders, n, eligible, window=window, edge_chunk=chunk)
    j_plan, _, _ = band_pallas.build_window_scatter_plan(
        senders, n, eligible, window=window, edge_chunk=chunk)
    v = rng.standard_normal((e_pad, f)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = band_pallas.window_scatter_sum(
            _to_jax(v, dtype), jnp.asarray(tab), j_plan)
    got = band_cuda.window_scatter_sum(_to_torch(v, dtype),
                                       torch.from_numpy(tab), plan)
    assert got.dtype == dtype and got.shape == (n, f)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **KERNEL[dtype])
    # An all -1 table adds nothing.
    none = band_cuda.window_scatter_sum(_to_torch(v, dtype),
                                        torch.full_like(
                                            torch.from_numpy(tab), -1), plan)
    assert not none.any()


# ---------------------------------------------------------------------------
# Contexts
# ---------------------------------------------------------------------------

SPMM_CONTEXTS = {
    "symmetric_densified": dict(add_self_loops=True, gcn_normalize=True,
                                symmetric=True, densify_self_loops=True,
                                pad_nodes=True),
    "directed": dict(add_self_loops=True, gcn_normalize=True,
                     pad_nodes=True),
    "directed_densified": dict(add_self_loops=True, gcn_normalize=True,
                               densify_self_loops=True, pad_nodes=True),
}


@pytest.mark.parametrize("kind", list(SPMM_CONTEXTS))
def test_spmm_on_band_contexts_matches_jax(kind):
    kw = SPMM_CONTEXTS[kind]
    ei = _local_edges(directed=kind != "symmetric_densified")
    tc = kgt_torch.prepare_graph(ei, N, band_window=512, device="cpu", **kw)
    jc = j_prepare(ei, N, band_window=512, **kw)
    plain = kgt_torch.prepare_graph(ei, N, device="cpu", **kw)
    assert 0 < tc.num_band_edges and tc.num_edges == plain.num_edges
    x = np.random.default_rng(4).standard_normal(
        (tc.num_nodes, 16)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        y_j, g_j = jax.value_and_grad(
            lambda h: jnp.sum(jnp.sin(jc.spmm(h))))(jnp.asarray(x))
        y_j = jc.spmm(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tc.spmm(xt)
    torch.sin(y).sum().backward()
    np.testing.assert_allclose(_np(y), np.asarray(y_j), **CONTEXT)
    np.testing.assert_allclose(_np(xt.grad), np.asarray(g_j), **CONTEXT)
    # The same sums as the port's plain context.
    xp = torch.from_numpy(x[: plain.num_nodes]).requires_grad_(True)
    yp = plain.spmm(xp)
    torch.sin(yp).sum().backward()
    np.testing.assert_allclose(_np(y)[:N], _np(yp)[:N], **SELF)
    np.testing.assert_allclose(_np(xt.grad)[:N], _np(xp.grad)[:N], **SELF)


def test_spmm_mean_on_a_band_context_matches_jax():
    ei = _local_edges()
    tc = kgt_torch.prepare_graph(ei, N, pad_nodes=True, band_window=512,
                                 device="cpu")
    jc = j_prepare(ei, N, pad_nodes=True, band_window=512)
    assert tc.has_unit_weights
    x = np.random.default_rng(5).standard_normal(
        (tc.num_nodes, 8)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        y_j, g_j = jax.value_and_grad(
            lambda h: jnp.sum(jnp.cos(jc.spmm_mean(h))))(jnp.asarray(x))
        y_j = jc.spmm_mean(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tc.spmm_mean(xt)
    torch.cos(y).sum().backward()
    np.testing.assert_allclose(_np(y), np.asarray(y_j), **CONTEXT)
    np.testing.assert_allclose(_np(xt.grad), np.asarray(g_j), **CONTEXT)


def test_bf16_band_context_follows_the_f32_one():
    """``with_weight_dtype`` stores the band in bf16 once; the bf16 spmm is
    the f32 one rounded (inputs and output to 8 mantissa bits)."""
    ei = _local_edges()
    tc = kgt_torch.prepare_graph(ei, N, band_window=512, device="cpu",
                                 **SPMM_CONTEXTS["symmetric_densified"])
    bf = tc.with_weight_dtype(torch.bfloat16)
    x = torch.randn(tc.num_nodes, 16, generator=torch.Generator().manual_seed(6))
    y = tc.spmm(x)
    y_bf = bf.spmm(x.to(torch.bfloat16))
    assert y_bf.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(y_bf), _np(y), rtol=3e-2,
                               atol=3e-2 * _np(y).std())


@pytest.mark.parametrize("hops", [1, 2])
def test_precompute_propagation_on_a_band_context(hops):
    ei = _local_edges()
    kw = dict(band_window=512, attend_full_stream=False,
              **SPMM_CONTEXTS["symmetric_densified"])
    tc = kgt_torch.prepare_graph(ei, N, device="cpu", **kw)
    jc = j_prepare(ei, N, **kw)
    x = np.random.default_rng(7).standard_normal(
        (tc.num_nodes, 8)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = j_precompute(jc, jnp.asarray(x), hops=hops)
    out = kgt_torch.precompute_propagation(tc, torch.from_numpy(x), hops=hops)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **CONTEXT)


@pytest.mark.parametrize("far_frac", [0.25, 0.0, 1.0])
def test_attend_on_a_window_context_matches_jax(far_frac):
    ei = _local_edges(n=520, e=1500, directed=True, far_frac=far_frac, seed=8)
    kw = dict(add_self_loops=True, pad_nodes=True, attend_window=256)
    tc = kgt_torch.prepare_graph(ei, 520, device="cpu", **kw)
    jc = j_prepare(ei, 520, **kw)
    plain = kgt_torch.prepare_graph(ei, 520, add_self_loops=True,
                                    pad_nodes=True, device="cpu")
    assert tc.attw_plan is not None
    heads, f = 2, 8
    rng = np.random.default_rng(9)
    ht = rng.standard_normal((tc.num_nodes, heads * f)).astype(np.float32)
    att = rng.standard_normal((heads, f)).astype(np.float32)
    gw = rng.standard_normal((tc.num_nodes, heads * f)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        out_j = jc.attend(jnp.asarray(ht), jnp.asarray(att))
        dht_j, datt_j = jax.grad(
            lambda h, a: jnp.sum(jc.attend(h, a) * gw), argnums=(0, 1))(
                jnp.asarray(ht), jnp.asarray(att))

    def run(ctx, rows):
        h = torch.from_numpy(ht[:rows]).requires_grad_(True)
        a = torch.from_numpy(att).requires_grad_(True)
        out = ctx.attend(h, a)
        out.backward(torch.from_numpy(gw[:rows]))
        return out, h.grad, a.grad

    spmm_cuda.reset_launch_counts()
    band_cuda.reset_launch_counts()
    out, dht, datt = run(tc, tc.num_nodes)
    np.testing.assert_allclose(_np(out), np.asarray(out_j), **ATTEND_VALUE)
    np.testing.assert_allclose(_np(dht), np.asarray(dht_j), **ATTEND_GRAD)
    np.testing.assert_allclose(_np(datt), np.asarray(datt_j), **ATTEND_GRAD)
    p_out, p_dht, p_datt = run(plain, plain.num_nodes)
    m = min(plain.num_nodes, tc.num_nodes)
    np.testing.assert_allclose(_np(out)[:m], _np(p_out)[:m], **SELF)
    np.testing.assert_allclose(_np(dht)[:m], _np(p_dht)[:m], **SELF)
    np.testing.assert_allclose(_np(datt), _np(p_datt), **SELF)
    assert not any(band_cuda.LAUNCH_COUNTS.values())
    assert not any(spmm_cuda.LAUNCH_COUNTS.values())


def test_gatv2conv_on_a_band_context_matches_jax():
    """One prepared band context serves GATv2 through its full-stream
    companion (which carries the window tables when attend_window is set)."""
    rng = np.random.default_rng(11)
    s = rng.integers(0, N, 2000)
    r = np.clip(s + rng.integers(-80, 81, 2000), 0, N - 1)
    ei = np.stack([s, r]).astype(np.int32)
    kw = dict(add_self_loops=True, pad_nodes=True, band_window=512,
              attend_window=256, edge_chunk=256)
    tc = kgt_torch.prepare_graph(ei, N, device="cpu", **kw)
    jc = j_prepare(ei, N, **kw)
    assert tc.num_band_edges > 0 and tc.full.attw_plan is not None
    j_layer = JGATv2Conv(output_dim=6, heads=2, add_self_loops=False)
    params = j_layer.init(jax.random.PRNGKey(0), 5)
    t_layer = kgt_torch.GATv2Conv(6, heads=2, add_self_loops=False,
                                  input_dim=5, device="cpu")
    t_layer.load_state_dict(convert.params_from_jax(params))
    x = np.zeros((tc.num_nodes, 5), np.float32)
    x[:N] = rng.standard_normal((N, 5))
    gw = rng.standard_normal((tc.num_nodes, 12)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = j_layer.apply(params, jnp.asarray(x), context=jc)
        gj = jax.grad(lambda p: jnp.sum(
            j_layer.apply(p, jnp.asarray(x), context=jc) * gw))(params)
    got = t_layer(torch.from_numpy(x), context=tc)
    (got * torch.from_numpy(gw)).sum().backward()
    np.testing.assert_allclose(_np(got)[:N], np.asarray(want)[:N],
                               **ATTEND_VALUE)
    for name, p in t_layer.named_parameters():
        np.testing.assert_allclose(
            p.grad.numpy(), np.asarray(gj[name]).reshape(p.shape),
            err_msg=name, **ATTEND_GRAD)


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [1, 7, 40, 130])
def test_cuda_band_kernels_match_plain_versions(f, dtype):
    """On a card: both kernels against their plain versions (the check
    ``chip_smoke.py`` makes at larger sizes), the window scatter twice, bit
    for bit. Skips without a CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    ei = _local_edges(directed=True)
    plan, _ = band_cuda.build_band_plan(ei[0], ei[1], None, 1_024,
                                        window=512)
    band = plan.band.to(dev, dtype)
    base_idx = plan.base_idx.to(dev)
    x = torch.randn(1_024, f, device=dev).to(dtype)
    band_cuda.reset_launch_counts()
    got = band_cuda.band_matmul(x, band, base_idx, 512, 256)
    want = band_cuda.band_matmul_plain(x, band, base_idx, 512, 256)
    ctx = kgt_torch.prepare_graph(ei, N, add_self_loops=True, pad_nodes=True,
                                  attend_window=256, device=dev)
    v = torch.randn(ctx.senders.shape[0], f, device=dev).to(dtype)
    a = band_cuda.window_scatter_sum(v, ctx.attw_sender, ctx.attw_plan)
    b = band_cuda.window_scatter_sum(v, ctx.attw_sender, ctx.attw_plan)
    c = band_cuda.window_scatter_sum_plain(v, ctx.attw_sender, ctx.attw_plan)
    torch.cuda.synchronize()
    assert band_cuda.LAUNCH_COUNTS == {"band_spmm": 1, "window_scatter_sum": 2}
    assert torch.equal(a, b)
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()),
                               **KERNEL[dtype])
    np.testing.assert_allclose(_np(a.cpu()), _np(c.cpu()), **KERNEL[dtype])
