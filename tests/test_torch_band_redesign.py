"""The banded SpMM's routes for the H100: the f32 FMA ring and bf16 at widths
that are not a multiple of 8 (``wgmma_flat``).

- ``band_matmul``'s CPU path (its plain version) against the JAX package's
  Pallas ``_band_matmul`` in interpret mode, at the widths the routes are
  built for (F = 1, 7, 16, 47, 64, 100), f32 and bf16, windows of 256 and
  512, on a band with empty row blocks whose last window ends at n_pad.
  Tolerances: f32 1e-5 (both sum exact f32 products, in another order);
  bf16 one unit in the last place (both round the f32 sum once), as
  ``test_torch_band.py`` holds it.
- ``band_route`` for every shape the runs and the chip script give it.
- Step 1 of a GCN at the ogbn-products widths (100 -> 256 -> 47) on a band
  context of a small community graph against the JAX GCN on its band
  context: loss 1e-4, gradients 2e-4 of their largest entry.
- On a card (``cuda`` marker, skipped here): both routes at F = 7, 16, 47,
  64, 100 against the plain version, into a guard-filled output from an
  ``x`` followed by NaN; ``wgmma_flat`` also at F = 130 and 300 (the
  per-row copies of column tiles past 128); the wmma kernel at row blocks
  of 128 and at W = 288, and the f32 route at W = 288 (slabs of 32 where
  the window is not a multiple of 64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import keras_geometric_tpu_torch as kgt_torch
from keras_geometric_tpu.kernels import band_pallas
from keras_geometric_tpu.models import GNNEncoder as JGNNEncoder
from keras_geometric_tpu.ops.csr import prepare_graph as j_prepare
from keras_geometric_tpu.training import train as jtrain
from keras_geometric_tpu_torch import convert
from keras_geometric_tpu_torch.data.datasets import community_graph
from keras_geometric_tpu_torch.kernels import band_cuda
from keras_geometric_tpu_torch.ops import reorder
from keras_geometric_tpu_torch.training import make_node_classification_step

torch.set_num_threads(1)

KERNEL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
          torch.bfloat16: dict(rtol=2.0 ** -7, atol=1e-3)}
WIDTHS = (1, 7, 16, 47, 64, 100)


def _band_case(window, seed=0, n_pad=2_048):
    """A directed local graph whose row blocks 2 and 3 get no edge (an empty
    band) and whose last row block's window is clamped to end at n_pad."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n_pad, 6_000)
    r = r[(r < 512) | (r >= 1_024)]
    s = np.clip(r + rng.integers(-window // 2, window // 2, r.shape[0]), 0,
                n_pad - 1)
    w = rng.uniform(0.1, 1.0, r.shape[0]).astype(np.float32)
    plan, local = band_cuda.build_band_plan(s, r, w, n_pad, window=window)
    j_plan, _ = band_pallas.build_band_plan(s, r, w, n_pad, window=window)
    assert 0 < local.sum()
    assert not plan.band[512:1_024].any()
    assert int(plan.base_idx[-1]) * (window // 2) + window == n_pad
    return plan, j_plan


@pytest.mark.parametrize("window", [256, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", WIDTHS)
def test_band_matmul_cpu_path_matches_pallas(f, dtype, window):
    plan, j_plan = _band_case(window, seed=f)
    n_pad = plan.n_pad
    x = np.random.default_rng(f + 1).standard_normal(
        (n_pad, f)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    with pltpu.force_tpu_interpret_mode():
        want = band_pallas._band_matmul(
            jnp.asarray(x, jdt), j_plan.band.astype(jdt), j_plan.base_idx,
            window, j_plan.row_block)
    xt = torch.from_numpy(x).to(dtype)
    got = band_cuda.band_matmul(xt, plan.band.to(dtype), plan.base_idx,
                                window, plan.row_block)
    assert got.dtype == dtype and got.shape == (n_pad, f)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **KERNEL[dtype])
    assert not got[512:1_024].any()  # the empty blocks' rows


@pytest.mark.parametrize("f,window,row_block,dtype,route", [
    # the banded twin (f32) and the skewed runs (bf16), W = 1,024
    (64, 1024, 256, torch.float32, "fma"),
    (16, 1024, 256, torch.float32, "fma"),
    (7, 1024, 256, torch.float32, "fma"),
    (128, 1024, 256, torch.bfloat16, "wgmma"),
    (40, 1024, 256, torch.bfloat16, "wgmma"),
    (100, 1024, 256, torch.bfloat16, "wgmma_flat"),
    (47, 1024, 256, torch.bfloat16, "wgmma_flat"),
    (7, 1024, 256, torch.bfloat16, "wgmma_flat"),
    # the padded widths timed beside them
    (104, 1024, 256, torch.bfloat16, "wgmma"),
    (48, 1024, 256, torch.bfloat16, "wgmma"),
    (8, 1024, 256, torch.bfloat16, "wgmma"),
    # the kernel sweep's widths and windows
    (1, 256, 256, torch.bfloat16, "wgmma_flat"),
    (130, 512, 256, torch.bfloat16, "wgmma_flat"),
    (256, 512, 256, torch.bfloat16, "wgmma"),
    # what the TMA kernel does not take: other row blocks or windows
    (47, 1024, 128, torch.bfloat16, "wmma"),
    (47, 288, 256, torch.bfloat16, "wmma"),
    (48, 1056, 256, torch.bfloat16, "wmma"),
    # f32 at a window that is not a multiple of 64
    (16, 288, 256, torch.float32, "fma"),
    (7, 288, 256, torch.float32, "fma"),
])
def test_band_route_table(f, window, row_block, dtype, route):
    assert band_cuda.band_route(f, window, row_block, dtype) == route
    assert f"band_spmm({route})" in band_cuda.MODE_LAUNCH_COUNTS


# ---------------------------------------------------------------------------
# A GCN at the ogbn-products widths on a band context
# ---------------------------------------------------------------------------

FEATS, HIDDEN, CLASSES = 100, 256, 47


def test_gcn_products_widths_step_on_a_band_context_matches_jax():
    n = 2_000
    ei = community_graph(n, 14_000, community_size=125, seed=3)
    s, r = ei[0].astype(np.int64), ei[1].astype(np.int64)
    order = reorder.cluster_order(s, r, n)
    inv = reorder.invert_order(order)
    ei = np.stack([inv[s], inv[r]]).astype(np.int32)
    kw = dict(add_self_loops=True, gcn_normalize=True, symmetric=True,
              densify_self_loops=True, pad_nodes=True, band_window=256,
              attend_full_stream=False)
    tc = kgt_torch.prepare_graph(ei, n, device="cpu", **kw)
    jc = j_prepare(ei, n, **kw)
    assert tc.num_nodes == 2_048
    assert tc.num_band_edges > tc.num_real_edges  # the band holds most
    rng = np.random.default_rng(5)
    x = np.zeros((tc.num_nodes, FEATS), np.float32)
    x[:n] = rng.standard_normal((n, FEATS))
    y = np.zeros(tc.num_nodes, np.int32)
    y[:n] = rng.integers(0, CLASSES, n)
    mask = np.arange(tc.num_nodes) < n
    mask[:n] &= rng.random(n) < 0.6
    j_enc = JGNNEncoder.for_context("gcn", (HIDDEN, CLASSES))
    params = j_enc.init(jax.random.PRNGKey(2), FEATS)

    def j_loss(p):
        logits = j_enc.apply(p, jnp.asarray(x), context=jc)
        return jtrain.masked_softmax_cross_entropy(
            logits, jnp.asarray(y), jnp.asarray(mask))

    with pltpu.force_tpu_interpret_mode():
        ref_loss, ref_grads = jax.value_and_grad(j_loss)(params)
    t_enc = kgt_torch.GNNEncoder.for_context(
        "gcn", (HIDDEN, CLASSES), input_dim=FEATS, device="cpu")
    t_enc.load_state_dict(convert.params_from_jax(params))
    step = make_node_classification_step(
        t_enc, torch.optim.SGD(t_enc.parameters(), lr=0.0))
    band_cuda.reset_launch_counts()
    loss = float(step(torch.from_numpy(x), None, torch.from_numpy(y),
                      torch.from_numpy(mask), context=tc))
    assert abs(loss - float(ref_loss)) <= 1e-4
    for name, p in t_enc.named_parameters():
        layer, leaf = name.split(".")
        want = np.asarray(ref_grads[layer][leaf]).reshape(p.shape)
        scale = float(np.abs(want).max())
        assert scale > 0
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=2e-4 * scale, err_msg=name)
    assert not any(band_cuda.LAUNCH_COUNTS.values())  # the CPU path


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------

GUARD = 64
F32, BF16 = torch.float32, torch.bfloat16
GUARDED_CASES = [
    # the runs' window: fma in f32, wgmma or wgmma_flat in bf16
    *[(f, 1_024, 256, dtype, "fma" if dtype == F32 else
       "wgmma" if f % 8 == 0 else "wgmma_flat")
      for f in (7, 16, 47, 64, 100) for dtype in (F32, BF16)],
    # column tiles past 128: each row's part of x by a 1-D copy of its own
    (130, 512, 256, BF16, "wgmma_flat"),
    (300, 1_024, 256, BF16, "wgmma_flat"),
    # the shapes the TMA kernel does not take
    (7, 256, 128, BF16, "wmma"),
    (47, 256, 128, BF16, "wmma"),
    (7, 288, 256, BF16, "wmma"),
    (47, 288, 256, BF16, "wmma"),
    # f32 slabs of 32 at NC = 16 where W % 64 != 0
    (16, 288, 256, F32, "fma"),
    (7, 288, 256, F32, "fma"),
    (47, 288, 256, F32, "fma"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("f,window,row_block,dtype,route", GUARDED_CASES)
def test_cuda_band_routes_into_a_guarded_output(f, window, row_block, dtype,
                                                route):
    """On a card: the route band_route picks, launched into a buffer filled
    with NaN with GUARD more values after its end that must stay NaN, from
    an ``x`` followed by GUARD NaN values, against the plain version. A
    window that build_band_plan makes (a multiple of 256) comes from a local
    graph; another is a dense random band. Skips without a CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(f)
    n_pad = 4_096
    if window % 256 == 0:
        r = rng.integers(0, n_pad, 60_000)
        s = np.clip(r + rng.integers(-window // 2, window // 2, r.shape[0]),
                    0, n_pad - 1)
        plan, _ = band_cuda.build_band_plan(s, r, None, n_pad, window=window,
                                            row_block=row_block)
        band_h, base_h = plan.band, plan.base_idx
    else:
        band_h = torch.from_numpy((rng.uniform(0.1, 1.0, (n_pad, window)) * (
            rng.random((n_pad, window)) < 0.05)).astype(np.float32))
        base_h = torch.from_numpy(np.clip(
            (np.arange(n_pad // row_block) * row_block - 16) // (window // 2),
            0, (n_pad - window) // (window // 2)).astype(np.int32))
    band = band_h.to(dev, dtype)
    base_idx = base_h.to(dev)
    xbuf = torch.full((n_pad * f + GUARD,), float("nan"), dtype=dtype,
                      device=dev)
    x = xbuf[: n_pad * f].view(n_pad, f)
    x.copy_(torch.from_numpy(rng.standard_normal((n_pad, f)).astype(
        np.float32)))
    assert band_cuda.band_route(f, window, row_block, dtype) == route
    buf = torch.full((n_pad * f + GUARD,), float("nan"), dtype=dtype,
                     device=dev)
    out = buf[: n_pad * f].view(n_pad, f)
    band_cuda.reset_launch_counts()
    got = band_cuda._band_matmul_on(route, x, band, base_idx, window,
                                    row_block, out=out)
    again = band_cuda.band_matmul(x, band, base_idx, window, row_block)
    want = band_cuda.band_matmul_plain(x, band, base_idx, window, row_block)
    torch.cuda.synchronize()
    assert got.data_ptr() == out.data_ptr()
    assert band_cuda.MODE_LAUNCH_COUNTS[f"band_spmm({route})"] == 2
    assert bool(buf[n_pad * f:].isnan().all())
    assert torch.equal(got, again)
    mass = band_cuda.band_matmul_plain(x.abs(), band.abs(), base_idx, window,
                                       row_block).float()
    ulp = 2.0 ** -7 if dtype == BF16 else 0.0
    err = (got.float() - want.float()).abs()
    assert bool(torch.isfinite(got).all())
    assert bool((err <= 1e-6 + 2e-5 * mass + ulp * want.float().abs()).all())
