"""Port parity: the sorted scatter / expand of keras_geometric_tpu_torch against
the JAX package's Pallas kernels (interpret mode), forward and VJP.

On the CPU the port's wrappers take their plain PyTorch versions, so these
tests pin the kernels' contract (weights, mask, empty rows, padded slots, any
width); the CUDA kernels themselves are held against the same plain versions
on the card by ``chip_smoke.py``.

Tolerances: f32 1e-5 (the two sum in different orders; the reference runs at
``Precision.HIGHEST`` here, because its default two-pass bf16 split keeps 16
mantissa bits and is itself ~2e-5 off); bf16 2e-2 relative (the port rounds
once at the store, the reference rounds the weighted one-hot operand before
its f32-accumulated product).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from keras_geometric_tpu.kernels import spmm_pallas
from keras_geometric_tpu_torch.kernels import spmm_cuda

torch.set_num_threads(1)

WIDTHS = [1, 7, 16, 32]
VARIANTS = ["weighted", "unweighted", "masked"]
DTYPES = ["float32", "bfloat16"]
PRECISION = jax.lax.Precision.HIGHEST  # exact f32 products; a no-op for bf16 data


def _graph(seed, n=40, e_real=300, e_pad=320):
    """Sorted receivers with empty rows (every 5th node and the tail) and
    padded slots pointing at the last node."""
    rng = np.random.default_rng(seed)
    allowed = np.array([i for i in range(n - 3) if i % 5 != 2])
    recv = np.sort(rng.choice(allowed, e_real)).astype(np.int32)
    recv = np.concatenate([recv, np.full(e_pad - e_real, n - 1, np.int32)])
    w = rng.uniform(0.1, 1.0, e_pad).astype(np.float32)
    w[e_real:] = 0.0
    mask = np.arange(e_pad) < e_real
    return n, recv, w, mask


def _tol(dtype):
    if dtype == "float32":
        return dict(rtol=1e-5, atol=1e-5)
    return dict(rtol=2e-2, atol=2e-2)


def _to_jax(a, dtype):
    return jnp.asarray(a).astype(jnp.dtype(dtype))


def _to_torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t.astype(jnp.float32))


def _variant_args(variant, w, mask):
    if variant == "weighted":
        return w, None
    if variant == "masked":
        return None, mask
    return None, None


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("f", WIDTHS)
def test_scatter_sum_sorted_matches_jax(f, variant, dtype):
    n, recv, w, mask = _graph(f)
    rng = np.random.default_rng(100 + f)
    msgs = rng.standard_normal((recv.shape[0], f)).astype(np.float32)
    g = rng.standard_normal((n, f)).astype(np.float32)
    w_v, m_v = _variant_args(variant, w, mask)

    def jax_fn(m):
        return spmm_pallas.scatter_sum_sorted(
            m, jnp.asarray(recv), n,
            weights=None if w_v is None else jnp.asarray(w_v),
            mask=None if m_v is None else jnp.asarray(m_v),
            precision=PRECISION,
        )

    with pltpu.force_tpu_interpret_mode():
        ref, vjp = jax.vjp(jax_fn, _to_jax(msgs, dtype))
        (ref_grad,) = vjp(_to_jax(g, dtype))

    t_msgs = _to_torch(msgs, dtype).requires_grad_(True)
    out = spmm_cuda.scatter_sum_sorted(
        t_msgs, torch.from_numpy(recv), n,
        weights=None if w_v is None else torch.from_numpy(w_v),
        mask=None if m_v is None else torch.from_numpy(m_v),
    )
    out.backward(_to_torch(g, dtype))

    assert out.dtype == getattr(torch, dtype) and out.shape == (n, f)
    np.testing.assert_allclose(_np(out), _np(ref), **_tol(dtype))
    np.testing.assert_allclose(_np(t_msgs.grad), _np(ref_grad), **_tol(dtype))
    # Empty rows are exactly zero.
    empty = np.setdiff1d(np.arange(n), recv)
    assert empty.size and not _np(out)[empty].any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("weighted", [True, False], ids=["weighted", "unweighted"])
@pytest.mark.parametrize("f", WIDTHS)
def test_expand_sorted_matches_jax(f, weighted, dtype):
    n, recv, w, _ = _graph(10 + f)
    rng = np.random.default_rng(200 + f)
    rows = rng.standard_normal((n, f)).astype(np.float32)
    g = rng.standard_normal((recv.shape[0], f)).astype(np.float32)
    w_v = w if weighted else None

    def jax_fn(r):
        return spmm_pallas.expand_sorted(
            r, jnp.asarray(recv),
            weights=None if w_v is None else jnp.asarray(w_v),
            precision=PRECISION,
        )

    with pltpu.force_tpu_interpret_mode():
        ref, vjp = jax.vjp(jax_fn, _to_jax(rows, dtype))
        (ref_grad,) = vjp(_to_jax(g, dtype))

    t_rows = _to_torch(rows, dtype).requires_grad_(True)
    out = spmm_cuda.expand_sorted(
        t_rows, torch.from_numpy(recv),
        weights=None if w_v is None else torch.from_numpy(w_v),
    )
    out.backward(_to_torch(g, dtype))

    assert out.dtype == getattr(torch, dtype) and out.shape == (recv.shape[0], f)
    np.testing.assert_allclose(_np(out), _np(ref), **_tol(dtype))
    np.testing.assert_allclose(_np(t_rows.grad), _np(ref_grad), **_tol(dtype))


@pytest.mark.parametrize("self_weighted", [False, True], ids=["plain", "diag"])
@pytest.mark.parametrize("f", WIDTHS)
def test_fused_gather_form_equals_gather_then_scatter(f, self_weighted):
    """``gather_scatter_sum_sorted`` is the messages form applied to
    ``h[idx]`` (+ the dense diagonal term): same numbers, no [E, F] array."""
    n, recv, w, _ = _graph(20 + f)
    rng = np.random.default_rng(300 + f)
    h = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, n, recv.shape[0]).astype(np.int32))
    sw = torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32))
    t_recv, t_w = torch.from_numpy(recv), torch.from_numpy(w)
    row_ptr = spmm_cuda.row_ptr_from_sorted(t_recv, n)

    fused = spmm_cuda.gather_scatter_sum_sorted(
        h, idx, t_recv, row_ptr, n, weights=t_w,
        self_weight=sw if self_weighted else None,
    )
    ref = spmm_cuda.scatter_sum_sorted(
        h.index_select(0, idx), t_recv, n, row_ptr=row_ptr, weights=t_w
    )
    if self_weighted:
        ref = ref + h * sw[:, None]
    np.testing.assert_allclose(_np(fused), _np(ref), rtol=1e-5, atol=1e-5)

    # ... and against the reference's gather + Pallas scatter.
    with pltpu.force_tpu_interpret_mode():
        jref = spmm_pallas.scatter_sum_sorted(
            jnp.take(jnp.asarray(h.numpy()), jnp.asarray(idx.numpy()), axis=0),
            jnp.asarray(recv), n, weights=jnp.asarray(w), precision=PRECISION,
        )
    if self_weighted:
        jref = jref + jnp.asarray(h.numpy()) * jnp.asarray(sw.numpy())[:, None]
    np.testing.assert_allclose(_np(fused), _np(jref), rtol=1e-5, atol=1e-5)


def test_unweighted_scatter_sums_padded_slots():
    """Padded slots sit inside the last node's row: an unweighted, unmasked
    scatter adds them, exactly as the reference kernel does."""
    n, recv, _, mask = _graph(7)
    msgs = np.ones((recv.shape[0], 3), np.float32)
    out = spmm_cuda.scatter_sum_sorted(
        torch.from_numpy(msgs), torch.from_numpy(recv), n
    )
    assert out[n - 1, 0].item() == float((~mask).sum())
    with pltpu.force_tpu_interpret_mode():
        ref = spmm_pallas.scatter_sum_sorted(
            jnp.asarray(msgs), jnp.asarray(recv), n
        )
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-6)


def test_row_ptr_matches_reference_tables():
    n, recv, _, _ = _graph(3)
    row_ptr = spmm_cuda.row_ptr_from_sorted(torch.from_numpy(recv), n).numpy()
    tables = spmm_pallas.build_row_tables(recv, n)
    lo = tables.bounds[:, 0, :].reshape(-1)[:n]
    hi = tables.bounds[:, 1, :].reshape(-1)[:n]
    np.testing.assert_array_equal(row_ptr[:-1], lo)
    np.testing.assert_array_equal(row_ptr[1:], hi)
    assert row_ptr.dtype == np.int32 and row_ptr[-1] == recv.shape[0]


def test_unsorted_receivers_rejected():
    recv = torch.tensor([0, 2, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="sorted"):
        spmm_cuda.scatter_sum_sorted(torch.ones(3, 2), recv, 3)
    with pytest.raises(ValueError, match="sorted"):
        spmm_cuda.expand_sorted(torch.ones(3, 2), recv)


def test_scatter_expand_double_backward():
    """Each Function's backward is the other Function, so second-order
    gradients flow."""
    n, recv, w, _ = _graph(5)
    t_recv, t_w = torch.from_numpy(recv), torch.from_numpy(w)
    msgs = torch.randn(recv.shape[0], 4, dtype=torch.float64).float()
    msgs.requires_grad_(True)
    out = spmm_cuda.scatter_sum_sorted(msgs, t_recv, n, weights=t_w)
    g = torch.randn(n, 4).requires_grad_(True)
    (dmsg,) = torch.autograd.grad(out, msgs, g, create_graph=True)
    (dg,) = torch.autograd.grad(dmsg.sum(), g)
    expect = spmm_cuda.scatter_sum_sorted(torch.ones_like(msgs), t_recv, n,
                                          weights=t_w)
    np.testing.assert_allclose(_np(dg), _np(expect), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("f", [128, 40, 16, 7])
def test_cuda_kernels_match_plain_versions(f, dtype):
    """On a card: each CUDA kernel against its plain version (the same check
    ``chip_smoke.py`` makes at larger sizes). Skips without a CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n, recv, w, mask = _graph(40 + f)
    dev = torch.device("cuda")
    rng = np.random.default_rng(400 + f)
    msgs = _to_torch(rng.standard_normal((recv.shape[0], f)).astype(np.float32),
                     dtype).to(dev)
    rows = _to_torch(rng.standard_normal((n, f)).astype(np.float32),
                     dtype).to(dev)
    idx = torch.from_numpy(rng.integers(0, n, recv.shape[0]).astype(np.int32)).to(dev)
    t_recv, t_w, t_mask = (torch.from_numpy(a).to(dev) for a in (recv, w, mask))
    row_ptr = spmm_cuda.row_ptr_from_sorted(torch.from_numpy(recv), n).to(dev)
    with pytest.raises(ValueError, match="row_ptr is required"):
        spmm_cuda.scatter_sum_sorted(msgs, t_recv, n, weights=t_w)
    with pytest.raises(ValueError, match="row_ptr is required"):
        spmm_cuda.expand_sorted(rows, t_recv, weights=t_w)
    spmm_cuda.reset_launch_counts()
    pairs = [
        (spmm_cuda.scatter_sum_sorted(msgs, t_recv, n, row_ptr=row_ptr,
                                      weights=t_w, mask=t_mask),
         spmm_cuda.scatter_sum_sorted_plain(msgs, t_recv, n, weights=t_w,
                                            mask=t_mask)),
        (spmm_cuda.gather_scatter_sum_sorted(rows, idx, t_recv, row_ptr, n,
                                             weights=t_w, self_weight=t_w[:n]),
         spmm_cuda.gather_scatter_sum_sorted_plain(rows, idx, t_recv, n,
                                                   weights=t_w,
                                                   self_weight=t_w[:n])),
        (spmm_cuda.expand_sorted(rows, t_recv, row_ptr=row_ptr, weights=t_w),
         spmm_cuda.expand_sorted_plain(rows, t_recv, weights=t_w)),
    ]
    torch.cuda.synchronize()
    # The three kernels launched here, by name: the module also counts the
    # segment max kernels, which this test does not launch.
    assert [spmm_cuda.LAUNCH_COUNTS[name] for name in (
        "scatter_sum_sorted", "gather_scatter_sum_sorted",
        "expand_sorted")] == [1, 1, 1]
    for got, want in pairs:
        np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), **_tol(dtype))
