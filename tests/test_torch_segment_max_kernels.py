"""Port parity for the two segment max kernels: ``segment_max_sorted`` (the
narrow per-row max of ``[E, K]`` scores) and ``segment_max_wide_raw`` /
``segment_max_wide_sorted`` (the wide per-row max of ``[E, F]`` messages and
its VJP), against the JAX package's Pallas kernels in interpret mode.

On the CPU the port's wrappers take their plain PyTorch versions, so these
tests pin the kernels' contract; the CUDA kernels are held against the same
plain versions on the card (the ``cuda`` cases here, skipped without a card,
and ``chip_smoke.py``).

Cases: masks, empty rows, a hub row spanning several of the reference's edge
chunks, the ``-1e30`` sentinel (``empty_to_zero=False``), and for the VJP
inputs with ties (ReLU'd messages with whole rows at 0, values repeated):
``segment_max_wide_sorted`` gives every tied element the whole cotangent, as
the reference's kernel does. (The split rule of the layers is held against
XLA's ``segment_max`` in ``tests/test_torch_segment_ops.py``.)

Tolerances: forwards exact (a max is order-free); gradients 1e-6, with the
reference's expands at ``Precision.HIGHEST`` (their default keeps 16 mantissa
bits of the cotangent; ROADMAP D1).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from keras_geometric_tpu.kernels import spmm_pallas as K
from keras_geometric_tpu_torch.kernels import spmm_cuda

torch.set_num_threads(1)


def _stream(seed, n=60, e=700, hub=None, empty_every=4):
    """Sorted receivers with every ``empty_every``-th row empty and, with
    ``hub``, one row of ``hub`` slots (several 128-slot chunks)."""
    rng = np.random.default_rng(seed)
    allowed = np.array([i for i in range(n) if i % empty_every != 1])
    recv = rng.choice(allowed, e)
    if hub is not None:
        recv = np.concatenate([recv, np.full(hub, allowed[2])])
    return np.sort(recv).astype(np.int32)


def _tied(rng, e, f, dtype=np.float32):
    """ReLU'd messages rounded to halves: most rows hold ties, and rows whose
    messages are all <= 0 are tied at 0 in every column."""
    m = np.maximum(rng.standard_normal((e, f)) - 0.3, 0.0)
    return (np.round(m * 2) / 2).astype(dtype)


def _tables(recv, n):
    return K.build_row_tables(recv, n, edge_chunk=128, row_block=32)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 4, 8])
def test_segment_max_sorted_matches_jax(k, dtype, masked):
    rng = np.random.default_rng(k)
    n = 60
    recv = _stream(k, n, hub=400)
    e = recv.shape[0]
    scores = rng.standard_normal((e, k)).astype(np.float32)
    mask = rng.random(e) > 0.3 if masked else None
    with pltpu.force_tpu_interpret_mode():
        want = K.segment_max_sorted(
            jnp.asarray(scores).astype(dtype), jnp.asarray(recv), n,
            tables=_tables(recv, n),
            mask=None if mask is None else jnp.asarray(mask))
    got = spmm_cuda.segment_max_sorted(
        torch.from_numpy(scores).to(getattr(torch, dtype)),
        torch.from_numpy(recv), n,
        mask=None if mask is None else torch.from_numpy(mask))
    assert got.dtype == getattr(torch, dtype) and got.shape == (n, k)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    assert np.isinf(got.float().numpy()[1::4]).all()  # empty rows: -inf


def test_segment_max_sorted_all_masked_row_is_minus_inf():
    recv = np.array([0, 0, 1, 1, 2], np.int32)
    scores = torch.arange(10, dtype=torch.float32).reshape(5, 2)
    mask = torch.tensor([True, True, False, False, True])
    got = spmm_cuda.segment_max_sorted(scores, torch.from_numpy(recv), 4,
                                       mask=mask)
    np.testing.assert_array_equal(
        got.numpy(), [[2, 3], [-np.inf, -np.inf], [8, 9], [-np.inf, -np.inf]])


@pytest.mark.parametrize("empty_to_zero", [True, False],
                         ids=["zero", "sentinel"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("f,hub", [(16, 600), (40, None), (7, None)])
def test_segment_max_wide_sorted_matches_jax(f, hub, masked, empty_to_zero):
    rng = np.random.default_rng(f)
    n = 60
    recv = _stream(f, n, hub=hub)
    e = recv.shape[0]
    msgs = rng.standard_normal((e, f)).astype(np.float32)
    mask = (rng.random(e) > 0.2) if masked else np.ones(e, bool)
    with pltpu.force_tpu_interpret_mode():
        want = K.segment_max_wide_sorted(
            jnp.asarray(msgs), jnp.asarray(recv), n, tables=_tables(recv, n),
            mask=jnp.asarray(mask.astype(np.float32)),
            empty_to_zero=empty_to_zero)
    got = spmm_cuda.segment_max_wide_sorted(
        torch.from_numpy(msgs), torch.from_numpy(recv), n,
        mask=torch.from_numpy(mask), empty_to_zero=empty_to_zero)
    assert got.dtype == torch.float32 and got.shape == (n, f)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:n])
    empty = got.numpy()[1::4]
    assert (empty == (0.0 if empty_to_zero else -1e30)).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_max_wide_raw_matches_jax(dtype):
    rng = np.random.default_rng(3)
    n = 60
    recv = _stream(3, n, hub=300)
    e = recv.shape[0]
    msgs = _tied(rng, e, 24)
    mask = rng.random(e) > 0.25
    with pltpu.force_tpu_interpret_mode():
        want = K.segment_max_wide_raw(
            jnp.asarray(msgs).astype(dtype), n, tables=_tables(recv, n),
            mask=jnp.asarray(mask.astype(np.float32)))
    row_ptr = spmm_cuda.row_ptr_from_sorted(torch.from_numpy(recv), n)
    got = spmm_cuda.segment_max_wide_raw(
        torch.from_numpy(msgs).to(getattr(torch, dtype)), n, row_ptr=row_ptr,
        mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:n])


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("empty_to_zero", [True, False],
                         ids=["zero", "sentinel"])
def test_segment_max_wide_vjp_on_tied_inputs_matches_jax(
        monkeypatch, empty_to_zero, masked):
    """Every tied element receives the row's whole cotangent, as in the
    reference's kernel VJP (not XLA's split)."""
    rng = np.random.default_rng(11)
    n, f = 50, 12
    recv = _stream(11, n, e=500, hub=300)
    e = recv.shape[0]
    msgs = _tied(rng, e, f)
    assert (msgs == 0).all(axis=1).any()  # whole rows tied at 0 exist
    mask = (rng.random(e) > 0.2) if masked else np.ones(e, bool)
    w = rng.standard_normal((n, f)).astype(np.float32)
    # The reference's VJP expands the cotangent at its default precision;
    # held at HIGHEST, it routes the cotangent unrounded.
    monkeypatch.setattr(K, "expand_sorted", functools.partial(
        K.expand_sorted, precision=jax.lax.Precision.HIGHEST))
    tables = _tables(recv, n)

    def loss(m):
        out = K.segment_max_wide_sorted(
            m, jnp.asarray(recv), n, tables=tables,
            mask=jnp.asarray(mask.astype(np.float32)),
            empty_to_zero=empty_to_zero)[:n]
        out = jnp.where(out <= -1e29, 0.0, out)
        return jnp.sum(out * w)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss)(jnp.asarray(msgs))
    m = torch.from_numpy(msgs).requires_grad_()
    out = spmm_cuda.segment_max_wide_sorted(
        m, torch.from_numpy(recv), n, mask=torch.from_numpy(mask),
        empty_to_zero=empty_to_zero)
    out = torch.where(out <= -1e29, torch.zeros_like(out), out)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(m.grad.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # Ties: some row has more than one element at its max, and each of them
    # got the whole cotangent.
    tied = (m.grad.numpy() != 0).sum(axis=0)
    assert (tied > n - n // 4).any()


def test_wrappers_check_their_arguments():
    recv = torch.tensor([0, 0, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match=r"\[E, K\]"):
        spmm_cuda.segment_max_sorted(torch.zeros(3), recv, 2)
    with pytest.raises(ValueError, match=r"\[E, F\]"):
        spmm_cuda.segment_max_wide_sorted(torch.zeros(3), recv, 2)
    with pytest.raises(ValueError, match="sorted"):
        spmm_cuda.segment_max_wide_sorted(
            torch.zeros(3, 2), torch.tensor([1, 0, 0], dtype=torch.int32), 2)
    # A 1/0 float mask is taken as the JAX package passes it.
    out = spmm_cuda.segment_max_wide_sorted(
        torch.tensor([[1.0], [5.0], [2.0]]), recv, 2,
        mask=torch.tensor([1.0, 0.0, 1.0]))
    np.testing.assert_array_equal(out.numpy(), [[1.0], [2.0]])


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("f", [1, 7, 40, 128, 320])
def test_cuda_kernels_match_plain_versions(f, dtype, masked):
    """The narrow and wide kernels against their plain versions: forwards
    bit for bit, the backward in both tie rules bit for bit too (the same
    comparisons, counts and divisions). Skips without a CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(f)
    n = 300
    recv_np = _stream(f, n, e=3000, hub=2000)
    e = recv_np.shape[0]
    recv = torch.from_numpy(recv_np).to(dev)
    row_ptr = spmm_cuda.row_ptr_from_sorted(torch.from_numpy(recv_np),
                                            n).to(dev)
    mask = torch.from_numpy(rng.random(e) > 0.2).to(dev) if masked else None
    msgs = torch.from_numpy(_tied(rng, e, f)).to(dev).to(dtype)
    g = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32)).to(
        dev)
    spmm_cuda.reset_launch_counts()
    for k in (1, 4, 8, 11):
        scores = torch.from_numpy(rng.standard_normal((e, k)).astype(
            np.float32)).to(dev).to(dtype)
        got = spmm_cuda.segment_max_sorted(scores, recv, n, row_ptr=row_ptr,
                                           mask=mask)
        want = spmm_cuda.segment_max_sorted_plain(scores, recv, n, mask=mask)
        assert torch.equal(got, want)
    for empty_to_zero in (True, False):
        got = spmm_cuda._segment_max_wide_fwd(msgs, recv, row_ptr, n, mask,
                                              empty_to_zero)
        want = spmm_cuda.segment_max_wide_raw_plain(
            msgs, recv, n, mask=mask, empty_to_zero=empty_to_zero)
        assert torch.equal(got, want)
    for ties_split in (False, True):
        got = spmm_cuda._segment_max_wide_bwd(msgs, want, g, recv, row_ptr, n,
                                              mask, ties_split)
        ref = spmm_cuda.segment_max_wide_bwd_plain(
            msgs, want, g, recv, n, mask=mask, ties_split=ties_split)
        assert torch.equal(got, ref)
    torch.cuda.synchronize()
    assert spmm_cuda.LAUNCH_COUNTS["segment_max_sorted"] == 4
    assert spmm_cuda.LAUNCH_COUNTS["segment_max_wide_sorted"] == 2
    assert spmm_cuda.LAUNCH_COUNTS["segment_max_wide_bwd"] == 2
    assert spmm_cuda.MODE_LAUNCH_COUNTS[
        "segment_max_wide_bwd(ties_split)"] == 1
