"""Port parity for the segment ops (``ops/segment.py``): sum, count, mean, max,
min, std and softmax, with masks, empty segments and ``indices_are_sorted=``,
against the JAX package's ``keras_geometric_tpu.ops.segment``, forward and
gradient; and the layers' segment max on a sorted stream (the wide segment
max with the cotangent of a tied row split evenly) against XLA's
``segment_max`` gradient on tied inputs.

Tolerance 1e-5 (relative, and absolute times the largest entry): both sides
are f32 library ops, summed in another order. NaN gradients (the std's
square root at a zero variance, in both packages) must sit at the same
places.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_geometric_tpu.ops import segment as jseg
from keras_geometric_tpu_torch.kernels import spmm_cuda
from keras_geometric_tpu_torch.ops import segment as tseg

torch.set_num_threads(1)

N = 12
OPS = ["segment_sum", "segment_mean", "segment_max", "segment_min",
       "segment_std", "segment_softmax"]


def _data(seed, e=60, f=5, sort=False, ties=False):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, N - 3, e).astype(np.int32)  # the last rows empty
    ids[:3] = 4  # a segment of at least three
    if sort:
        ids = np.sort(ids)
    data = rng.standard_normal((e, f)).astype(np.float32)
    if ties:
        data = (np.round(np.maximum(data, 0.0) * 2) / 2).astype(np.float32)
    mask = rng.random(e) > 0.25
    cot = rng.standard_normal((N, f)).astype(np.float32)
    return ids, data, mask, cot


def _close(got, want, what):
    want = np.asarray(want)
    assert np.array_equal(np.isnan(got), np.isnan(want)), what
    got, want = np.nan_to_num(got), np.nan_to_num(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale,
                               err_msg=what)


@pytest.mark.parametrize("sort", [False, True], ids=["unsorted", "sorted"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("op", OPS)
def test_segment_op_and_gradient_match_jax(op, masked, sort):
    ids, data, mask, cot = _data(OPS.index(op), sort=sort, ties=True)
    if op == "segment_softmax":
        cot = np.random.default_rng(1).standard_normal(data.shape).astype(
            np.float32)
    j_mask = jnp.asarray(mask) if masked else None
    t_mask = torch.from_numpy(mask) if masked else None

    def j_fn(d):
        out = getattr(jseg, op)(d, jnp.asarray(ids), N, mask=j_mask,
                                indices_are_sorted=sort)
        return jnp.sum(out * cot), out

    (_, want), j_grad = jax.value_and_grad(j_fn, has_aux=True)(
        jnp.asarray(data))
    d = torch.from_numpy(data).requires_grad_()
    got = getattr(tseg, op)(d, torch.from_numpy(ids), N, mask=t_mask,
                            indices_are_sorted=sort)
    (got * torch.from_numpy(cot)).sum().backward()
    _close(got.detach().numpy(), want, f"{op} forward")
    _close(d.grad.numpy(), j_grad, f"{op} gradient")


@pytest.mark.parametrize("sort", [False, True], ids=["unsorted", "sorted"])
def test_segment_count_matches_jax(sort):
    ids, _, mask, _ = _data(3, sort=sort)
    for m in (None, mask):
        want = jseg.segment_count(jnp.asarray(ids), N,
                                  mask=None if m is None else jnp.asarray(m),
                                  indices_are_sorted=sort)
        got = tseg.segment_count(torch.from_numpy(ids), N,
                                 mask=None if m is None else torch.from_numpy(m),
                                 indices_are_sorted=sort)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_empty_segments_are_zero():
    ids = torch.tensor([0, 0, 2], dtype=torch.int32)
    data = torch.tensor([[1.0], [3.0], [-2.0]])
    for op in ("segment_sum", "segment_mean", "segment_max", "segment_min",
               "segment_std"):
        out = getattr(tseg, op)(data, ids, 4)
        assert out[1].item() == 0.0 and out[3].item() == 0.0, op
    assert tseg.segment_std(data, ids, 4)[2].item() == 0.0  # one entry


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_split_tie_rule_matches_xla_segment_max_gradient(masked):
    """The ROADMAP F5 case: receivers [0, 0, 1, 1, 1, 2] with ties in every
    row; XLA gives each tied element 1/2 and 1/3 of its row's cotangent."""
    recv = np.array([0, 0, 1, 1, 1, 2], np.int32)
    data = np.array([[1.0, 2.0], [1.0, 0.5], [3.0, 0.0], [3.0, 0.0],
                     [3.0, -1.0], [0.0, 0.0]], np.float32)
    mask = np.array([True, True, True, False, True, True]) if masked else None
    cot = np.arange(1, 7, dtype=np.float32).reshape(3, 2)

    def j_loss(d):
        out = jseg.segment_max(d, jnp.asarray(recv), 3,
                               mask=None if mask is None else jnp.asarray(mask),
                               indices_are_sorted=True)
        return jnp.sum(out * cot)

    want = jax.grad(j_loss)(jnp.asarray(data))
    d = torch.from_numpy(data).requires_grad_()
    out = spmm_cuda._segment_max_sorted_split(
        d, torch.from_numpy(recv), 3,
        mask=None if mask is None else torch.from_numpy(mask))
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    if not masked:
        np.testing.assert_allclose(d.grad.numpy()[:, 0],
                                   [0.5, 0.5, 1, 1, 1, 5])
    # The reference kernel's rule gives each tied element the whole share.
    d2 = torch.from_numpy(data).requires_grad_()
    out = spmm_cuda.segment_max_wide_sorted(
        d2, torch.from_numpy(recv), 3,
        mask=None if mask is None else torch.from_numpy(mask))
    (out * torch.from_numpy(cot)).sum().backward()
    assert d2.grad.numpy()[0, 0] == 1.0


@pytest.mark.parametrize("f", [3, 16])
def test_split_rule_matches_xla_on_random_tied_streams(f):
    ids, data, mask, cot = _data(20 + f, e=120, f=f, sort=True, ties=True)

    def j_loss(d):
        out = jseg.segment_max(d, jnp.asarray(ids), N, mask=jnp.asarray(mask),
                               indices_are_sorted=True)
        return jnp.sum(out * cot), out

    (_, want), j_grad = jax.value_and_grad(j_loss, has_aux=True)(
        jnp.asarray(data))
    d = torch.from_numpy(data).requires_grad_()
    out = spmm_cuda._segment_max_sorted_split(
        d, torch.from_numpy(ids), N, mask=torch.from_numpy(mask))
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(j_grad), rtol=1e-6,
                               atol=1e-7)
