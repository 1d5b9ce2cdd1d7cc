"""Port parity: ``prepare_graph`` / ``GraphContext`` of keras_geometric_tpu_torch
against the JAX package's, array for array and op for op (values and
gradients). The JAX side runs its Pallas kernels in interpret mode, with the
whole ``jax.grad`` inside the mode.

Tolerances: prepared integer arrays exact, weights 1e-7; op values and
gradients 1e-4 in f32 (the reference's default two-pass bf16 split of f32 data
keeps 16 mantissa bits, as its own tests allow for).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from keras_geometric_tpu.ops import csr as jcsr
from keras_geometric_tpu_torch.ops import csr as tcsr

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)

# Field of the port's context -> field of the reference's.
ARRAY_FIELDS = {
    "senders": "senders",
    "receivers": "receivers",
    "edge_weight": "edge_weight",
    "bwd_perm": "bwd_perm",
    "senders_sorted": "senders_sorted",
    "edge_mask": "edge_mask",
    "in_degree": "in_degree",
    "self_weight": "self_weight",
    "receivers_ss": "receivers_ss",
    "edge_weight_ss": "edge_weight_ss",
    "edge_mask_ss": "edge_mask_ss",
}
SCALAR_FIELDS = [
    "num_nodes", "num_real_edges", "is_symmetric", "num_diag",
    "num_real_nodes", "has_unit_weights", "num_edges",
]


def _edges(seed, n=60, half=150, symmetric=True):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, n, half)
    b = rng.integers(0, n, half)
    if symmetric:
        ei = np.stack([np.concatenate([a, b]), np.concatenate([b, a])])
    else:
        ei = np.stack([a, b])
    return n, ei.astype(np.int32)


PREPARE_CASES = {
    "bare": dict(),
    "loops": dict(add_self_loops=True),
    "gcn": dict(add_self_loops=True, gcn_normalize=True),
    "gcn_noloops": dict(gcn_normalize=True),
    "symmetric": dict(add_self_loops=True, gcn_normalize=True, symmetric=True),
    "densified": dict(add_self_loops=True, gcn_normalize=True, symmetric=True,
                      densify_self_loops=True),
    "densified_unit": dict(add_self_loops=True, densify_self_loops=True),
    "padded": dict(add_self_loops=True, gcn_normalize=True, pad_nodes=True),
    "bench": dict(add_self_loops=True, gcn_normalize=True, symmetric=True,
                  densify_self_loops=True, pad_nodes=True),
    "companion": dict(add_self_loops=True, gcn_normalize=True,
                      densify_self_loops=True, pad_nodes=True,
                      attend_full_stream=True),
    "small_chunk": dict(gcn_normalize=True, edge_chunk=64),
    "user_weight": dict(add_self_loops=True, gcn_normalize=True,
                        edge_weight="user"),
    "user_weight_only": dict(edge_weight="user"),
}


def _both(kwargs, seed=0, symmetric=True):
    n, ei = _edges(seed, symmetric=symmetric)
    kwargs = dict(kwargs)
    if kwargs.get("edge_weight") == "user":
        kwargs["edge_weight"] = np.random.default_rng(9).uniform(
            0.5, 2.0, ei.shape[1]
        ).astype(np.float32)
    return (
        jcsr.prepare_graph(ei, n, **kwargs),
        tcsr.prepare_graph(ei, n, device="cpu", **kwargs),
    )


def _assert_same_context(jc, tc):
    for t_name, j_name in ARRAY_FIELDS.items():
        jv, tv = getattr(jc, j_name), getattr(tc, t_name)
        assert (jv is None) == (tv is None), t_name
        if jv is None:
            continue
        jv, tv = np.asarray(jv), tv.numpy()
        assert jv.shape == tv.shape and jv.dtype == tv.dtype, t_name
        if np.issubdtype(jv.dtype, np.floating):
            np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-7, err_msg=t_name)
        else:
            np.testing.assert_array_equal(tv, jv, err_msg=t_name)
    for name in SCALAR_FIELDS:
        assert getattr(jc, name) == getattr(tc, name), name
    # The port's tables are just row_ptr per orientation: they must encode
    # the intervals of the reference's boundary tables.
    n = tc.num_nodes
    for row_ptr, tables in ((tc.row_ptr, jc.fwd_tables),
                            (tc.row_ptr_bwd, jc.bwd_tables)):
        row_ptr = row_ptr.numpy()
        np.testing.assert_array_equal(
            row_ptr[:-1], tables.bounds[:, 0, :].reshape(-1)[:n])
        np.testing.assert_array_equal(
            row_ptr[1:], tables.bounds[:, 1, :].reshape(-1)[:n])


@pytest.mark.parametrize("case", sorted(PREPARE_CASES))
def test_prepare_graph_arrays_equal(case):
    kwargs = PREPARE_CASES[case]
    symmetric = "edge_weight" not in kwargs
    jc, tc = _both(kwargs, symmetric=symmetric)
    _assert_same_context(jc, tc)
    assert (jc.full is None) == (tc.full is None)
    if jc.full is not None:
        _assert_same_context(jc.full, tc.full)


def test_prepare_graph_directed_arrays_equal():
    jc, tc = _both(dict(add_self_loops=True, gcn_normalize=True),
                   seed=5, symmetric=False)
    _assert_same_context(jc, tc)


def test_prepare_graph_rejections():
    n, ei = _edges(1)
    # The locality tiers' arguments are checked as in the reference.
    with pytest.raises(ValueError, match="multiple of 256"):
        tcsr.prepare_graph(ei, n, band_window=64, pad_nodes=True,
                           device="cpu")
    for kw in (dict(band_window=256), dict(attend_window=64)):
        with pytest.raises(ValueError, match="requires pad_nodes"):
            tcsr.prepare_graph(ei, n, device="cpu", **kw)
    with pytest.raises(ValueError, match="not symmetric"):
        tcsr.prepare_graph(np.array([[0, 1], [1, 2]]), 3, symmetric=True,
                           device="cpu")
    with pytest.raises(ValueError, match="requires add_self_loops"):
        tcsr.prepare_graph(ei, n, densify_self_loops=True, device="cpu")
    with pytest.raises(ValueError, match="structural weights"):
        tcsr.prepare_graph(ei, n, symmetric=True, device="cpu",
                           edge_weight=np.ones(ei.shape[1], np.float32))
    with pytest.raises(ValueError, match="pad_to requires"):
        tcsr.prepare_graph(ei, n, pad_to=256, device="cpu")


def _h(n, f=8, seed=2):
    return np.random.default_rng(seed).standard_normal((n, f)).astype(np.float32)


def _value_and_grad_jax(fn, arg):
    """``fn(arg)`` and d/d arg of ``sum(tanh(fn(arg)))``, all in interpret mode."""
    with pltpu.force_tpu_interpret_mode():
        out = fn(arg)
        grad = jax.grad(lambda a: jnp.sum(jnp.tanh(fn(a))))(arg)
    return np.asarray(out), np.asarray(grad)


def _value_and_grad_torch(fn, arg):
    arg = arg.clone().requires_grad_(True)
    out = fn(arg)
    torch.tanh(out).sum().backward()
    return out.detach().numpy(), arg.grad.numpy()


SPMM_CASES = {
    "symmetric": (dict(add_self_loops=True, gcn_normalize=True, symmetric=True), True),
    "symmetric_densified": (dict(add_self_loops=True, gcn_normalize=True,
                                 symmetric=True, densify_self_loops=True,
                                 pad_nodes=True), True),
    "general": (dict(add_self_loops=True, gcn_normalize=True), False),
    "general_densified": (dict(add_self_loops=True, gcn_normalize=True,
                               densify_self_loops=True), False),
    "unit": (dict(), False),
}


@pytest.mark.parametrize("op", ["spmm", "spmm_mean"])
@pytest.mark.parametrize("case", sorted(SPMM_CASES))
def test_spmm_value_and_gradient(case, op):
    kwargs, symmetric = SPMM_CASES[case]
    jc, tc = _both(kwargs, seed=3, symmetric=symmetric)
    h = _h(tc.num_nodes)
    jv, jg = _value_and_grad_jax(getattr(jc, op), jnp.asarray(h))
    tv, tg = _value_and_grad_torch(getattr(tc, op), torch.from_numpy(h))
    np.testing.assert_allclose(tv, jv, **TOL)
    np.testing.assert_allclose(tg, jg, **TOL)


def test_spmm_symmetric_double_backward():
    _, tc = _both(dict(add_self_loops=True, gcn_normalize=True, symmetric=True))
    h = torch.from_numpy(_h(tc.num_nodes)).requires_grad_(True)
    g = torch.randn(tc.num_nodes, 8).requires_grad_(True)
    (dh,) = torch.autograd.grad(tc.spmm(h), h, g, create_graph=True)
    (dg,) = torch.autograd.grad(dh.sum(), g)
    expect = tc.spmm(torch.ones(tc.num_nodes, 8))
    np.testing.assert_allclose(dg.numpy(), expect.numpy(), **TOL)


@pytest.mark.parametrize("case", ["gcn", "bare", "companion"])
def test_gather_value_and_gradient(case):
    jc, tc = _both(PREPARE_CASES[case], seed=4)
    h = _h(tc.num_nodes)
    jv, jg = _value_and_grad_jax(jc.gather, jnp.asarray(h))
    tv, tg = _value_and_grad_torch(tc.gather, torch.from_numpy(h))
    np.testing.assert_allclose(tv, jv, **TOL)
    np.testing.assert_allclose(tg, jg, **TOL)


@pytest.mark.parametrize(
    "op,kw",
    [("scatter", {}), ("scatter", {"masked": True}), ("scatter_weighted", {}),
     ("scatter_mean", {}), ("scatter_mean", {"masked": False})],
    ids=["scatter", "scatter_masked", "scatter_weighted", "scatter_mean",
         "scatter_mean_unmasked"],
)
def test_scatter_ops_value_and_gradient(op, kw):
    jc, tc = _both(dict(add_self_loops=True, gcn_normalize=True), seed=6)
    e = tc.receivers.shape[0]
    assert e > tc.num_real_edges  # padded slots exist and are exercised
    msgs = _h(e, seed=7)
    jv, jg = _value_and_grad_jax(
        lambda m: getattr(jc, op)(m, **kw), jnp.asarray(msgs))
    tv, tg = _value_and_grad_torch(
        lambda m: getattr(tc, op)(m, **kw), torch.from_numpy(msgs))
    np.testing.assert_allclose(tv, jv, **TOL)
    np.testing.assert_allclose(tg, jg, **TOL)


def test_gather_receivers_value_and_gradient():
    jc, tc = _both(dict(add_self_loops=True, gcn_normalize=True), seed=8)
    h = _h(tc.num_nodes)
    jv, jg = _value_and_grad_jax(jc.gather_receivers, jnp.asarray(h))
    tv, tg = _value_and_grad_torch(tc.gather_receivers, torch.from_numpy(h))
    np.testing.assert_allclose(tv, jv, **TOL)
    np.testing.assert_allclose(tg, jg, **TOL)


def test_check_message_stream_raises_like_reference():
    jc, tc = _both(PREPARE_CASES["companion"])
    bad = tc.full.receivers.shape[0] + 3
    with pytest.raises(ValueError) as t_err:
        tc.scatter(torch.zeros(bad, 2))
    with pytest.raises(ValueError) as j_err:
        jc.scatter(jnp.zeros((bad, 2)))
    t_msg, j_msg = str(t_err.value), str(j_err.value)
    assert t_msg.split(".")[0] == j_msg.split(".")[0]  # counts sentence
    assert "full_stream()" in t_msg and "full_stream()" in j_msg
    _, plain = _both(dict())
    with pytest.raises(ValueError, match="slots.$"):
        plain.scatter_weighted(torch.zeros(bad, 2))


def test_full_stream_routing():
    _, dens = _both(PREPARE_CASES["densified"])
    with pytest.raises(ValueError, match="attend_full_stream=True"):
        dens.gather(torch.zeros(dens.num_nodes, 2))
    _, comp = _both(PREPARE_CASES["companion"])
    assert comp.full_stream() is comp.full
    assert comp.gather(torch.zeros(comp.num_nodes, 2)).shape[0] == \
        comp.full.receivers.shape[0]
    _, bare = _both(dict())
    assert bare.full_stream() is bare


def test_context_to_and_weight_dtype():
    _, tc = _both(PREPARE_CASES["companion"])
    bf = tc.with_weight_dtype(torch.bfloat16)
    assert bf.edge_weight.dtype == torch.bfloat16
    assert bf.edge_weight_ss.dtype == torch.bfloat16
    assert bf.self_weight.dtype == torch.bfloat16
    assert bf.full.edge_weight.dtype == torch.bfloat16
    assert bf.in_degree.dtype == torch.float32
    assert bf.receivers.dtype == torch.int32
    moved = tc.to("cpu")
    assert moved.device == torch.device("cpu")
    assert torch.equal(moved.edge_index, tc.edge_index)
    assert np.array_equal(moved.edge_index.numpy(), np.asarray(_both(
        PREPARE_CASES["companion"])[0].edge_index))
