"""Port parity for the graph-level readout (``nn/pooling``): the same inputs,
made with numpy from a seed, go through the JAX package's readouts (XLA ops,
no Pallas kernel) and the port's, forward and gradient.

Tolerances, of the largest entry of the reference's result: ``global_pool`` /
``batch_pool`` 1e-6 in f32 and 2e-2 in bf16; ``AttentionPooling`` /
``Set2Set`` with the reference's weights carried by
``convert.params_from_jax`` 1e-5 in f32. Inputs are ReLU'd and rounded to
halves, so maxes hold ties: the port must split a tied column's cotangent
evenly, as ``jnp.max`` and XLA's segment max do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import keras_geometric_tpu_torch as kgt_torch
from keras_geometric_tpu.nn.pooling import attention_pooling as jatt
from keras_geometric_tpu.nn.pooling import global_pooling as jgp
from keras_geometric_tpu_torch import convert
from keras_geometric_tpu_torch.nn.pooling import global_pooling as tgp

torch.set_num_threads(1)

F = 6
SIZES = (5, 7, 6, 9, 8)  # graph sizes; then 5 padded nodes
PAD = 5
TOL = {"f32": 1e-6, "bf16": 2e-2}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    n = sum(SIZES) + PAD
    x = np.round(np.maximum(rng.standard_normal((n, F)), 0.0) * 2) / 2
    x[1, 2] = x[3, 2] = 4.0  # a tied max in graph 0, column 2
    batch = np.concatenate([np.full(s, i) for i, s in enumerate(SIZES)]
                           + [np.full(PAD, len(SIZES))]).astype(np.int32)
    mask = np.arange(n) < sum(SIZES)
    mask[7] = False  # a masked real node
    cot = rng.standard_normal((len(SIZES) + 2, F))
    return x.astype(np.float32), batch, mask, cot.astype(np.float32)


def _close(got, want, tol, what, scale=None):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    if scale is None:
        scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _ref_value_and_grad(fn, x, cot):
    out, vjp = jax.vjp(fn, x)
    return np.asarray(out.astype(jnp.float32)), np.asarray(
        vjp(cot.astype(out.dtype))[0].astype(jnp.float32))


def _port_value_and_grad(fn, x, cot):
    x = x.clone().requires_grad_()
    out = fn(x)
    out.backward(cot.to(out.dtype))
    return out.detach().float().numpy(), x.grad.float().numpy()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("pooling", ["mean", "max", "sum"])
def test_global_pool_matches_reference(pooling, masked, dtype):
    x, _, mask, cot = _inputs()
    jd, td = DTYPES[dtype]
    jmask = jnp.asarray(mask) if masked else None
    tmask = torch.from_numpy(mask) if masked else None
    want = _ref_value_and_grad(
        lambda v: jgp.global_pool(v, pooling, node_mask=jmask),
        jnp.asarray(x, jd), jnp.asarray(cot[:1]))
    got = _port_value_and_grad(
        lambda v: tgp.global_pool(v, pooling, node_mask=tmask),
        torch.from_numpy(x).to(td), torch.from_numpy(cot[:1]))
    _close(got[0], want[0], TOL[dtype], "forward")
    _close(got[1], want[1], TOL[dtype], "gradient")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("pooling", ["mean", "max", "sum"])
def test_batch_pool_matches_reference(pooling, masked, dtype):
    """Graph slot 6 holds no node: the mean divides by its count clamped
    at 1 and the max gives 0; slot 5 holds the padded nodes (the dummy
    graph id), neutral under the mask."""
    x, batch, mask, cot = _inputs(1)
    jd, td = DTYPES[dtype]
    num_graphs = len(SIZES) + 2
    jmask = jnp.asarray(mask) if masked else None
    tmask = torch.from_numpy(mask) if masked else None
    want = _ref_value_and_grad(
        lambda v: jgp.batch_pool(v, jnp.asarray(batch), num_graphs, pooling,
                                 node_mask=jmask),
        jnp.asarray(x, jd), jnp.asarray(cot))
    got = _port_value_and_grad(
        lambda v: tgp.batch_pool(v, torch.from_numpy(batch), num_graphs,
                                 pooling, node_mask=tmask),
        torch.from_numpy(x).to(td), torch.from_numpy(cot))
    _close(got[0], want[0], TOL[dtype], "forward")
    _close(got[1], want[1], TOL[dtype], "gradient")
    assert not got[0][-1].any()  # the empty slot: 0, not NaN
    if masked:
        assert not got[0][len(SIZES)].any()  # the padded nodes' slot


@pytest.mark.parametrize("fn", ["global", "batch", "module"])
def test_max_splits_a_tied_cotangent(fn):
    x = torch.tensor([[1.0, 2.0], [3.0, 2.0], [3.0, 0.0]], requires_grad=True)
    batch = torch.zeros(3, dtype=torch.int32)
    if fn == "global":
        out = tgp.global_pool(x, "max")
    elif fn == "batch":
        out = tgp.batch_pool(x, batch, 1, "max")
    else:
        out = kgt_torch.BatchGlobalPooling("max")(x, batch, 1)
    out.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(),
                                  [[0, 0.5], [0.5, 0.5], [0.5, 0]])
    ref = jax.grad(lambda v: jgp.global_pool(v, "max").sum())(
        jnp.asarray(x.detach().numpy()))
    np.testing.assert_array_equal(np.asarray(ref), x.grad.numpy())


def test_mean_clamps_counts_at_one_and_masked_columns_give_zero():
    x = torch.tensor([[2.0, -1.0], [4.0, -3.0]])
    none = torch.tensor([False, False])
    for pooling in ("mean", "max", "sum"):
        assert not tgp.global_pool(x, pooling, node_mask=none).any()
    out = tgp.batch_pool(x, torch.tensor([0, 0]), 3, "mean")
    np.testing.assert_array_equal(out.numpy(), [[3, -2], [0, 0], [0, 0]])
    out = tgp.batch_pool(x, torch.tensor([0, 1]), 2, "max",
                         node_mask=torch.tensor([True, False]))
    np.testing.assert_array_equal(out.numpy(), [[2, -1], [0, 0]])


def test_pooling_modules_and_their_errors():
    x, batch, mask, _ = _inputs(2)
    tx, tm = torch.from_numpy(x), torch.from_numpy(mask)
    for pooling in ("mean", "max", "sum"):
        assert torch.equal(kgt_torch.GlobalPooling(pooling)(x=tx, node_mask=tm),
                           tgp.global_pool(tx, pooling, node_mask=tm))
        assert torch.equal(
            kgt_torch.BatchGlobalPooling(pooling)(tx, torch.from_numpy(batch),
                                                  6),
            tgp.batch_pool(tx, torch.from_numpy(batch), 6, pooling))
    for bad in (lambda: kgt_torch.GlobalPooling("median"),
                lambda: kgt_torch.BatchGlobalPooling("min"),
                lambda: tgp.global_pool(tx, "prod"),
                lambda: tgp.batch_pool(tx, torch.from_numpy(batch), 6, "std")):
        with pytest.raises(ValueError, match="pooling must be one of"):
            bad()
    assert list(kgt_torch.GlobalPooling().parameters()) == []


# -- AttentionPooling and Set2Set ---------------------------------------------


def _attention_models(kind, seed):
    if kind == "attention":
        jm = jatt.AttentionPooling(attention_dim=5)
        tm = kgt_torch.AttentionPooling(attention_dim=5, input_dim=F,
                                        device="cpu")
    elif kind == "attention_default_dim":
        jm = jatt.AttentionPooling()
        tm = kgt_torch.AttentionPooling(input_dim=F, device="cpu")
    else:
        steps = {"set2set": 3, "set2set_1step": 1}[kind]
        jm = jatt.Set2Set(output_dim=4, processing_steps=steps, lstm_units=5)
        tm = kgt_torch.Set2Set(4, processing_steps=steps, lstm_units=5,
                               input_dim=F, device="cpu")
    params = jm.init(jax.random.PRNGKey(seed), F)
    tm.load_state_dict(convert.params_from_jax(params))
    return jm, params, tm


def _single_graph(seed, n=9):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, F)).astype(np.float32)
    mask = np.ones(n, bool)
    mask[[2, n - 1]] = False
    return x, mask


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("kind", ["attention", "attention_default_dim",
                                  "set2set", "set2set_1step"])
def test_attention_readouts_match_reference(kind, masked):
    jm, params, tm = _attention_models(kind, 3)
    x, mask = _single_graph(4)
    jmask = jnp.asarray(mask) if masked else None
    tmask = torch.from_numpy(mask) if masked else None
    cot = np.random.default_rng(5).standard_normal(
        (1, 5 + F if kind.startswith("set2set") else F)).astype(np.float32)

    def ref_loss(p, v):
        return jnp.sum(jm.apply(p, v, node_mask=jmask) * cot)

    want = jm.apply(params, jnp.asarray(x), node_mask=jmask)
    g_params, g_x = jax.grad(ref_loss, argnums=(0, 1))(params,
                                                       jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    tm.eval()
    out = tm(tx, node_mask=tmask)
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out.detach().numpy(), want, 1e-5, "forward")
    _close(tx.grad.numpy(), g_x, 1e-5, "d x")
    if masked:
        assert not tx.grad[torch.from_numpy(~mask)].any()
    # Parameter gradients: of the largest entry of the whole tree (the
    # score bias's is 0 up to rounding: a softmax ignores a shift).
    ref_grads = convert.params_from_jax(g_params)
    names = dict(tm.named_parameters())
    assert set(names) == set(ref_grads)
    scale = max(float(g.abs().max()) for g in ref_grads.values())
    for name, p in names.items():
        _close(p.grad.numpy(), ref_grads[name].numpy(), 1e-5, name, scale)


@pytest.mark.parametrize("kind", ["attention", "set2set"])
def test_an_all_masked_graph_gives_nan_as_the_reference(kind):
    jm, params, tm = _attention_models(kind, 6)
    x, _ = _single_graph(7, n=4)
    none = np.zeros(4, bool)
    want = np.asarray(jm.apply(params, jnp.asarray(x),
                               node_mask=jnp.asarray(none)))
    got = tm.eval()(torch.from_numpy(x), node_mask=torch.from_numpy(none))
    assert np.isnan(want).all()
    if kind == "attention":
        assert torch.isnan(got).all()
    else:  # Set2Set: NaN reads poison every later state, as in the reference
        np.testing.assert_array_equal(np.isnan(got.detach().numpy()),
                                      np.isnan(want))


def test_attention_readouts_argument_errors():
    for bad in (lambda: kgt_torch.AttentionPooling(attention_dim=0,
                                                   input_dim=F, device="cpu"),
                lambda: kgt_torch.AttentionPooling(dropout=1.5, input_dim=F,
                                                   device="cpu"),
                lambda: kgt_torch.Set2Set(0, input_dim=F, device="cpu"),
                lambda: kgt_torch.Set2Set(4, processing_steps=0, input_dim=F,
                                          device="cpu"),
                lambda: kgt_torch.Set2Set(4, dropout=-0.1, input_dim=F,
                                          device="cpu")):
        with pytest.raises(ValueError):
            bad()
    # The reference refuses a training pass with dropout and no key; the
    # port refuses one with no generator.
    x = torch.from_numpy(_single_graph(8)[0])
    for module in (kgt_torch.AttentionPooling(dropout=0.5, input_dim=F,
                                              device="cpu"),
                   kgt_torch.Set2Set(4, dropout=0.5, input_dim=F,
                                     device="cpu")):
        with pytest.raises(ValueError, match="generator"):
            module.train()(x)
        module.eval()(x)  # no dropout outside training: no generator needed


def test_lstm_parameters_keep_the_reference_layout_and_init():
    s2s = kgt_torch.Set2Set(4, lstm_units=5, input_dim=F, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    shapes = {n: tuple(p.shape) for n, p in s2s.named_parameters()}
    assert shapes == {"lstm.kernel": (F, 20), "lstm.recurrent_kernel": (5, 20),
                      "lstm.bias": (20,), "attention_dense.kernel": (F + 5, 1),
                      "attention_dense.bias": (1,)}
    np.testing.assert_array_equal(s2s.lstm.bias.detach().numpy(),
                                  [0] * 5 + [1] * 5 + [0] * 10)
    rec = s2s.lstm.recurrent_kernel.detach().double()
    np.testing.assert_allclose((rec @ rec.T).numpy(), np.eye(5), atol=1e-6)
    ref = jatt.Set2Set(output_dim=4, lstm_units=5).init(
        jax.random.PRNGKey(0), F)
    np.testing.assert_array_equal(np.asarray(ref["lstm"]["bias"]),
                                  s2s.lstm.bias.detach().numpy())
    assert s2s.out_features(F) == 5 + F


@pytest.mark.parametrize("kind", ["attention", "set2set"])
def test_dropout_keeps_the_contract(kind):
    """Dropout hits the attention input only: every entry there is 0 or the
    undropped value over ``keep`` (the ``x`` columns of Set2Set's ``[x, h]``
    on every step and in the final pass, each with a fresh draw); the
    weighted sum reads the original features; a generator of the same seed
    reproduces the pass, another seed changes it; eval mode ignores it."""
    rate = 0.5
    x = torch.from_numpy(_single_graph(9)[0])
    if kind == "attention":
        module = kgt_torch.AttentionPooling(dropout=rate, input_dim=F,
                                            device="cpu")
        hooked = module.attention_transform
    else:
        module = kgt_torch.Set2Set(4, processing_steps=3, dropout=rate,
                                   input_dim=F, device="cpu")
        hooked = module.attention_dense
    seen = []
    hooked.register_forward_hook(lambda m, args, out: seen.append(args[0]))
    module.train()
    out = module(x, generator=torch.Generator().manual_seed(1))
    assert len(seen) == (1 if kind == "attention" else 4)
    for dropped in seen:
        cols = dropped[:, :F]
        kept = cols != 0
        assert 0 < kept.float().mean() < 1
        torch.testing.assert_close(cols[kept], (x / (1 - rate))[kept],
                                   rtol=0, atol=0)
    assert len({tuple(d[:, :F].ne(0).flatten().tolist()) for d in seen}) > 1 \
        or kind == "attention"
    if kind == "attention":  # the sum reads x, weighted by the dropped scores
        scores = module.attention_score(module.attention_transform(seen[0]))
        weights = torch.softmax(scores, dim=0)
        torch.testing.assert_close(out, (weights * x).sum(0, keepdim=True))
    seen.clear()
    again = module(x, generator=torch.Generator().manual_seed(1))
    assert torch.equal(again, out)
    other = module(x, generator=torch.Generator().manual_seed(2))
    assert not torch.equal(other, out)
    module.eval()
    assert not torch.equal(module(x), out)
