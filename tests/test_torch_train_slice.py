"""Port parity for the slice as a whole: the same graph and the same converted
weights go through N optimizer steps of the JAX training step (context-closing
model, Pallas kernels in interpret mode) and of
``keras_geometric_tpu_torch.training.make_node_classification_step``.

f32: per-step loss within 1e-4, final parameters within 1e-4 (order of
summation; the reference's kernels split f32 data into two bf16 passes). bf16
IO: step-1 loss within 2e-2 and gradients within 8e-2 of their largest entry
(the frameworks round at different places).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import keras_geometric_tpu_torch as kgt_torch
from keras_geometric_tpu.models import GNNEncoder as JGNNEncoder
from keras_geometric_tpu.ops.csr import prepare_graph as j_prepare
from keras_geometric_tpu.ops.precompute import (
    precompute_propagation as j_precompute,
)
from keras_geometric_tpu.training import train as jtrain
from keras_geometric_tpu_torch import convert
from keras_geometric_tpu_torch.training import (
    make_eval_fn,
    make_node_classification_step,
    masked_accuracy,
    masked_softmax_cross_entropy,
)

torch.set_num_threads(1)

N_STEPS = 5
F_IN, HIDDEN, CLASSES = 6, 16, 4

CONTEXTS = {
    "bench": dict(add_self_loops=True, gcn_normalize=True, symmetric=True,
                  densify_self_loops=True, pad_nodes=True),
    "general": dict(add_self_loops=True, gcn_normalize=True),
}
OPTIMIZERS = {
    "adam": (lambda: optax.adam(1e-2),
             lambda p: torch.optim.Adam(p, lr=1e-2)),
    "adamw": (lambda: optax.adamw(1e-2, weight_decay=5e-4),
              lambda p: torch.optim.AdamW(p, lr=1e-2, weight_decay=5e-4)),
}


def _workload(kind, seed=0, n=70, half=160):
    rng = np.random.default_rng(seed)
    a, b = rng.integers(0, n, half), rng.integers(0, n, half)
    if kind == "bench":
        ei = np.stack([np.concatenate([a, b]), np.concatenate([b, a])])
    else:
        ei = np.stack([a, b])
    ei = ei.astype(np.int32)
    jc = j_prepare(ei, n, **CONTEXTS[kind])
    tc = kgt_torch.prepare_graph(ei, n, device="cpu", **CONTEXTS[kind])
    n_pad = tc.num_nodes
    x = np.zeros((n_pad, F_IN), np.float32)
    x[:n] = rng.standard_normal((n, F_IN))
    y = np.zeros(n_pad, np.int32)
    y[:n] = rng.integers(0, CLASSES, n)
    mask = (np.arange(n_pad) < n) & (rng.random(n_pad) < 0.6)
    return jc, tc, x, y, mask


class _ContextModel:
    """The reference's step wants ``apply(params, x, edge_index, training=,
    rng=)``: close over the context."""

    def __init__(self, encoder, context):
        self.encoder, self.context = encoder, context

    def apply(self, params, x, edge_index, training=False, rng=None):
        return self.encoder.apply(params, x, context=self.context,
                                  training=training, rng=rng)


def _models(seed=0):
    j_enc = JGNNEncoder.for_context("gcn", (HIDDEN, CLASSES))
    params = j_enc.init(jax.random.PRNGKey(seed), F_IN)
    t_enc = kgt_torch.GNNEncoder.for_context(
        "gcn", (HIDDEN, CLASSES), input_dim=F_IN, device="cpu")
    t_enc.load_state_dict(convert.params_from_jax(params))
    return j_enc, params, t_enc


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
@pytest.mark.parametrize("kind", sorted(CONTEXTS))
def test_training_steps_match_jax(kind, opt):
    jc, tc, x, y, mask = _workload(kind)
    j_enc, params, t_enc = _models()
    make_tx, make_opt = OPTIMIZERS[opt]

    tx = make_tx()
    j_step = jtrain.make_node_classification_step(
        _ContextModel(j_enc, jc), tx, donate=False)
    state = jtrain.TrainState.create(params, tx, jax.random.PRNGKey(0))
    j_losses = []
    with pltpu.force_tpu_interpret_mode():
        for _ in range(N_STEPS):
            state, loss = j_step(state, jnp.asarray(x), None, jnp.asarray(y),
                                 jnp.asarray(mask))
            j_losses.append(float(loss))

    t_step = make_node_classification_step(t_enc, make_opt(t_enc.parameters()))
    tx_, ty, tm = torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(mask)
    t_losses = [float(t_step(tx_, None, ty, tm, context=tc))
                for _ in range(N_STEPS)]

    np.testing.assert_allclose(t_losses, j_losses, rtol=0, atol=1e-4)
    assert t_losses[-1] < t_losses[0]
    final = convert.params_to_numpy(t_enc.state_dict())
    for layer, leaves in state.params.items():
        for name, value in leaves.items():
            np.testing.assert_allclose(
                final[layer][name], np.asarray(value), rtol=0, atol=1e-4,
                err_msg=f"{layer}.{name}")
    assert int(state.step) == N_STEPS


def test_bf16_io_first_step_matches_jax():
    """bf16 activations / per-step bf16 parameter copies / f32 masters: loss
    and master gradients of step 1 against the reference's bf16 recipe."""
    jc, tc, x, y, mask = _workload("bench", seed=1)
    j_enc, params, t_enc = _models(seed=1)
    jc = jc._replace(edge_weight=jc.edge_weight.astype(jnp.bfloat16),
                     self_weight=jc.self_weight.astype(jnp.bfloat16))
    tc = tc.with_weight_dtype(torch.bfloat16)

    def j_loss(p):
        pb = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), p)
        logits = j_enc.apply(pb, jnp.asarray(x).astype(jnp.bfloat16),
                             context=jc)
        return jtrain.masked_softmax_cross_entropy(
            logits.astype(jnp.float32), jnp.asarray(y), jnp.asarray(mask))

    with pltpu.force_tpu_interpret_mode():
        jl, jg = jax.value_and_grad(j_loss)(params)

    opt = torch.optim.SGD(t_enc.parameters(), lr=0.0)
    step = make_node_classification_step(t_enc, opt,
                                         compute_dtype=torch.bfloat16)
    tl = float(step(torch.from_numpy(x), None, torch.from_numpy(y),
                    torch.from_numpy(mask), context=tc))
    assert abs(tl - float(jl)) <= 2e-2
    for name, p in t_enc.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        layer, leaf = name.split(".")
        ref = np.asarray(jg[layer][leaf])
        np.testing.assert_allclose(
            p.grad.numpy(), ref, rtol=0, atol=8e-2 * np.abs(ref).max(),
            err_msg=name)


def test_bf16_io_training_keeps_f32_masters_and_learns():
    _, tc, x, y, mask = _workload("bench", seed=2)
    _, _, t_enc = _models(seed=2)
    step = make_node_classification_step(
        t_enc, torch.optim.Adam(t_enc.parameters(), lr=1e-2),
        compute_dtype=torch.bfloat16)
    args = (torch.from_numpy(x), None, torch.from_numpy(y),
            torch.from_numpy(mask))
    losses = [float(step(*args, context=tc.with_weight_dtype(torch.bfloat16)))
              for _ in range(15)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert all(p.dtype == torch.float32 for p in t_enc.parameters())


@pytest.mark.parametrize("hops", [1, 2])
def test_precompute_propagation_matches_jax(hops):
    jc, tc, x, _, _ = _workload("bench", seed=3)
    with pltpu.force_tpu_interpret_mode():
        ref = j_precompute(jc, jnp.asarray(x), hops=hops)
    x_t = torch.from_numpy(x).requires_grad_(True)
    out = kgt_torch.precompute_propagation(tc, x_t, hops=hops)
    assert not out.requires_grad
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    with pytest.raises(ValueError, match="hops"):
        kgt_torch.precompute_propagation(tc, x_t, hops=0)


def test_hoisted_first_layer_gives_same_gradients():
    """``(S X) W1`` with ``S X`` computed once equals the first layer's
    propagate-first branch: same loss, same gradients, in the port and
    against the reference's hoisted loss."""
    jc, tc, x, y, mask = _workload("bench", seed=4)
    j_enc, params, t_enc = _models(seed=4)
    tx_, ty, tm = torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(mask)

    t_enc.eval()
    loss_full = masked_softmax_cross_entropy(t_enc(tx_, context=tc), ty, tm)
    g_full = torch.autograd.grad(loss_full, list(t_enc.parameters()))

    sx = kgt_torch.precompute_propagation(tc, tx_)
    l0, l1 = t_enc.layers()
    h = torch.relu(sx @ l0.kernel + l0.bias)
    loss_hoisted = masked_softmax_cross_entropy(l1(h, context=tc), ty, tm)
    g_hoisted = torch.autograd.grad(loss_hoisted, list(t_enc.parameters()))

    assert abs(loss_full.item() - loss_hoisted.item()) <= 1e-6
    for a, b in zip(g_full, g_hoisted):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)

    def j_hoisted(p, sx_j):
        hh = jax.nn.relu(sx_j @ p["layer_0"]["kernel"] + p["layer_0"]["bias"])
        logits = j_enc._layers()[1].apply(p["layer_1"], hh, context=jc)
        return jtrain.masked_softmax_cross_entropy(
            logits, jnp.asarray(y), jnp.asarray(mask))

    with pltpu.force_tpu_interpret_mode():
        sx_j = j_precompute(jc, jnp.asarray(x))
        jl, jg = jax.value_and_grad(j_hoisted)(params, sx_j)
    assert abs(loss_hoisted.item() - float(jl)) <= 1e-4
    for (name, _), g in zip(t_enc.named_parameters(), g_hoisted):
        layer, leaf = name.split(".")
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[layer][leaf]),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_losses_and_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((50, 7)).astype(np.float32) * 3
    labels = rng.integers(0, 7, 50).astype(np.int32)
    mask = rng.random(50) < (0.5 if seed else 0.0)  # seed 0: empty mask
    args_j = (jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask))
    args_t = (torch.from_numpy(logits), torch.from_numpy(labels),
              torch.from_numpy(mask))
    np.testing.assert_allclose(
        float(masked_softmax_cross_entropy(*args_t)),
        float(jtrain.masked_softmax_cross_entropy(*args_j)), atol=1e-6)
    np.testing.assert_allclose(
        float(masked_accuracy(*args_t)),
        float(jtrain.masked_accuracy(*args_j)), atol=1e-7)


def test_eval_fn_matches_jax():
    jc, tc, x, y, mask = _workload("general", seed=5)
    j_enc, params, t_enc = _models(seed=5)
    j_eval = jtrain.make_eval_fn(_ContextModel(j_enc, jc))
    with pltpu.force_tpu_interpret_mode():
        ref = float(j_eval(params, jnp.asarray(x), None, jnp.asarray(y),
                           jnp.asarray(mask)))
    t_enc.train()
    acc = make_eval_fn(t_enc)(torch.from_numpy(x), None, torch.from_numpy(y),
                              torch.from_numpy(mask), context=tc)
    assert not t_enc.training  # evaluation switches dropout off
    assert abs(float(acc) - ref) <= 1e-6


def test_encoder_dropout_is_drawn_from_the_generator():
    _, tc, x, y, mask = _workload("general", seed=6)
    enc = kgt_torch.GNNEncoder.for_context(
        "gcn", (HIDDEN, CLASSES), input_dim=F_IN, dropout_rate=0.5,
        device="cpu", generator=torch.Generator().manual_seed(0))
    enc.train()
    xt = torch.from_numpy(x)
    a = enc(xt, context=tc, generator=torch.Generator().manual_seed(1))
    b = enc(xt, context=tc, generator=torch.Generator().manual_seed(1))
    c = enc(xt, context=tc, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    enc.eval()
    assert torch.equal(enc(xt, context=tc), enc(xt, context=tc))
