"""Port parity for the composed GATv2 attention path of keras_geometric_tpu_torch:
``GraphContext.edge_softmax`` and ``GraphContext.sddmm_scores`` (values and
cotangents), ``GATv2Conv(fused_attend=False)`` and ``return_attention=True``
on a context, and a 2-layer composed training step, against the JAX package
on the same numpy inputs.

Where the JAX function reaches a Pallas kernel it runs in interpret mode, the
whole ``jax.grad`` inside it. Weights are carried over with
``convert.params_from_jax``.

Tolerances: against the reference's kernel paths its own (value 1e-4,
layer gradients rtol 1e-3 / atol 3e-3; 1e-4 for the context ops on
unit-scale inputs and for the training step's loss and gradients: its f32
kernels split operands into two bf16 passes, ~2e-5 exact); against the port's own fused path and its autograd
restatements 1e-5 (both sides f32 library ops or kernels' plain versions in
another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import keras_geometric_tpu_torch as kgt_torch
from keras_geometric_tpu.models import GNNEncoder as JGNNEncoder
from keras_geometric_tpu.nn.gatv2_conv import GATv2Conv as JGATv2Conv
from keras_geometric_tpu.ops.csr import prepare_graph as j_prepare
from keras_geometric_tpu.training import train as jtrain
from keras_geometric_tpu_torch import convert
from keras_geometric_tpu_torch.kernels import sddmm_cuda, softmax_cuda
from keras_geometric_tpu_torch.ops import segment as tsegment
from keras_geometric_tpu_torch.training import make_node_classification_step

torch.set_num_threads(1)

N, F_IN = 40, 5
SLOPE = 0.2
PLAIN = dict(rtol=1e-5, atol=1e-5)
KERNEL_VALUE = dict(rtol=1e-4, atol=1e-4)
KERNEL_GRAD = dict(rtol=1e-3, atol=3e-3)

CONTEXTS = {
    "stream": dict(add_self_loops=True, edge_chunk=64),
    # A context prepared for GCN: the self-loops are a dense diagonal, so
    # per-edge ops route through the full-stream companion.
    "densified": dict(add_self_loops=True, gcn_normalize=True,
                      densify_self_loops=True, attend_full_stream=True,
                      edge_chunk=64),
}


def _graph(seed=0, e=150):
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, N, e), rng.integers(0, N - 3, e)])
    ei[:, 1] = ei[:, 0]  # a duplicate edge; nodes N-3.. receive only loops
    x = rng.standard_normal((N, F_IN)).astype(np.float32)
    return ei.astype(np.int32), x


def _contexts(kind, ei):
    return (j_prepare(ei, N, **CONTEXTS[kind]),
            kgt_torch.prepare_graph(ei, N, device="cpu", **CONTEXTS[kind]))


def _np(t):
    return t.detach().float().numpy()


def _layers(seed=0, **kwargs):
    """The reference layer, its parameters, and the port's layer loaded with
    the same parameters through ``convert.params_from_jax``."""
    j_layer = JGATv2Conv(**kwargs)
    params = j_layer.init(jax.random.PRNGKey(seed), F_IN)
    params["bias"] = params["bias"] + 0.1 * jnp.arange(
        params["bias"].shape[0], dtype=jnp.float32)
    kwargs = dict(kwargs)
    t_layer = kgt_torch.GATv2Conv(kwargs.pop("output_dim"), input_dim=F_IN,
                                  device="cpu", **kwargs)
    t_layer.load_state_dict(convert.params_from_jax(params))
    return j_layer, params, t_layer


# ---------------------------------------------------------------------------
# GraphContext.edge_softmax / sddmm_scores
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(CONTEXTS))
@pytest.mark.parametrize("k", [1, 4])
def test_edge_softmax_value_and_cotangent_match_jax(k, kind):
    ei, _ = _graph(seed=k)
    jc, tc = _contexts(kind, ei)
    e = int(tc.full_stream().senders.shape[0])
    assert e == int(jc.full_stream().senders.shape[0])
    rng = np.random.default_rng(20 + k)
    scores = (2.0 * rng.standard_normal((e, k))).astype(np.float32)

    def j_loss(s):
        return jnp.sum(jnp.tanh(jc.edge_softmax(s)))

    with pltpu.force_tpu_interpret_mode():
        ref = jc.edge_softmax(jnp.asarray(scores))
        ref_g = jax.grad(j_loss)(jnp.asarray(scores))
    s = torch.from_numpy(scores).requires_grad_(True)
    alpha = tc.edge_softmax(s)
    torch.tanh(alpha).sum().backward()
    assert alpha.dtype == torch.float32 and alpha.shape == (e, k)
    np.testing.assert_allclose(_np(alpha), np.asarray(ref), **KERNEL_VALUE)
    np.testing.assert_allclose(_np(s.grad), np.asarray(ref_g), **KERNEL_VALUE)

    # The hand-written backward against autograd over the library-op
    # softmax (the reference's own oracle, ops/segment.segment_softmax).
    full = tc.full_stream()
    r = torch.from_numpy(scores).requires_grad_(True)
    restated = tsegment.segment_softmax(r, full.receivers.long(),
                                        full.num_nodes, mask=full.edge_mask,
                                        eps=1e-10)
    torch.tanh(restated).sum().backward()
    np.testing.assert_allclose(_np(alpha), _np(restated), **PLAIN)
    np.testing.assert_allclose(_np(s.grad), _np(r.grad), **PLAIN)


def test_edge_softmax_rows_sum_to_one_and_pads_weigh_nothing():
    ei, _ = _graph(seed=3, e=300)
    tc = kgt_torch.prepare_graph(ei, N, add_self_loops=True, edge_chunk=128,
                                 device="cpu")
    e = int(tc.senders.shape[0])
    assert e > tc.num_real_edges  # padded slots exist
    scores = torch.from_numpy(
        np.random.default_rng(4).standard_normal((e, 2)).astype(np.float32))
    alpha = tc.edge_softmax(scores)
    assert not alpha[~tc.edge_mask].any()
    sums = torch.zeros(N, 2).index_add_(0, tc.receivers.long(), alpha)
    np.testing.assert_allclose(_np(sums), 1.0, rtol=1e-6)  # every node a loop
    # bf16 scores: alpha in the scores' type.
    assert tc.edge_softmax(scores.bfloat16()).dtype == torch.bfloat16
    with pytest.raises(ValueError, match=r"scores must be \["):
        tc.edge_softmax(scores[:-1])


@pytest.mark.parametrize("kind", sorted(CONTEXTS))
@pytest.mark.parametrize("heads,f", [(2, 8), (4, 3)])
def test_sddmm_scores_value_and_cotangents_match_jax(heads, f, kind):
    ei, _ = _graph(seed=heads)
    jc, tc = _contexts(kind, ei)
    rng = np.random.default_rng(30 + heads)
    ht = rng.standard_normal((N, heads * f)).astype(np.float32)
    att = rng.standard_normal((heads, f)).astype(np.float32)
    e = int(tc.full_stream().senders.shape[0])
    hj = rng.standard_normal((e, heads * f)).astype(np.float32)
    g = rng.standard_normal((e, heads)).astype(np.float32)

    def j_loss(ht_, hj_, att_):
        return jnp.sum(jc.sddmm_scores(ht_, hj_, att_) * g)

    with pltpu.force_tpu_interpret_mode():
        ref = jc.sddmm_scores(jnp.asarray(ht), jnp.asarray(hj),
                              jnp.asarray(att))
        ref_grads = jax.grad(j_loss, argnums=(0, 1, 2))(
            jnp.asarray(ht), jnp.asarray(hj), jnp.asarray(att))
    args = [torch.from_numpy(a).requires_grad_(True) for a in (ht, hj, att)]
    scores = tc.sddmm_scores(*args)
    scores.backward(torch.from_numpy(g))
    assert scores.dtype == torch.float32 and scores.shape == (e, heads)
    np.testing.assert_allclose(_np(scores), np.asarray(ref), **KERNEL_VALUE)
    for a, ref_g, name in zip(args, ref_grads, ("d ht", "d hj", "d att")):
        # d ht and d att sum many slots: scale with the largest entry.
        scale = max(1.0, float(np.abs(np.asarray(ref_g)).max()))
        np.testing.assert_allclose(_np(a.grad), np.asarray(ref_g), rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)

    # Against autograd over the library-op restatement.
    full = tc.full_stream()
    r_args = [torch.from_numpy(a).requires_grad_(True) for a in (ht, hj, att)]
    hi = r_args[0][full.receivers.long()].view(e, heads, f)
    pre = hi + r_args[1].view(e, heads, f)
    restated = (torch.nn.functional.leaky_relu(pre, SLOPE)
                * r_args[2]).sum(-1)
    restated.backward(torch.from_numpy(g))
    np.testing.assert_allclose(_np(scores), _np(restated), **PLAIN)
    for a, b in zip(args, r_args):
        np.testing.assert_allclose(_np(a.grad), _np(b.grad), **PLAIN)


def test_sddmm_scores_through_the_gather_matches_jax():
    """The public composition ``sddmm_scores(ht, gather(ht), att)``: ``d hj``
    flows back through the gather into ``d ht`` (duplicate edges, isolated
    nodes, padded slots masked downstream), as the reference's own test of
    its context op (tests/test_sddmm_kernel.py) runs it."""
    ei, _ = _graph(seed=5)
    jc, tc = _contexts("stream", ei)
    rng = np.random.default_rng(6)
    ht = rng.standard_normal((N, 12)).astype(np.float32)
    att = rng.standard_normal((3, 4)).astype(np.float32)

    def j_loss(ht_, att_):
        s = jc.sddmm_scores(ht_, jc.gather(ht_), att_)
        return jnp.sum(jnp.tanh(jnp.where(jc.edge_mask[:, None], s, 0.0)))

    with pltpu.force_tpu_interpret_mode():
        ref_loss = j_loss(jnp.asarray(ht), jnp.asarray(att))
        ref_g = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(ht),
                                                 jnp.asarray(att))
    t_ht = torch.from_numpy(ht).requires_grad_(True)
    t_att = torch.from_numpy(att).requires_grad_(True)
    s = tc.sddmm_scores(t_ht, tc.gather(t_ht), t_att)
    loss = torch.tanh(torch.where(tc.edge_mask[:, None], s, 0.0)).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-5)
    np.testing.assert_allclose(_np(t_ht.grad), np.asarray(ref_g[0]),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(_np(t_att.grad), np.asarray(ref_g[1]),
                               rtol=1e-3, atol=1e-4)


def test_context_ops_check_their_arguments():
    ei, _ = _graph()
    tc = kgt_torch.prepare_graph(ei, N, add_self_loops=True, device="cpu")
    e = int(tc.senders.shape[0])
    with pytest.raises(ValueError, match=r"\[H, F\]"):
        tc.sddmm_scores(torch.zeros(N, 6), torch.zeros(e, 6),
                        torch.zeros(1, 2, 3))
    with pytest.raises(ValueError, match="rows, the context"):
        tc.sddmm_scores(torch.zeros(N + 1, 6), torch.zeros(e, 6),
                        torch.zeros(2, 3))
    with pytest.raises(ValueError, match="slots"):
        tc.sddmm_scores(torch.zeros(N, 6), torch.zeros(e - 1, 6),
                        torch.zeros(2, 3))
    densified = kgt_torch.prepare_graph(
        ei, N, add_self_loops=True, densify_self_loops=True, device="cpu")
    with pytest.raises(ValueError, match="attend_full_stream"):
        densified.edge_softmax(torch.zeros(e, 2))


# ---------------------------------------------------------------------------
# GATv2Conv on a context, composed path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(CONTEXTS))
@pytest.mark.parametrize("heads,concat", [(2, True), (3, False)])
def test_composed_layer_matches_jax(heads, concat, kind):
    """``fused_attend=False``: output, ``alpha`` (``return_attention=True``)
    and every parameter gradient against the reference layer's composed
    branch."""
    ei, x = _graph(seed=9)
    jc, tc = _contexts(kind, ei)
    j_layer, params, t_layer = _layers(output_dim=6, heads=heads,
                                       concat=concat, add_self_loops=False,
                                       fused_attend=False)

    def j_loss(p):
        return jnp.sum(j_layer.apply(p, jnp.asarray(x), context=jc) ** 2)

    with pltpu.force_tpu_interpret_mode():
        ref, ref_alpha = j_layer.apply(params, jnp.asarray(x), context=jc,
                                       return_attention=True)
        ref_grads = jax.grad(j_loss)(params)
    xt = torch.from_numpy(x)
    out, alpha = t_layer(xt, context=tc, return_attention=True)
    assert alpha.shape == ref_alpha.shape == (
        int(tc.full_stream().senders.shape[0]), heads)
    np.testing.assert_allclose(_np(out), np.asarray(ref), **KERNEL_VALUE)
    np.testing.assert_allclose(_np(alpha), np.asarray(ref_alpha),
                               **KERNEL_VALUE)
    assert not _np(alpha)[~tc.full_stream().edge_mask.numpy()].any()
    (t_layer(xt, context=tc) ** 2).sum().backward()
    for name, p in t_layer.named_parameters():
        np.testing.assert_allclose(_np(p.grad), np.asarray(ref_grads[name]),
                                   **KERNEL_GRAD, err_msg=name)


@pytest.mark.parametrize("concat", [True, False])
def test_composed_path_equals_the_fused_path(concat):
    """The two context paths compute the same function: value and every
    parameter gradient, through the port's own kernels' plain versions."""
    ei, x = _graph(seed=10)
    _, tc = _contexts("stream", ei)
    outs = []
    for fused in (True, False):
        _, _, layer = _layers(seed=1, output_dim=6, heads=2, concat=concat,
                              add_self_loops=False, fused_attend=fused)
        out = layer(torch.from_numpy(x), context=tc)
        (out ** 2).sum().backward()
        outs.append((out, {k: p.grad for k, p in layer.named_parameters()}))
    np.testing.assert_allclose(_np(outs[0][0]), _np(outs[1][0]), **PLAIN)
    for name, g in outs[0][1].items():
        np.testing.assert_allclose(_np(g), _np(outs[1][1][name]), rtol=1e-5,
                                   atol=1e-4, err_msg=name)


def test_return_attention_on_a_fused_layer_takes_the_composed_path():
    """As in the reference, ``return_attention=True`` routes a fused layer
    through the composed branch (only it forms alpha); ``out`` is the same."""
    ei, x = _graph(seed=11)
    jc, tc = _contexts("stream", ei)
    j_layer, params, t_layer = _layers(output_dim=6, heads=2,
                                       add_self_loops=False)
    assert t_layer.fused_attend
    with pltpu.force_tpu_interpret_mode():
        _, ref_alpha = j_layer.apply(params, jnp.asarray(x), context=jc,
                                     return_attention=True)
    xt = torch.from_numpy(x)
    out, alpha = t_layer(xt, context=tc, return_attention=True)
    np.testing.assert_allclose(_np(alpha), np.asarray(ref_alpha),
                               **KERNEL_VALUE)
    np.testing.assert_allclose(_np(out), _np(t_layer(xt, context=tc)),
                               **PLAIN)
    sums = torch.zeros(N, 2).index_add_(0, tc.receivers.long(), alpha)
    np.testing.assert_allclose(_np(sums), 1.0, rtol=1e-6)


def test_composed_dropout_with_an_explicit_mask_matches_jax():
    """Attention dropout on alpha, after normalisation: the reference's
    composed branch restated with the same mask, and the returned alpha is
    the dropped one."""
    ei, x = _graph(seed=12)
    jc, tc = _contexts("stream", ei)
    j_layer, params, t_layer = _layers(output_dim=6, heads=2, dropout=0.3,
                                       add_self_loops=False,
                                       fused_attend=False)
    e = int(tc.senders.shape[0])
    rng = np.random.default_rng(13)
    mask = ((rng.random((e, 2)) < 0.7) / 0.7).astype(np.float32)

    def j_forward(p):
        ht = jnp.asarray(x) @ p["kernel"]
        h_j = jc.gather(ht)
        alpha = jc.edge_softmax(jc.sddmm_scores(ht, h_j,
                                                p["att"].reshape(2, 6)))
        alpha = alpha * jnp.asarray(mask)
        msgs = (alpha[:, :, None] * h_j.reshape(-1, 2, 6)).reshape(-1, 12)
        return jc.scatter(msgs) + p["bias"], alpha

    with pltpu.force_tpu_interpret_mode():
        ref, ref_alpha = j_forward(params)
        ref_grads = jax.grad(lambda p: jnp.sum(j_forward(p)[0] ** 2))(params)
    t_layer.train()
    xt = torch.from_numpy(x)
    out, alpha = t_layer(xt, context=tc, drop_mask=torch.from_numpy(mask),
                         return_attention=True)
    np.testing.assert_allclose(_np(out), np.asarray(ref), **KERNEL_VALUE)
    np.testing.assert_allclose(_np(alpha), np.asarray(ref_alpha),
                               **KERNEL_VALUE)
    (out ** 2).sum().backward()
    for name, p in t_layer.named_parameters():
        np.testing.assert_allclose(_np(p.grad), np.asarray(ref_grads[name]),
                                   **KERNEL_GRAD, err_msg=name)
    # Without a mask the draw comes from the generator; eval() switches it
    # off; the fused and composed layers draw the same mask.
    a = t_layer(xt, context=tc, generator=torch.Generator().manual_seed(1))
    b = t_layer(xt, context=tc, generator=torch.Generator().manual_seed(1))
    c = t_layer(xt, context=tc, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    fused = kgt_torch.GATv2Conv(6, input_dim=F_IN, heads=2, dropout=0.3,
                                add_self_loops=False, device="cpu")
    fused.load_state_dict(t_layer.state_dict())
    np.testing.assert_allclose(
        _np(fused(xt, context=tc, generator=torch.Generator().manual_seed(1))),
        _np(a), **PLAIN)
    t_layer.eval()
    assert torch.equal(t_layer(xt, context=tc),
                       t_layer(xt, context=tc, drop_mask=torch.zeros(e, 2)))


def test_converted_parameters_are_the_fused_layers():
    """The composed layer has the fused layer's parameters, names and shapes,
    so ``convert.params_from_jax`` loads a reference tree into either."""
    _, params, composed = _layers(output_dim=6, heads=3, add_self_loops=False,
                                  fused_attend=False)
    _, _, fused = _layers(output_dim=6, heads=3, add_self_loops=False)
    flat = convert.params_from_jax(params)
    assert set(composed.state_dict()) == set(fused.state_dict()) == set(flat)
    for name, value in flat.items():
        assert torch.equal(composed.state_dict()[name], value)
    back = convert.params_to_numpy(composed.state_dict())
    np.testing.assert_array_equal(back["att"], np.asarray(params["att"]))


# ---------------------------------------------------------------------------
# The slice as a whole: 2-layer composed training step
# ---------------------------------------------------------------------------


def _workload(seed=0, n=60, e=260, classes=6):
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)]).astype(
        np.int32)
    x = rng.standard_normal((n, 7)).astype(np.float32)
    y = rng.integers(0, classes, n).astype(np.int32)
    mask = rng.random(n) < 0.6
    jc = j_prepare(ei, n, add_self_loops=True, edge_chunk=64)
    tc = kgt_torch.prepare_graph(ei, n, add_self_loops=True, edge_chunk=64,
                                 device="cpu")
    return jc, tc, x, y, mask


def _encoders(seed=0, **conv_kwargs):
    conv_kwargs = {"heads": 2, "fused_attend": False, **conv_kwargs}
    j_enc = JGNNEncoder.for_context("gatv2", (8, 6), conv_kwargs=conv_kwargs)
    params = j_enc.init(jax.random.PRNGKey(seed), 7)
    t_enc = kgt_torch.GNNEncoder.for_context(
        "gatv2", (8, 6), input_dim=7, conv_kwargs=conv_kwargs, device="cpu")
    t_enc.load_state_dict(convert.params_from_jax(params))
    return j_enc, params, t_enc


def test_composed_training_step_matches_jax():
    jc, tc, x, y, mask = _workload()
    j_enc, params, t_enc = _encoders()
    assert all(not layer.fused_attend for layer in t_enc.layers())

    def j_loss(p):
        logits = j_enc.apply(p, jnp.asarray(x), context=jc)
        return jtrain.masked_softmax_cross_entropy(
            logits, jnp.asarray(y), jnp.asarray(mask))

    with pltpu.force_tpu_interpret_mode():
        ref_loss, ref_grads = jax.value_and_grad(j_loss)(params)
    step = make_node_classification_step(
        t_enc, torch.optim.SGD(t_enc.parameters(), lr=0.0))
    softmax_cuda.reset_launch_counts()
    sddmm_cuda.reset_launch_counts()
    loss = float(step(torch.from_numpy(x), None, torch.from_numpy(y),
                      torch.from_numpy(mask), context=tc))
    assert abs(loss - float(ref_loss)) <= 1e-4
    for name, p in t_enc.named_parameters():
        layer, leaf = name.split(".")
        np.testing.assert_allclose(p.grad.numpy(),
                                   np.asarray(ref_grads[layer][leaf]),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    # CPU tensors take the plain versions: nothing was launched.
    assert not any(softmax_cuda.LAUNCH_COUNTS.values())
    assert not any(sddmm_cuda.LAUNCH_COUNTS.values())


def test_composed_encoder_trains_like_the_fused_encoder():
    """``conv_kwargs={"fused_attend": False}`` reaches every layer, and the
    composed encoder's losses follow the fused encoder's step for step."""
    _, tc, x, y, mask = _workload(seed=1)
    args = (torch.from_numpy(x), None, torch.from_numpy(y),
            torch.from_numpy(mask))
    losses = []
    for fused in (True, False):
        _, _, enc = _encoders(seed=1, fused_attend=fused, dropout=0.2)
        assert [layer.fused_attend for layer in enc.layers()] == [fused] * 2
        step = make_node_classification_step(
            enc, torch.optim.Adam(enc.parameters(), lr=1e-2),
            generator=torch.Generator().manual_seed(3))
        losses.append([float(step(*args, context=tc)) for _ in range(6)])
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4, atol=1e-5)
    assert losses[1][-1] < losses[1][0]


def test_composed_bf16_io_step_keeps_f32_masters_and_follows_the_f32_step():
    _, tc, x, y, mask = _workload(seed=4)
    args = (torch.from_numpy(x), None, torch.from_numpy(y),
            torch.from_numpy(mask))
    runs = {}
    for dtype in (None, torch.bfloat16):
        _, _, enc = _encoders(seed=4)
        step = make_node_classification_step(
            enc, torch.optim.SGD(enc.parameters(), lr=0.0),
            compute_dtype=dtype)
        loss = float(step(*args, context=tc))
        assert all(p.dtype == p.grad.dtype == torch.float32
                   for p in enc.parameters())
        runs[dtype] = (loss, {k: p.grad for k, p in enc.named_parameters()})
    # bf16 IO rounds every activation and per-edge array to 8 mantissa bits.
    assert abs(runs[None][0] - runs[torch.bfloat16][0]) <= 5e-2
    for name, ref in runs[None][1].items():
        err = (runs[torch.bfloat16][1][name] - ref).abs().max().item()
        assert err <= 1e-1 * ref.abs().max().item(), name
