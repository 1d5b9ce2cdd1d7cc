"""Port parity for the GATv2 attention path of keras_geometric_tpu_torch:
``GraphContext.attend`` (value and both cotangents), ``GATv2Conv`` on a plain
``edge_index`` and on a context, the segment softmax / max it uses, and the
attention-dropout masks, against the JAX package on the same numpy inputs.

Where the JAX function reaches a Pallas kernel it runs in interpret mode, the
whole ``jax.grad`` inside it. Weights are carried over with
``convert.params_from_jax``.

Tolerances: against the reference's plain (pure XLA) paths 1e-5, both sides
being f32 library ops in another order; against its kernel paths the
reference's own (value 1e-4, gradients rtol 1e-3 / atol 3e-3: its f32 kernels
split operands into two bf16 passes); against the port's own autograd
restatement 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import keras_geometric_tpu_torch as kgt_torch
from keras_geometric_tpu.nn.gatv2_conv import GATv2Conv as JGATv2Conv
from keras_geometric_tpu.ops import segment as jsegment
from keras_geometric_tpu.ops.csr import prepare_graph as j_prepare
from keras_geometric_tpu_torch import convert
from keras_geometric_tpu_torch.ops import edge_dropout
from keras_geometric_tpu_torch.ops import segment as tsegment

torch.set_num_threads(1)

N, F_IN = 40, 5
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


def _layers(seed=0, **kwargs):
    """The reference layer, its parameters, and the port's layer loaded with
    the same parameters."""
    j_layer = JGATv2Conv(**kwargs)
    params = j_layer.init(jax.random.PRNGKey(seed), F_IN)
    # Non-zero bias, so that the bias path is exercised.
    params["bias"] = params["bias"] + 0.1 * jnp.arange(
        params["bias"].shape[0], dtype=jnp.float32)
    kwargs = dict(kwargs)
    t_layer = kgt_torch.GATv2Conv(kwargs.pop("output_dim"), input_dim=F_IN,
                                  device="cpu", **kwargs)
    t_layer.load_state_dict(convert.params_from_jax(params))
    return j_layer, params, t_layer


def _np(t):
    return t.detach().numpy()


def _attend_restated(ctx, ht, att, drop_mask=None, slope=0.2, eps=1e-10):
    """The fused attend written with differentiable library ops, over the
    same edge order, validity mask and dropout mask: autograd's gradients of
    this are the oracle for the hand-written backward."""
    n, (heads, f) = ht.shape[0], att.shape
    s, r = ctx.senders.long(), ctx.receivers.long()
    e = s.shape[0]
    hj = ht[s].view(e, heads, f)
    hi = ht[r].view(e, heads, f)
    scores = (torch.nn.functional.leaky_relu(hi + hj, slope) * att).sum(-1)
    alpha = tsegment.segment_softmax(scores, r, n, mask=ctx.edge_mask,
                                     eps=eps)
    if drop_mask is not None:
        alpha = alpha * drop_mask
    return tsegment.segment_sum((alpha[:, :, None] * hj).reshape(e, -1), r, n)


# ---------------------------------------------------------------------------
# GraphContext.attend
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_dropout", [False, True],
                         ids=["nodrop", "drop"])
@pytest.mark.parametrize("kind", sorted(CONTEXTS))
@pytest.mark.parametrize("heads,f", [(2, 8), (4, 3)])
def test_attend_value_and_cotangents_match_jax(heads, f, kind, with_dropout):
    ei, _ = _graph(seed=heads)
    jc, tc = _contexts(kind, ei)
    rng = np.random.default_rng(10 + heads)
    ht = rng.standard_normal((N, heads * f)).astype(np.float32)
    att = rng.standard_normal((heads, f)).astype(np.float32)
    g = rng.standard_normal((N, heads * f)).astype(np.float32)
    e_pad = int(tc.full_stream().senders.shape[0])
    assert e_pad == int(jc.full_stream().senders.shape[0])
    drop = None
    if with_dropout:
        drop = ((rng.random((e_pad, heads)) < 0.7) / 0.7).astype(np.float32)
    j_drop = None if drop is None else jnp.asarray(drop)

    def j_loss(ht_, att_):
        return jnp.sum(jc.attend(ht_, att_, drop_mask=j_drop) * g)

    with pltpu.force_tpu_interpret_mode():
        ref = jc.attend(jnp.asarray(ht), jnp.asarray(att), drop_mask=j_drop)
        ref_ght, ref_gatt = jax.grad(j_loss, argnums=(0, 1))(
            jnp.asarray(ht), jnp.asarray(att))

    t_ht = torch.from_numpy(ht).requires_grad_(True)
    t_att = torch.from_numpy(att).requires_grad_(True)
    t_drop = None if drop is None else torch.from_numpy(drop)
    out = tc.attend(t_ht, t_att, drop_mask=t_drop)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(_np(out), np.asarray(ref), **KERNEL_VALUE)
    np.testing.assert_allclose(_np(t_ht.grad), np.asarray(ref_ght),
                               **KERNEL_GRAD)
    np.testing.assert_allclose(_np(t_att.grad), np.asarray(ref_gatt),
                               **KERNEL_GRAD)

    # The hand-written backward against autograd over the restatement.
    r_ht = torch.from_numpy(ht).requires_grad_(True)
    r_att = torch.from_numpy(att).requires_grad_(True)
    restated = _attend_restated(tc.full_stream(), r_ht, r_att, t_drop)
    restated.backward(torch.from_numpy(g))
    np.testing.assert_allclose(_np(out), _np(restated), **PLAIN)
    np.testing.assert_allclose(_np(t_ht.grad), _np(r_ht.grad), **PLAIN)
    np.testing.assert_allclose(_np(t_att.grad), _np(r_att.grad), **PLAIN)


def test_attend_checks_its_arguments():
    ei, _ = _graph()
    tc = kgt_torch.prepare_graph(ei, N, add_self_loops=True, device="cpu")
    with pytest.raises(ValueError, match=r"\[H, F\]"):
        tc.attend(torch.zeros(N, 6), torch.zeros(1, 2, 3))
    with pytest.raises(ValueError, match="rows"):
        tc.attend(torch.zeros(N + 1, 6), torch.zeros(2, 3))
    densified = kgt_torch.prepare_graph(
        ei, N, add_self_loops=True, densify_self_loops=True, device="cpu")
    with pytest.raises(ValueError, match="attend_full_stream"):
        densified.attend(torch.zeros(N, 6), torch.zeros(2, 3))


# ---------------------------------------------------------------------------
# GATv2Conv, plain edge_index path (pure XLA on the reference's side)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("heads,concat", [(1, True), (3, True), (3, False)])
def test_plain_path_matches_jax(heads, concat):
    ei, x = _graph(seed=1)
    j_layer, params, t_layer = _layers(output_dim=6, heads=heads,
                                       concat=concat)
    ref, ref_alpha = j_layer.apply(params, jnp.asarray(x), jnp.asarray(ei),
                                   return_attention=True)
    t_layer.eval()
    out, alpha = t_layer(torch.from_numpy(x), torch.from_numpy(ei),
                         return_attention=True)
    assert out.shape == (N, t_layer.out_features)
    assert t_layer.out_features == j_layer.out_features
    np.testing.assert_allclose(_np(out), np.asarray(ref), **PLAIN)
    np.testing.assert_allclose(_np(alpha), np.asarray(ref_alpha), **PLAIN)
    assert torch.equal(out, t_layer(torch.from_numpy(x),
                                    torch.from_numpy(ei)))


def test_plain_path_bipartite_tuple_matches_jax():
    ei, x = _graph(seed=2)
    rng = np.random.default_rng(3)
    n_src = 25
    x_src = rng.standard_normal((n_src, F_IN)).astype(np.float32)
    ei = np.stack([ei[0] % n_src, ei[1]]).astype(np.int32)
    j_layer, params, t_layer = _layers(output_dim=4, heads=2,
                                       add_self_loops=False)
    ref = j_layer.apply(params, (jnp.asarray(x), jnp.asarray(x_src)),
                        jnp.asarray(ei))
    out = t_layer((torch.from_numpy(x), torch.from_numpy(x_src)),
                  torch.from_numpy(ei))
    np.testing.assert_allclose(_np(out), np.asarray(ref), **PLAIN)


def test_plain_path_edge_and_node_masks_match_jax():
    ei, x = _graph(seed=4)
    rng = np.random.default_rng(5)
    edge_mask = rng.random(ei.shape[1]) < 0.7
    node_mask = np.arange(N) < N - 6
    j_layer, params, t_layer = _layers(output_dim=6, heads=2)
    ref = j_layer.apply(params, jnp.asarray(x), jnp.asarray(ei),
                        edge_mask=jnp.asarray(edge_mask),
                        node_mask=jnp.asarray(node_mask))
    out = t_layer(torch.from_numpy(x), torch.from_numpy(ei),
                  edge_mask=torch.from_numpy(edge_mask),
                  node_mask=torch.from_numpy(node_mask))
    np.testing.assert_allclose(_np(out), np.asarray(ref), **PLAIN)
    # A node whose loop is masked and that receives no kept edge: bias only.
    lonely = [i for i in range(N - 6, N)
              if not (edge_mask & (ei[1] == i)).any()]
    assert lonely
    np.testing.assert_allclose(_np(out)[lonely],
                               np.tile(_np(t_layer.bias), (len(lonely), 1)),
                               atol=1e-6)


@pytest.mark.parametrize("concat", [True, False])
def test_zero_edges_and_zero_nodes_return_zeros(concat):
    _, x = _graph()
    j_layer, params, t_layer = _layers(output_dim=6, heads=2, concat=concat)
    empty = np.zeros((2, 0), np.int32)
    ref = j_layer.apply(params, jnp.asarray(x), jnp.asarray(empty))
    out, alpha = t_layer(torch.from_numpy(x), torch.from_numpy(empty),
                         return_attention=True)
    assert alpha is None and out.shape == ref.shape == (
        N, t_layer.out_features)
    assert not out.any() and not np.asarray(ref).any()
    out = t_layer(torch.zeros(0, F_IN), torch.from_numpy(empty))
    assert out.shape == (0, t_layer.out_features)
    with pytest.raises(ValueError, match="edge_index required"):
        t_layer(torch.from_numpy(x))


def test_plain_path_parameter_gradients_match_jax():
    ei, x = _graph(seed=6)
    j_layer, params, t_layer = _layers(output_dim=6, heads=2)
    ref = jax.grad(lambda p: jnp.sum(
        j_layer.apply(p, jnp.asarray(x), jnp.asarray(ei)) ** 2))(params)
    (t_layer(torch.from_numpy(x), torch.from_numpy(ei)) ** 2).sum().backward()
    for name, p in t_layer.named_parameters():
        np.testing.assert_allclose(_np(p.grad), np.asarray(ref[name]),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_plain_path_dropout_takes_the_mask_or_the_generator():
    ei, x = _graph(seed=7)
    j_layer, params, t_layer = _layers(output_dim=6, heads=2, dropout=0.4)
    xt, eit = torch.from_numpy(x), torch.from_numpy(ei)
    t_layer.eval()
    quiet = t_layer(xt, eit)
    t_layer.train()
    e_all = ei.shape[1] + N  # self-loops appended
    ones = torch.ones(e_all, 2)
    assert torch.allclose(t_layer(xt, eit, drop_mask=ones), quiet)
    a = t_layer(xt, eit, generator=torch.Generator().manual_seed(1))
    b = t_layer(xt, eit, generator=torch.Generator().manual_seed(1))
    c = t_layer(xt, eit, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    # An explicit mask on both sides: the reference applies it to alpha.
    rng = np.random.default_rng(8)
    mask = ((rng.random((e_all, 2)) < 0.6) / 0.6).astype(np.float32)
    _, alpha = j_layer.apply(params, jnp.asarray(x), jnp.asarray(ei),
                             return_attention=True)
    h = (jnp.asarray(x) @ params["kernel"]).reshape(N, 2, 6)
    full = np.concatenate([ei, np.stack([np.arange(N)] * 2)], axis=1)
    msgs = (alpha * mask)[:, :, None] * h[full[0]]
    ref = jsegment.segment_sum(msgs.reshape(e_all, 12), jnp.asarray(full[1]),
                               N) + params["bias"]
    out = t_layer(xt, eit, drop_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(_np(out), np.asarray(ref), **PLAIN)


# ---------------------------------------------------------------------------
# GATv2Conv on a context (the fused attend)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(CONTEXTS))
@pytest.mark.parametrize("heads,concat", [(2, True), (3, False)])
def test_context_path_matches_jax_and_the_plain_path(heads, concat, kind):
    ei, x = _graph(seed=9)
    jc, tc = _contexts(kind, ei)
    j_layer, params, t_layer = _layers(output_dim=6, heads=heads,
                                       concat=concat, add_self_loops=False)

    def j_loss(p):
        return jnp.sum(j_layer.apply(p, jnp.asarray(x), context=jc) ** 2)

    with pltpu.force_tpu_interpret_mode():
        ref = j_layer.apply(params, jnp.asarray(x), context=jc)
        ref_grads = jax.grad(j_loss)(params)

    xt = torch.from_numpy(x)
    out = t_layer(xt, context=tc)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(_np(out), np.asarray(ref), **KERNEL_VALUE)
    for name, p in t_layer.named_parameters():
        np.testing.assert_allclose(_np(p.grad), np.asarray(ref_grads[name]),
                                   rtol=2e-3, atol=3e-3, err_msg=name)

    # The same layer on the plain edge_index, self-loops appended there.
    _, _, plain = _layers(output_dim=6, heads=heads, concat=concat)
    plain_out = plain(xt, torch.from_numpy(ei))
    (plain_out ** 2).sum().backward()
    np.testing.assert_allclose(_np(out), _np(plain_out), **PLAIN)
    for (name, p), (_, q) in zip(t_layer.named_parameters(),
                                 plain.named_parameters()):
        np.testing.assert_allclose(_np(p.grad), _np(q.grad), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_context_path_dropout_with_an_explicit_mask_matches_jax():
    ei, x = _graph(seed=11)
    jc, tc = _contexts("stream", ei)
    j_layer, params, t_layer = _layers(output_dim=6, heads=2, dropout=0.3,
                                       add_self_loops=False)
    e_pad = int(tc.senders.shape[0])
    rng = np.random.default_rng(12)
    mask = ((rng.random((e_pad, 2)) < 0.7) / 0.7).astype(np.float32)

    def j_forward(p):
        ht = jnp.asarray(x) @ p["kernel"]
        agg = jc.attend(ht, p["att"].reshape(2, 6), drop_mask=jnp.asarray(mask))
        return agg + p["bias"]

    with pltpu.force_tpu_interpret_mode():
        ref = j_forward(params)
        ref_grads = jax.grad(lambda p: jnp.sum(j_forward(p) ** 2))(params)
    t_layer.train()
    xt = torch.from_numpy(x)
    out = t_layer(xt, context=tc, drop_mask=torch.from_numpy(mask))
    (out ** 2).sum().backward()
    np.testing.assert_allclose(_np(out), np.asarray(ref), **KERNEL_VALUE)
    for name, p in t_layer.named_parameters():
        np.testing.assert_allclose(_np(p.grad), np.asarray(ref_grads[name]),
                                   rtol=2e-3, atol=3e-3, err_msg=name)
    # Without a mask the draw comes from the generator; eval() switches it off.
    a = t_layer(xt, context=tc, generator=torch.Generator().manual_seed(1))
    b = t_layer(xt, context=tc, generator=torch.Generator().manual_seed(1))
    c = t_layer(xt, context=tc, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    t_layer.eval()
    assert torch.equal(t_layer(xt, context=tc),
                       t_layer(xt, context=tc, drop_mask=torch.zeros(e_pad, 2)))


def test_context_path_rejections():
    ei, x = _graph()
    _, tc = _contexts("stream", ei)
    xt = torch.from_numpy(x)
    with_loops = kgt_torch.GATv2Conv(6, input_dim=F_IN, heads=2, device="cpu")
    with pytest.raises(ValueError, match="add_self_loops=False"):
        with_loops(xt, context=tc)
    layer = kgt_torch.GATv2Conv.for_context(6, input_dim=F_IN, heads=2,
                                            device="cpu")
    assert layer.add_self_loops is False
    with pytest.raises(ValueError, match="bipartite"):
        layer((xt, xt), context=tc)
    # The composed path runs on a context (return_attention=True takes it
    # from a fused layer too) and computes what the fused path does.
    out, alpha = layer(xt, context=tc, return_attention=True)
    assert alpha.shape == (int(tc.senders.shape[0]), 2)
    composed = kgt_torch.GATv2Conv.for_context(
        6, input_dim=F_IN, heads=2, fused_attend=False, device="cpu")
    composed.load_state_dict(layer.state_dict())
    np.testing.assert_allclose(_np(composed(xt, context=tc)),
                               _np(layer(xt, context=tc)), **PLAIN)
    np.testing.assert_allclose(_np(out), _np(layer(xt, context=tc)), **PLAIN)
    with pytest.raises(ValueError, match="bipartite"):
        composed((xt, xt), context=tc)
    kept = kgt_torch.GATv2Conv.for_context(6, input_dim=F_IN,
                                           add_self_loops=True, device="cpu")
    assert kept.add_self_loops is True  # explicitly passed flags win


def _densified(ei, edge_chunk):
    return kgt_torch.prepare_graph(
        ei, N, device="cpu", **{**CONTEXTS["densified"],
                                "edge_chunk": edge_chunk})


@pytest.mark.parametrize("edge_chunk", [8, 16, 32])
def test_full_stream_messages_do_not_scatter_over_the_residual_stream(
        edge_chunk):
    """A densified context gathers (and attends) over its full-stream
    companion but scatters over its own residual stream: feeding the one to
    the other raises whenever the two streams differ in length."""
    ei, x = _graph(seed=13)
    tc = _densified(ei, edge_chunk)
    full = tc.full_stream()
    assert full is tc.full and full.num_diag == 0
    assert full.receivers.shape[0] != tc.receivers.shape[0]
    per_edge = tc.gather(torch.from_numpy(x))
    assert per_edge.shape[0] == full.receivers.shape[0]
    for scatter in (tc.scatter, tc.scatter_weighted, tc.scatter_mean):
        with pytest.raises(ValueError, match="full-stream companion"):
            scatter(per_edge)
    assert full.scatter(per_edge, masked=True).shape == (N, F_IN)


def test_stream_check_compares_lengths_only_as_the_reference_does():
    """Where both streams pad to the same length the check cannot tell them
    apart and the scatter goes through, in the reference and in the port."""
    ei, x = _graph(seed=13)
    tc = _densified(ei, 64)
    assert tc.full.receivers.shape[0] == tc.receivers.shape[0]
    assert tc.scatter(tc.gather(torch.from_numpy(x))).shape == (N, F_IN)
    jc = j_prepare(ei, N, **CONTEXTS["densified"])
    with pltpu.force_tpu_interpret_mode():
        assert jc.scatter(jc.gather(jnp.asarray(x))).shape == (N, F_IN)


# ---------------------------------------------------------------------------
# Segment softmax / max and the dropout masks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("eps", [1e-10, 1e-3])
def test_segment_softmax_and_max_match_jax(eps, masked):
    rng = np.random.default_rng(14)
    n, e = 12, 60
    ids = rng.integers(0, n - 2, e).astype(np.int32)  # two empty segments
    scores = (rng.standard_normal((e, 3)) * 4).astype(np.float32)
    mask = None
    if masked:
        mask = rng.random(e) < 0.6
        mask[ids == 3] = False  # a segment whose entries are all masked
    j_mask = None if mask is None else jnp.asarray(mask)
    t_mask = None if mask is None else torch.from_numpy(mask)
    ref = jsegment.segment_softmax(jnp.asarray(scores), jnp.asarray(ids), n,
                                   mask=j_mask, eps=eps)
    got = tsegment.segment_softmax(torch.from_numpy(scores),
                                   torch.from_numpy(ids), n, mask=t_mask,
                                   eps=eps)
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)
    if masked:
        assert not _np(got)[~mask].any()
    ref = jsegment.segment_max(jnp.asarray(scores), jnp.asarray(ids), n,
                               mask=j_mask)
    got = tsegment.segment_max(torch.from_numpy(scores),
                               torch.from_numpy(ids), n, mask=t_mask)
    np.testing.assert_array_equal(_np(got), np.asarray(ref))
    assert not _np(got)[n - 2:].any()  # empty segment -> 0
    if masked:
        assert not _np(got)[3].any()  # fully masked segment -> 0


def test_attention_keep_masks():
    ei, _ = _graph(seed=15, e=2000)
    tc = kgt_torch.prepare_graph(ei, N, add_self_loops=True, device="cpu")
    e = int(tc.senders.shape[0])
    rate = 0.3
    mask, mask_ss = edge_dropout.attention_keep_masks(
        torch.Generator().manual_seed(0), e, tc.bwd_perm, 4, rate)
    assert mask.shape == mask_ss.shape == (e, 4)
    assert torch.equal(mask_ss, mask[tc.bwd_perm.long()])
    values = set(np.unique(_np(mask)).tolist())
    assert values == {0.0, np.float32(1 / 0.7).item()}
    assert abs((_np(mask) > 0).mean() - 0.7) < 0.05
    again, _ = edge_dropout.attention_keep_masks(
        torch.Generator().manual_seed(0), e, tc.bwd_perm, 4, rate)
    other, _ = edge_dropout.attention_keep_masks(
        torch.Generator().manual_seed(1), e, tc.bwd_perm, 4, rate)
    assert torch.equal(mask, again) and not torch.equal(mask, other)
    at = edge_dropout.keep_mask_at(
        torch.Generator().manual_seed(0), tc.bwd_perm, 4, rate)
    assert torch.equal(at, mask_ss)
    bf = edge_dropout.keep_mask_at(
        torch.Generator().manual_seed(0), None, 4, rate, torch.bfloat16,
        num_edges=e)
    assert bf.dtype == torch.bfloat16 and torch.equal(bf > 0, mask > 0)
    with pytest.raises(ValueError, match="num_edges"):
        edge_dropout.keep_mask_at(None, None, 4, rate)
