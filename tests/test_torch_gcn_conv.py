"""Port parity: ``GCNConv`` and ``GNNEncoder`` of keras_geometric_tpu_torch
against the JAX package's, with one set of weights carried over by
``convert.params_from_jax``. Values and parameter/input gradients; f32,
tolerance 1e-4 (order of summation, and the reference's two-pass bf16 split of
f32 data inside its kernels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import keras_geometric_tpu as kgt
import keras_geometric_tpu_torch as kgt_torch
from keras_geometric_tpu.models import GNNEncoder as JGNNEncoder
from keras_geometric_tpu.ops.csr import prepare_graph as j_prepare
from keras_geometric_tpu_torch import convert
from keras_geometric_tpu_torch.nn import module as tmodule

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)


def _graph(seed=0, n=50, half=120, symmetric=True):
    rng = np.random.default_rng(seed)
    a, b = rng.integers(0, n, half), rng.integers(0, n, half)
    if symmetric:
        ei = np.stack([np.concatenate([a, b]), np.concatenate([b, a])])
    else:
        ei = np.stack([a, b])
    return n, ei.astype(np.int32)


def _contexts(n, ei, **kwargs):
    return (j_prepare(ei, n, **kwargs),
            kgt_torch.prepare_graph(ei, n, device="cpu", **kwargs))


def _layers(f_in, f_out, seed=0, for_context=True, **kwargs):
    """A JAX layer + params and the port's layer loaded with the same."""
    make_j = kgt.GCNConv.for_context if for_context else kgt.GCNConv
    make_t = (kgt_torch.GCNConv.for_context if for_context
              else kgt_torch.GCNConv)
    j_layer = make_j(output_dim=f_out, **kwargs)
    params = j_layer.init(jax.random.PRNGKey(seed), f_in)
    rng = np.random.default_rng(seed)
    if "bias" in params:  # zeros by default: make the bias matter
        params["bias"] = jnp.asarray(
            rng.standard_normal(f_out).astype(np.float32))
    t_layer = make_t(f_out, input_dim=f_in, device="cpu", **kwargs)
    t_layer.load_state_dict(convert.params_from_jax(params))
    return j_layer, params, t_layer


def _jax_out_and_grads(j_layer, params, x, *args, **kwargs):
    def loss(p, xx):
        return jnp.sum(jnp.tanh(j_layer.apply(p, xx, *args, **kwargs)))

    with pltpu.force_tpu_interpret_mode():
        out = j_layer.apply(params, x, *args, **kwargs)
        gp, gx = jax.grad(loss, argnums=(0, 1))(params, x)
    return np.asarray(out), jax.tree_util.tree_map(np.asarray, gp), np.asarray(gx)


def _torch_out_and_grads(t_layer, x, *args, **kwargs):
    x = x.clone().requires_grad_(True)
    t_layer.zero_grad()
    out = t_layer(x, *args, **kwargs)
    torch.tanh(out).sum().backward()
    grads = {k: p.grad.numpy() for k, p in t_layer.named_parameters()}
    return out.detach().numpy(), grads, x.grad.numpy()


def _assert_same(j_res, t_res):
    (jo, jgp, jgx), (to, tgp, tgx) = j_res, t_res
    np.testing.assert_allclose(to, jo, **TOL)
    assert set(tgp) == set(jgp)
    for name in jgp:
        np.testing.assert_allclose(tgp[name], jgp[name], err_msg=name, **TOL)
    np.testing.assert_allclose(tgx, jgx, **TOL)


CONTEXT_KW = {
    "symmetric": dict(add_self_loops=True, gcn_normalize=True, symmetric=True),
    "bench": dict(add_self_loops=True, gcn_normalize=True, symmetric=True,
                  densify_self_loops=True, pad_nodes=True),
    "general": dict(add_self_loops=True, gcn_normalize=True),
}


@pytest.mark.parametrize("dims", [(6, 12), (12, 6), (8, 8)],
                         ids=["widening", "narrowing", "square"])
@pytest.mark.parametrize("ctx_kind", sorted(CONTEXT_KW))
def test_context_path_matches_jax(ctx_kind, dims):
    f_in, f_out = dims
    n, ei = _graph(1, symmetric=ctx_kind != "general")
    jc, tc = _contexts(n, ei, **CONTEXT_KW[ctx_kind])
    x = np.random.default_rng(2).standard_normal(
        (tc.num_nodes, f_in)).astype(np.float32)
    j_layer, params, t_layer = _layers(f_in, f_out)
    _assert_same(
        _jax_out_and_grads(j_layer, params, jnp.asarray(x), context=jc),
        _torch_out_and_grads(t_layer, torch.from_numpy(x), context=tc),
    )


def test_context_path_no_bias():
    n, ei = _graph(3)
    jc, tc = _contexts(n, ei, **CONTEXT_KW["symmetric"])
    x = np.random.default_rng(4).standard_normal((n, 5)).astype(np.float32)
    j_layer, params, t_layer = _layers(5, 9, use_bias=False)
    assert "bias" not in dict(t_layer.named_parameters())
    _assert_same(
        _jax_out_and_grads(j_layer, params, jnp.asarray(x), context=jc),
        _torch_out_and_grads(t_layer, torch.from_numpy(x), context=tc),
    )


@pytest.mark.parametrize("densified", [False, True], ids=["stream", "densified"])
def test_context_dropout_branch_with_shared_keep_mask(densified):
    """gather -> dropout -> scatter_weighted (the scatter's VJP is the expand
    kernel). The test draws the reference's Bernoulli masks from its key and
    hands the same masks to the port."""
    n, ei = _graph(5)
    kw = dict(add_self_loops=True, gcn_normalize=True)
    if densified:
        # edge_chunk=64 keeps the two streams' padded lengths apart.
        kw.update(densify_self_loops=True, attend_full_stream=True,
                  edge_chunk=64)
    jc, tc = _contexts(n, ei, **kw)
    f_in, f_out, rate = 10, 4, 0.5
    x = np.random.default_rng(6).standard_normal((n, f_in)).astype(np.float32)
    j_layer, params, t_layer = _layers(f_in, f_out, dropout_rate=rate)
    key = jax.random.PRNGKey(11)
    e = (jc.full if densified else jc).receivers.shape[0]
    if densified:
        drop_key, self_key = jax.random.split(key)
        self_keep = torch.from_numpy(np.array(
            jax.random.bernoulli(self_key, 1.0 - rate, (n, f_out))))
    else:
        drop_key, self_keep = key, None
    keep = torch.from_numpy(np.array(
        jax.random.bernoulli(drop_key, 1.0 - rate, (e, f_out))))
    t_layer.train()
    if densified:
        # The reference routes gather() to the companion but scatters over the
        # residual stream: both sides must refuse the mismatch alike.
        with pytest.raises(ValueError, match="full_stream"):
            j_layer.apply(params, jnp.asarray(x), context=jc, training=True,
                          rng=key)
        with pytest.raises(ValueError, match="full_stream"):
            t_layer(torch.from_numpy(x), context=tc, keep_mask=keep,
                    self_keep_mask=self_keep)
        return
    _assert_same(
        _jax_out_and_grads(j_layer, params, jnp.asarray(x), context=jc,
                           training=True, rng=key),
        _torch_out_and_grads(t_layer, torch.from_numpy(x), context=tc,
                             keep_mask=keep),
    )
    # eval mode: no dropout, the fused spmm branch
    t_layer.eval()
    _assert_same(
        _jax_out_and_grads(j_layer, params, jnp.asarray(x), context=jc),
        _torch_out_and_grads(t_layer, torch.from_numpy(x), context=tc),
    )


def test_context_dropout_densified_self_term():
    """Densified diagonal under dropout: the dense self-loop term gets its own
    draw. Scattering over the full stream is not what the layer does, so this
    holds the port to the formula with numpy."""
    n, ei = _graph(7)
    _, tc = _contexts(n, ei, add_self_loops=True, densify_self_loops=True)
    layer = kgt_torch.GCNConv.for_context(3, input_dim=3, dropout_rate=0.5,
                                          device="cpu")
    # Stand-in companion holding the same (residual) stream, so the layer's
    # gather and scatter agree in length.
    tc = tc._replace(full=tc._replace(num_diag=0, self_weight=None))
    e = tc.receivers.shape[0]
    rng = np.random.default_rng(8)
    keep = rng.random((e, 3)) < 0.5
    self_keep = rng.random((n, 3)) < 0.5
    x = rng.standard_normal((n, 3)).astype(np.float32)
    layer.train()
    with torch.no_grad():
        layer.bias.zero_()
    h = x @ layer.kernel.detach().numpy()
    msgs = np.where(keep, h[tc.senders.numpy()] / 0.5, 0.0)
    expect = np.zeros((n, 3), np.float32)
    np.add.at(expect, tc.receivers.numpy(),
              msgs * tc.edge_weight.numpy()[:, None])
    expect += np.where(self_keep, h * tc.self_weight.numpy()[:, None] / 0.5, 0.0)
    out = layer(torch.from_numpy(x), context=tc,
                keep_mask=torch.from_numpy(keep),
                self_keep_mask=torch.from_numpy(self_keep))
    np.testing.assert_allclose(out.detach().numpy(), expect, **TOL)


def test_context_user_edge_weight_branch():
    n, ei = _graph(9)
    jc, tc = _contexts(n, ei, add_self_loops=True, gcn_normalize=True)
    e = tc.receivers.shape[0]
    x = np.random.default_rng(10).standard_normal((n, 6)).astype(np.float32)
    ew = np.random.default_rng(11).uniform(0.5, 1.5, e).astype(np.float32)
    j_layer, params, t_layer = _layers(6, 4)
    _assert_same(
        _jax_out_and_grads(j_layer, params, jnp.asarray(x), None,
                           jnp.asarray(ew), context=jc),
        _torch_out_and_grads(t_layer, torch.from_numpy(x), None,
                             torch.from_numpy(ew), context=tc),
    )


def test_context_flag_trap():
    n, ei = _graph(12)
    _, tc = _contexts(n, ei, add_self_loops=True, gcn_normalize=True)
    layer = kgt_torch.GCNConv(4, input_dim=3, device="cpu")
    with pytest.raises(ValueError, match="add_self_loops=False"):
        layer(torch.zeros(n, 3), context=tc)
    with pytest.raises(ValueError, match="edge_index required"):
        layer(torch.zeros(n, 3))


@pytest.mark.parametrize(
    "flags",
    [dict(), dict(add_self_loops=False), dict(normalize=False),
     dict(add_self_loops=False, normalize=False)],
    ids=["default", "no_loops", "no_norm", "raw"],
)
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_no_context_path_matches_jax(flags, weighted):
    n, ei = _graph(13, symmetric=False)
    x = np.random.default_rng(14).standard_normal((n, 7)).astype(np.float32)
    ew = (np.random.default_rng(15).uniform(0.5, 1.5, ei.shape[1])
          .astype(np.float32) if weighted else None)
    j_layer, params, t_layer = _layers(7, 5, for_context=False, **flags)
    _assert_same(
        _jax_out_and_grads(j_layer, params, jnp.asarray(x), jnp.asarray(ei),
                           None if ew is None else jnp.asarray(ew)),
        _torch_out_and_grads(t_layer, torch.from_numpy(x),
                             torch.from_numpy(ei),
                             None if ew is None else torch.from_numpy(ew)),
    )


def test_no_context_masks_and_dropout():
    n, ei = _graph(16, symmetric=False)
    rng = np.random.default_rng(17)
    x = rng.standard_normal((n, 6)).astype(np.float32)
    edge_mask = rng.random(ei.shape[1]) < 0.8
    node_mask = np.arange(n) < n - 5
    j_layer, params, t_layer = _layers(6, 4, for_context=False,
                                       dropout_rate=0.3)
    key = jax.random.PRNGKey(3)
    keep = torch.from_numpy(np.array(jax.random.bernoulli(
        key, 0.7, (ei.shape[1] + n, 4))))
    t_layer.train()
    _assert_same(
        _jax_out_and_grads(j_layer, params, jnp.asarray(x), jnp.asarray(ei),
                           edge_mask=jnp.asarray(edge_mask),
                           node_mask=jnp.asarray(node_mask), training=True,
                           rng=key),
        _torch_out_and_grads(t_layer, torch.from_numpy(x),
                             torch.from_numpy(ei),
                             edge_mask=torch.from_numpy(edge_mask),
                             node_mask=torch.from_numpy(node_mask),
                             keep_mask=keep),
    )


def test_no_context_sorted_with_row_ptr_on_cpu_takes_segment_sum():
    n, ei = _graph(18, symmetric=False)
    order = np.argsort(ei[1], kind="stable")
    ei = ei[:, order]
    x = torch.randn(n, 4)
    layer = kgt_torch.GCNConv(3, input_dim=4, add_self_loops=False,
                              device="cpu")
    from keras_geometric_tpu_torch.kernels import spmm_cuda

    row_ptr = spmm_cuda.row_ptr_from_sorted(torch.from_numpy(ei[1]), n)
    a = layer(x, torch.from_numpy(ei), indices_are_sorted=True, row_ptr=row_ptr)
    b = layer(x, torch.from_numpy(ei))
    np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), **TOL)


@pytest.mark.parametrize("transposed", [False, True], ids=["2xE", "Ex2"])
def test_edge_index_layouts(transposed):
    n, ei = _graph(19, symmetric=False)
    x = np.random.default_rng(20).standard_normal((n, 4)).astype(np.float32)
    j_layer, params, t_layer = _layers(4, 3, for_context=False)
    arg = ei.T if transposed else ei
    jo = j_layer.apply(params, jnp.asarray(x), jnp.asarray(arg))
    to = t_layer(torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(arg)))
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), **TOL)


def test_no_edge_and_empty_graphs():
    j_layer, params, t_layer = _layers(4, 3, for_context=False)
    x = np.random.default_rng(21).standard_normal((6, 4)).astype(np.float32)
    for empty_ei in (np.zeros((2, 0), np.int32), np.zeros((0, 0), np.int32)):
        jo = j_layer.apply(params, jnp.asarray(x), jnp.asarray(empty_ei))
        to = t_layer(torch.from_numpy(x), torch.from_numpy(empty_ei))
        np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), **TOL)
    jo = j_layer.apply(params, jnp.zeros((0, 4)), jnp.zeros((2, 0), jnp.int32))
    to = t_layer(torch.zeros(0, 4), torch.zeros(2, 0, dtype=torch.int32))
    assert tuple(to.shape) == tuple(jo.shape) == (0, 3)


@pytest.mark.parametrize("ctx_kind", sorted(CONTEXT_KW))
def test_gnn_encoder_for_context_forward_and_grads(ctx_kind):
    n, ei = _graph(22, symmetric=ctx_kind != "general")
    jc, tc = _contexts(n, ei, **CONTEXT_KW[ctx_kind])
    x = np.random.default_rng(23).standard_normal(
        (tc.num_nodes, 6)).astype(np.float32)
    j_enc = JGNNEncoder.for_context("gcn", (16, 4))
    params = j_enc.init(jax.random.PRNGKey(1), 6)
    t_enc = kgt_torch.GNNEncoder.for_context("gcn", (16, 4), input_dim=6,
                                             device="cpu")
    t_enc.load_state_dict(convert.params_from_jax(params))
    t_enc.eval()

    def loss(p):
        return jnp.sum(jnp.tanh(j_enc.apply(p, jnp.asarray(x), context=jc)))

    with pltpu.force_tpu_interpret_mode():
        jo = j_enc.apply(params, jnp.asarray(x), context=jc)
        jg = jax.grad(loss)(params)
    to = t_enc(torch.from_numpy(x), context=tc)
    torch.tanh(to).sum().backward()
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), **TOL)
    tg = convert.params_to_numpy(
        {k: p.grad for k, p in t_enc.named_parameters()})
    for layer in ("layer_0", "layer_1"):
        for name in ("kernel", "bias"):
            np.testing.assert_allclose(
                tg[layer][name], np.asarray(jg[layer][name]),
                err_msg=f"{layer}.{name}", **TOL)


def test_gnn_encoder_no_context_and_final_activation():
    n, ei = _graph(24, symmetric=False)
    x = np.random.default_rng(25).standard_normal((n, 5)).astype(np.float32)
    j_enc = JGNNEncoder("gcn", (8, 3), activation="tanh",
                        final_activation="softmax")
    params = j_enc.init(jax.random.PRNGKey(2), 5)
    t_enc = kgt_torch.GCN((8, 3), input_dim=5, activation="tanh",
                          final_activation="softmax", device="cpu")
    t_enc.load_state_dict(convert.params_from_jax(params))
    t_enc.eval()
    jo = j_enc.apply(params, jnp.asarray(x), jnp.asarray(ei))
    to = t_enc(torch.from_numpy(x), torch.from_numpy(ei))
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), **TOL)
    assert t_enc.output_dim == j_enc.output_dim == 3


@pytest.mark.parametrize("family,item", [("gin", "M5"), ("sage", "M5"),
                                         ("gatv2", "M6")])
def test_unported_families_raise(family, item):
    """Every family is ported now. 'gin' and 'sage' (ROADMAP M5) build and
    give the reference encoder's output with its parameters; 'gatv2' (M6)
    runs both attention paths on a context: the composed one
    (``fused_attend=False``) gives the fused encoder's output."""
    if family == "gatv2":
        ctx = kgt_torch.prepare_graph(np.array([[0, 1], [1, 0]]), 2,
                                      add_self_loops=True, device="cpu")
        x = torch.arange(6, dtype=torch.float32).reshape(2, 3) / 6
        outs = []
        for fused in (True, False):
            enc = kgt_torch.GNNEncoder.for_context(
                family, (4,), input_dim=3,
                conv_kwargs={"fused_attend": fused},
                generator=torch.Generator().manual_seed(0), device="cpu")
            assert enc.layer_0.fused_attend is fused
            outs.append(enc(x, context=ctx))
        np.testing.assert_allclose(outs[1].detach().numpy(),
                                   outs[0].detach().numpy(), rtol=1e-6,
                                   atol=1e-6)
        return
    del item
    j_enc = JGNNEncoder(family, (4, 2))
    params = j_enc.init(jax.random.PRNGKey(3), 3)
    t_enc = kgt_torch.GNNEncoder(family, (4, 2), input_dim=3, device="cpu")
    t_enc.load_state_dict(convert.params_from_jax(params))
    ei = np.array([[0, 1, 2, 2], [1, 0, 0, 1]], np.int32)
    x = np.arange(9, dtype=np.float32).reshape(3, 3) / 9 - 0.3
    want = j_enc.apply(params, jnp.asarray(x), jnp.asarray(ei))
    got = t_enc(torch.from_numpy(x), torch.from_numpy(ei))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_unknown_family_and_empty_dims():
    with pytest.raises(ValueError, match="Unknown conv family"):
        kgt_torch.GNNEncoder("nope", (4,), input_dim=3, device="cpu")
    with pytest.raises(ValueError, match="non-empty"):
        kgt_torch.GNNEncoder("gcn", (), input_dim=3, device="cpu")


def test_convert_round_trip():
    j_enc = JGNNEncoder.for_context("gcn", (8, 3))
    params = j_enc.init(jax.random.PRNGKey(5), 6)
    state = convert.params_from_jax(params)
    assert set(state) == {"layer_0.kernel", "layer_0.bias", "layer_1.kernel",
                          "layer_1.bias"}
    assert tuple(state["layer_0.kernel"].shape) == (6, 8)  # [in, out] kept
    t_enc = kgt_torch.GNNEncoder.for_context("gcn", (8, 3), input_dim=6,
                                             device="cpu")
    t_enc.load_state_dict(state)
    back = convert.params_to_numpy(t_enc.state_dict())
    for layer, leaves in params.items():
        for name, value in leaves.items():
            np.testing.assert_array_equal(back[layer][name], np.asarray(value))


@pytest.mark.parametrize("name", ["glorot_uniform", "glorot_normal",
                                  "he_uniform", "he_normal", "lecun_uniform",
                                  "lecun_normal"])
def test_initializer_moments_match_jax(name):
    """Different generators, same distribution: compare first two moments."""
    shape = (200, 300)
    g = torch.Generator().manual_seed(0)
    t = tmodule.get_initializer(name)(shape, generator=g).numpy()
    from keras_geometric_tpu.nn.module import get_initializer as j_init

    j = np.asarray(j_init(name)(jax.random.PRNGKey(0), shape))
    assert abs(t.mean()) < 3e-3 and abs(j.mean()) < 3e-3
    np.testing.assert_allclose(t.std(), j.std(), rtol=3e-2)
    np.testing.assert_allclose(np.abs(t).max(), np.abs(j).max(), rtol=5e-2)


def test_initializers_misc():
    g = torch.Generator().manual_seed(1)
    q = tmodule.get_initializer("orthogonal")((16, 16), generator=g)
    np.testing.assert_allclose((q.T @ q).numpy(), np.eye(16), atol=1e-5)
    assert tmodule.get_initializer("zeros")((3,)).sum() == 0
    assert tmodule.get_initializer("ones")((3,)).sum() == 3
    assert tmodule.get_initializer("constant:2.5")((2,)).tolist() == [2.5, 2.5]
    assert tmodule.get_initializer("glorot_uniform")((0, 4)).shape == (0, 4)
    with pytest.raises(ValueError, match="Unknown initializer"):
        tmodule.get_initializer("nope")


@pytest.mark.parametrize("name", ["relu", "tanh", "sigmoid", "gelu", "elu",
                                  "selu", "softplus", "swish", "silu",
                                  "leaky_relu", "softmax", "linear", None])
def test_activations_match_jax(name):
    from keras_geometric_tpu.nn.module import get_activation as j_act

    x = np.linspace(-3, 3, 35, dtype=np.float32).reshape(5, 7)
    np.testing.assert_allclose(
        tmodule.get_activation(name)(torch.from_numpy(x)).numpy(),
        np.asarray(j_act(name)(jnp.asarray(x))), rtol=1e-5, atol=1e-6)


def test_dense_and_mlp_match_jax():
    from keras_geometric_tpu.nn.module import MLP as JMLP

    j_mlp = JMLP(hidden_dims=(8, 6), output_dim=3)
    params = j_mlp.init(jax.random.PRNGKey(4), 5)
    t_mlp = kgt_torch.MLP((8, 6), 3, input_dim=5, device="cpu")
    t_mlp.load_state_dict(convert.params_from_jax(params))
    x = np.random.default_rng(0).standard_normal((9, 5)).astype(np.float32)
    np.testing.assert_allclose(
        t_mlp(torch.from_numpy(x)).detach().numpy(),
        np.asarray(j_mlp.apply(params, jnp.asarray(x))), **TOL)


def test_dropout_contract():
    x = torch.ones(1000, 8)
    assert tmodule.dropout(x, 0.5, False) is x
    assert tmodule.dropout(x, 0.0, True) is x
    g = torch.Generator().manual_seed(0)
    y = tmodule.dropout(x, 0.25, True, g)
    np.testing.assert_allclose(np.unique(y.numpy()), [0.0, 1 / 0.75], rtol=1e-6)
    assert abs(y.mean().item() - 1.0) < 0.05
    keep = torch.zeros(1000, 8, dtype=torch.bool)
    assert tmodule.dropout(x, 0.25, True, keep_mask=keep).sum() == 0
