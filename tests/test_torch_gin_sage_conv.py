"""Port parity for ``GINConv`` (sum, mean, max; fixed and trainable eps; MLP
depth) and ``SAGEConv`` (mean, max, sum, min, std, pooling; ``normalize``,
``root_weight=False``), on a plain ``edge_index`` and on a context, against
the JAX package's layers on a plain ``edge_index`` (pure XLA), forward and
gradients, with the reference's parameters carried over by ``convert``.

On the CPU a context's kernels are their plain versions; the max, min and
pooling paths on a context run the wide segment max with the split tie rule
(``GraphContext.scatter_max``), which must give XLA's ``segment_max``
gradient. The inputs hold ties: features are ReLU'd and rounded to halves,
and the pooling layer's bias is shifted down, so that whole rows of pooled
messages are 0. Some nodes receive no edge, and the context pads its stream.

Tolerance 1e-4 relative and times the largest entry (ROADMAP D1): both sides
are f32 library ops in another order. NaN gradients (the std's square root at
a zero variance, in both packages) must sit at the same places. With
``normalize`` the activation is linear: the reference's norm has a NaN
gradient at an all-zero row, which a ReLU makes likely.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import keras_geometric_tpu_torch as kgt_torch
from keras_geometric_tpu.nn.gin_conv import GINConv as JGINConv
from keras_geometric_tpu.nn.sage_conv import SAGEConv as JSAGEConv
from keras_geometric_tpu_torch import convert

torch.set_num_threads(1)

N, F_IN, F_OUT = 20, 6, 5
TOL = 1e-4


def _graph(seed, e=70):
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, N, e), rng.integers(0, N - 3, e)])
    x = np.round(np.maximum(rng.standard_normal((N, F_IN)), 0.0) * 2) / 2
    return ei.astype(np.int32), x.astype(np.float32)


def _close(got, want, what):
    want = np.asarray(want)
    assert np.array_equal(np.isnan(got), np.isnan(want)), what
    got, want = np.nan_to_num(got), np.nan_to_num(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale,
                               err_msg=what)


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        name = f"{prefix}.{key}" if prefix else key
        if isinstance(value, dict):
            out.update(_flat(value, name))
        else:
            out[name] = value
    return out


def _check(j_layer, params, t_layer, ei, x, context):
    """Forward and gradients (parameters and features) of the port's layer,
    on ``ei`` or on ``context``, against the reference layer on ``ei``."""
    t_layer.load_state_dict(convert.params_from_jax(params))
    t_layer.eval()
    w = np.random.default_rng(99).standard_normal(
        (x.shape[0], t_layer.output_dim)).astype(np.float32)

    def j_loss(p, xx):
        out = j_layer.apply(p, xx, jnp.asarray(ei))
        return jnp.sum(out * w), out

    (_, want), (j_gp, j_gx) = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    if context is None:
        out = t_layer(xt, torch.from_numpy(ei))
    else:
        out = t_layer(xt, context=context)
    (out * torch.from_numpy(w)).sum().backward()
    _close(out.detach().numpy(), want, "forward")
    _close(xt.grad.numpy(), j_gx, "d x")
    j_gp = _flat(j_gp)
    names = {name for name, _ in t_layer.named_parameters()}
    assert names == set(j_gp)
    for name, p in t_layer.named_parameters():
        _close(p.grad.numpy(), j_gp[name], f"d {name}")


def _context(ei):
    return kgt_torch.prepare_graph(ei, N, edge_chunk=64, device="cpu")


@pytest.mark.parametrize("path", ["edge_index", "context"])
@pytest.mark.parametrize("mlp_hidden", [(), (8,)], ids=["mlp1", "mlp2"])
@pytest.mark.parametrize("train_eps", [False, True], ids=["fixed", "train"])
@pytest.mark.parametrize("aggregator", ["sum", "mean", "max"])
def test_gin_conv_matches_jax(aggregator, train_eps, mlp_hidden, path):
    ei, x = _graph(len(aggregator) + len(mlp_hidden))
    kw = dict(mlp_hidden=mlp_hidden, aggregator=aggregator, eps_init=0.25,
              train_eps=train_eps)
    j_layer = JGINConv(output_dim=F_OUT, **kw)
    params = j_layer.init(jax.random.PRNGKey(2), F_IN)
    t_layer = kgt_torch.GINConv(F_OUT, input_dim=F_IN, device="cpu", **kw)
    _check(j_layer, params, t_layer, ei, x,
           None if path == "edge_index" else _context(ei))


SAGE_OPTIONS = {
    "default": dict(),
    "normalize": dict(normalize=True, activation=None),
    "no_root": dict(root_weight=False),
}


@pytest.mark.parametrize("path", ["edge_index", "context"])
@pytest.mark.parametrize("option", sorted(SAGE_OPTIONS))
@pytest.mark.parametrize("aggregator",
                         ["mean", "max", "sum", "min", "std", "pooling"])
def test_sage_conv_matches_jax(aggregator, option, path):
    ei, x = _graph(len(aggregator) + len(option))
    kw = dict(aggregator=aggregator, **SAGE_OPTIONS[option])
    if aggregator == "pooling":
        kw["pool_hidden_dim"] = 7
    j_layer = JSAGEConv(output_dim=F_OUT, **kw)
    params = j_layer.init(jax.random.PRNGKey(4), F_IN)
    params["bias"] = params["bias"] + 0.1
    if aggregator == "pooling":  # whole rows of pooled messages tied at 0
        params["pool_mlp"]["bias"] = params["pool_mlp"]["bias"] - 0.5
    t_layer = kgt_torch.SAGEConv(F_OUT, input_dim=F_IN, device="cpu", **kw)
    _check(j_layer, params, t_layer, ei, x,
           None if path == "edge_index" else _context(ei))


@pytest.mark.parametrize("layer", ["gin", "sage_pooling", "sage_max"])
def test_edgeless_and_empty_graphs_match_jax(layer):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, F_IN)).astype(np.float32)
    if layer == "gin":
        j_layer = JGINConv(output_dim=F_OUT, eps_init=0.5)
        t_layer = kgt_torch.GINConv(F_OUT, input_dim=F_IN, eps_init=0.5,
                                    device="cpu")
    else:
        agg = layer.split("_")[1]
        j_layer = JSAGEConv(output_dim=F_OUT, aggregator=agg)
        t_layer = kgt_torch.SAGEConv(F_OUT, input_dim=F_IN, aggregator=agg,
                                     device="cpu")
    params = j_layer.init(jax.random.PRNGKey(1), F_IN)
    t_layer.load_state_dict(convert.params_from_jax(params))
    none = np.zeros((2, 0), np.int32)
    want = j_layer.apply(params, jnp.asarray(x), jnp.asarray(none))
    got = t_layer(torch.from_numpy(x), torch.from_numpy(none))
    _close(got.detach().numpy(), want, "no edges")
    empty = t_layer(torch.zeros(0, F_IN), torch.from_numpy(none))
    assert empty.shape == (0, F_OUT)


def test_sage_rejects_bipartite_input_on_a_context():
    ei, x = _graph(0)
    layer = kgt_torch.SAGEConv(F_OUT, input_dim=F_IN, device="cpu")
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError, match="bipartite"):
        layer((xt, xt), context=_context(ei))
    with pytest.raises(ValueError, match="Invalid aggregator"):
        kgt_torch.SAGEConv(F_OUT, input_dim=F_IN, aggregator="nope",
                           device="cpu")
    with pytest.raises(ValueError, match="Invalid aggregator"):
        kgt_torch.GINConv(F_OUT, input_dim=F_IN, aggregator="min",
                          device="cpu")


@pytest.mark.parametrize("family", ["gin", "sage"])
def test_encoders_on_a_context_match_jax(family):
    """``GIN`` / ``GraphSAGE`` stacks (max / pooling) on a context against
    the reference's encoder on the plain ``edge_index``."""
    from keras_geometric_tpu.models import GNNEncoder as JGNNEncoder
    from keras_geometric_tpu.models import GraphSAGE as JGraphSAGE

    ei, x = _graph(3)
    if family == "gin":
        j_enc = JGNNEncoder("gin", (8, 3), conv_kwargs=(
            ("mlp_hidden", (6,)), ("aggregator", "max")))
        t_enc = kgt_torch.GNNEncoder(
            "gin", (8, 3), input_dim=F_IN, device="cpu",
            conv_kwargs={"mlp_hidden": (6,), "aggregator": "max"})
    else:
        j_enc = JGraphSAGE((8, 3), aggregator="pooling")
        t_enc = kgt_torch.GraphSAGE((8, 3), aggregator="pooling",
                                    input_dim=F_IN, device="cpu")
        assert t_enc.layer_0.activation is None
    params = j_enc.init(jax.random.PRNGKey(5), F_IN)
    t_enc.load_state_dict(convert.params_from_jax(params))
    want = j_enc.apply(params, jnp.asarray(x), jnp.asarray(ei))
    got = t_enc(torch.from_numpy(x), context=_context(ei))
    _close(got.detach().numpy(), want, "encoder")
