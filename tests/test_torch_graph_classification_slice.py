"""Port parity for graph classification as a whole (``GraphClassifier``: a
GIN encoder, ``batch_pool`` and a Dense head) and for the config round-trip.

The same padded batch (``batch_graphs_padded`` of each package over the same
numpy graphs) and the same weights (the reference's init, carried by
``convert.params_from_jax``) go through the JAX package's model and the
port's: logits and every gradient within 1e-5 of their largest entry, for the
readouts sum, mean and max; one Adam step (the port example's
``make_train_step``) against ``optax.adam``, loss and parameters within
1e-5. Every module class that has a config in the reference gives the same
``get_config()`` JSON in the port, ``from_config`` of either package's config
rebuilds it in the port, and with the carried weights its outputs equal the
reference's within 1e-5. The two twins of this slice run on the CPU.
"""

import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import keras_geometric_tpu as R
import keras_geometric_tpu_torch as T
from keras_geometric_tpu.models import gnn as rgnn
from keras_geometric_tpu.utils.data_utils import GraphData as RGraphData
from keras_geometric_tpu.utils.data_utils import (
    batch_graphs_padded as r_batch_padded,
)
from keras_geometric_tpu_torch import convert
from keras_geometric_tpu_torch.models import gnn as tgnn
from keras_geometric_tpu_torch.utils.data_utils import (
    batch_graphs_padded as t_batch_padded,
)

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
F_IN, CLASSES, GRAPHS = 8, 3, 5
NODE_BUCKET, EDGE_BUCKET = 64, 256


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


GC = _example("graph_classification")


def _graphs(seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(GRAPHS):
        n = int(rng.integers(5, 11))
        e = int(rng.integers(n, 3 * n))
        out.append(dict(
            x=rng.standard_normal((n, F_IN)).astype(np.float32),
            edge_index=rng.integers(0, n, (2, e)).astype(np.int32),
            y=np.array([i % CLASSES], np.int32)))
    return out


def _batches(seed):
    graphs = _graphs(seed)
    rb = r_batch_padded([RGraphData(**g) for g in graphs],
                        node_bucket=NODE_BUCKET, edge_bucket=EDGE_BUCKET)
    tb = t_batch_padded([T.GraphData(**g) for g in graphs],
                        node_bucket=NODE_BUCKET, edge_bucket=EDGE_BUCKET,
                        device="cpu")
    y = np.full(GRAPHS + 1, -1, np.int64)
    y[:GRAPHS] = [g["y"][0] for g in graphs]
    return rb, tb, y


def _models(readout, seed, head_hidden=(6,)):
    r_model = rgnn.GraphClassifier(
        rgnn.GIN((8, 8, 8), mlp_hidden=(8,)), CLASSES, readout=readout,
        head_hidden=head_hidden)
    params = r_model.init(jax.random.PRNGKey(seed), F_IN)
    t_model = tgnn.GraphClassifier(
        tgnn.GIN((8, 8, 8), mlp_hidden=(8,), input_dim=F_IN, device="cpu"),
        CLASSES, readout=readout, head_hidden=head_hidden, device="cpu")
    t_model.load_state_dict(convert.params_from_jax(params))
    return r_model, params, t_model


def _r_loss(r_model, rb, y):
    """The reference example's loss (``examples/graph_classification.py``)."""
    y = jnp.asarray(y)

    def loss_fn(p):
        logits = r_model.apply(
            p, rb.x, jnp.stack([rb.senders, rb.receivers]), rb.batch,
            GRAPHS + 1, edge_mask=rb.edge_mask, node_mask=rb.node_mask)
        valid = y >= 0
        logp = jax.nn.log_softmax(logits)
        nll = -jnp.take_along_axis(logp, jnp.maximum(y, 0)[:, None],
                                   axis=-1)[:, 0]
        return jnp.sum(nll * valid) / jnp.maximum(jnp.sum(valid), 1), logits

    return loss_fn


def _close_tree(got: dict, want: dict, tol, what):
    assert set(got) == set(want), what
    scale = max(float(np.abs(np.asarray(v)).max()) for v in want.values())
    for key in want:
        np.testing.assert_allclose(
            np.asarray(got[key], np.float32), np.asarray(want[key], np.float32),
            rtol=0, atol=tol * max(scale, 1e-12), err_msg=f"{what} {key}")


@pytest.mark.parametrize("readout", ["sum", "mean", "max"])
def test_logits_and_gradients_match_reference(readout):
    rb, tb, y = _batches(0)
    r_model, params, t_model = _models(readout, 1)
    (r_loss, r_logits), r_grads = jax.value_and_grad(
        _r_loss(r_model, rb, y), has_aux=True)(params)
    t_model.train()
    logits = t_model(tb.x, tb.edge_index, tb.batch, GRAPHS + 1,
                     edge_mask=tb.edge_mask, node_mask=tb.node_mask)
    loss = GC.graph_nll(logits, torch.from_numpy(y))
    loss.backward()
    assert logits.shape == (GRAPHS + 1, CLASSES)
    _close_tree({"logits": logits.detach().numpy()},
                {"logits": np.asarray(r_logits)}, 1e-5, "logits")
    np.testing.assert_allclose(loss.item(), float(r_loss), rtol=1e-5)
    _close_tree({k: p.grad.numpy() for k, p in t_model.named_parameters()},
                {k: v.numpy() for k, v in
                 convert.params_from_jax(r_grads).items()}, 1e-5, "gradient")


def test_one_adam_step_matches_optax():
    """The port example's train_step (``torch.optim.Adam(1e-3)``) against the
    reference example's (``optax.adam(1e-3)``) on the same bucket."""
    rb, tb, y = _batches(2)
    r_model, params, t_model = _models("sum", 3, head_hidden=())
    tx = optax.adam(1e-3)
    (r_loss, _), grads = jax.value_and_grad(
        _r_loss(r_model, rb, y), has_aux=True)(params)
    updates, _ = tx.update(grads, tx.init(params), params)
    r_after = convert.params_from_jax(optax.apply_updates(params, updates))
    step = GC.make_train_step(
        t_model, torch.optim.Adam(t_model.parameters(), lr=1e-3), GRAPHS + 1)
    t_loss = step(tb, torch.from_numpy(y))
    np.testing.assert_allclose(t_loss.item(), float(r_loss), rtol=1e-5)
    _close_tree({k: p.detach().numpy() for k, p in t_model.named_parameters()},
                {k: v.numpy() for k, v in r_after.items()}, 1e-5, "parameter")


# -- the config round-trip -----------------------------------------------------

N, E = 10, 30


def _graph_inputs():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((N, F_IN)).astype(np.float32)
    ei = rng.integers(0, N, (2, E)).astype(np.int32)
    batch = np.repeat(np.arange(2), N // 2).astype(np.int32)
    recv = np.sort(rng.integers(0, N, E)).astype(np.int32)
    msgs = rng.standard_normal((E, F_IN)).astype(np.float32)
    return dict(x=x, ei=ei, batch=batch, recv=recv, msgs=msgs)


# name -> (reference constructor kwargs, how each package calls the module)
CASES = {
    "Dense": (dict(units=5, activation="tanh", use_bias=False), "x"),
    "MLP": (dict(hidden_dims=(7, 6), output_dim=4, activation="elu",
                 dropout_rate=0.25), "x"),
    "GCNConv": (dict(output_dim=5, add_self_loops=False, dropout_rate=0.1),
                "x_ei"),
    "GINConv": (dict(output_dim=5, mlp_hidden=(7,), aggregator="mean",
                     eps_init=0.25, train_eps=True), "x_ei"),
    "GATv2Conv": (dict(output_dim=3, heads=2, concat=False,
                       negative_slope=0.1, fused_attend=False), "x_ei"),
    "SAGEConv": (dict(output_dim=5, aggregator="pooling", normalize=True,
                      pool_hidden_dim=9, activation="tanh"), "x_ei"),
    "PoolingAggregator": (dict(units=6, activation="sigmoid"), "messages"),
    "GNNEncoder": (dict(conv="gatv2", hidden_dims=(4, 3),
                        dropout_rate=0.2, final_activation="tanh",
                        conv_kwargs=(("heads", 2), ("concat", True))),
                   "x_ei"),
    "GraphClassifier": (None, "classify"),
    "GlobalPooling": (dict(pooling="max"), "x"),
    "BatchGlobalPooling": (dict(pooling="mean"), "batched"),
    "AttentionPooling": (dict(attention_dim=4, dropout=0.3), "x"),
    "Set2Set": (dict(output_dim=4, processing_steps=2, lstm_units=3,
                     dropout=0.1), "x"),
}


def _classes(name):
    return getattr(R.nn, name, None) or getattr(rgnn, name), (
        getattr(T.nn, name, None) or getattr(tgnn, name))


def _pair(name):
    kwargs, _ = CASES[name]
    r_cls, t_cls = _classes(name)
    build = {} if name.endswith("GlobalPooling") else dict(
        input_dim=F_IN, device="cpu")
    if name == "GraphClassifier":
        r = r_cls(rgnn.GraphSAGE((6, 5), aggregator="max"), CLASSES,
                  readout="max", head_hidden=(4,))
        t = t_cls(tgnn.GraphSAGE((6, 5), aggregator="max", **build), CLASSES,
                  readout="max", head_hidden=(4,), device="cpu")
        return r, t, build
    return r_cls(**kwargs), t_cls(**kwargs, **build), build


def _call(name, module, params, d, port):
    how = CASES[name][1]
    if port:
        conv = lambda v: torch.from_numpy(v)
        run = lambda *a: module(*a)
    else:
        conv = jnp.asarray
        run = lambda *a: module.apply(params, *a)
    if how == "x":
        return run(conv(d["x"]))
    if how == "x_ei":
        return run(conv(d["x"]), conv(d["ei"]))
    if how == "messages":
        return run(conv(d["msgs"]), conv(d["recv"]), N)
    if how == "batched":
        return run(conv(d["x"]), conv(d["batch"]), 2)
    return run(conv(d["x"]), conv(d["ei"]), conv(d["batch"]), 2)


def _json(config):
    return json.dumps(config, sort_keys=True)


def test_every_configurable_reference_class_is_covered():
    ref_modules = {name for name in dir(R.nn) + dir(rgnn)
                   if isinstance(getattr(R.nn, name, getattr(rgnn, name, None)),
                                 type)
                   and issubclass(getattr(R.nn, name, None)
                                  or getattr(rgnn, name), R.nn.Module)
                   and name != "Module"}
    assert ref_modules == set(CASES)


@pytest.mark.parametrize("name", sorted(CASES))
def test_config_round_trip_both_ways(name):
    r, t, build = _pair(name)
    r_cfg, t_cfg = r.get_config(), t.get_config()
    assert _json(t_cfg) == _json(r_cfg)
    r_cls, t_cls = _classes(name)
    # The reference rebuilds itself from the port's config...
    assert r_cls.from_config(json.loads(_json(t_cfg))) == r
    # ... and the port from the reference's (through JSON, as a file
    # carries it) and from its own: the same config again.
    for cfg in (json.loads(_json(r_cfg)), t_cfg):
        rebuilt = t_cls.from_config(cfg, **build)
        assert type(rebuilt) is t_cls
        assert _json(rebuilt.get_config()) == _json(r_cfg)
    # With the reference's weights the rebuilt module computes the
    # reference's outputs (in eval mode: no dropout).
    params = r.init(jax.random.PRNGKey(5), F_IN)
    rebuilt.load_state_dict(convert.params_from_jax(params))
    d = _graph_inputs()
    want = _call(name, r, params, d, port=False)
    with torch.no_grad():
        got = _call(name, rebuilt.eval(), None, d, port=True)
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * max(scale, 1e-6))


def test_from_config_needs_the_input_width():
    cfg = T.Dense(3, input_dim=2, device="cpu").get_config()
    with pytest.raises(ValueError, match="input_dim"):
        T.Dense.from_config(cfg)
    clf = tgnn.GraphClassifier.from_config(
        _pair("GraphClassifier")[0].get_config(), input_dim=F_IN,
        device="cpu")
    assert clf.encoder.input_dim == F_IN
    assert [n for n, _ in clf.named_children()] == ["encoder", "head_0",
                                                    "head_1"]


# -- the examples' twins of this slice -----------------------------------------


@pytest.mark.parametrize("script,args,expect", [
    ("graph_classification", ["--epochs", "1"], "test accuracy: "),
    ("pooling_readouts", [], "PoolingAggregator: (9, 12)"),
])
def test_twin_runs_on_the_cpu(script, args, expect):
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run(
        [sys.executable, f"examples_torch/{script}.py", "--device", "cpu",
         *args], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert expect in proc.stdout.strip().splitlines()[-1]


def _step1(model, step):
    loss = step().item()
    return loss, {k: p.grad.detach().clone()
                  for k, p in model.named_parameters()}


def test_node_classification_twin_context_path_matches_edge_list_path():
    """The twin's functions on the CPU: step 1 through a prepared context
    (the card's path, here on the kernels' plain versions) against step 1
    on the edge list (its CPU path), the same weights, dropout off."""
    nc = _example("node_classification")
    cpu = torch.device("cpu")
    graph, classes = nc.load_graph("cora")
    t = nc.graph_tensors(graph, cpu)
    assert nc.prepare_context(graph, cpu) is None  # the CPU takes edges
    ctx = T.prepare_graph(np.asarray(graph.edge_index), graph.x.shape[0],
                          add_self_loops=True, gcn_normalize=True,
                          device=cpu)
    runs = []
    for context in (ctx, None):
        gen = torch.Generator().manual_seed(0)
        model = nc.make_model(t["x"].shape[1], 8, classes, 0.0,
                              context=context is not None, device=cpu,
                              generator=gen)
        forward = nc.make_forward(model, t["x"], t["edge_index"], context,
                                  gen)
        opt = torch.optim.SGD(model.parameters(), lr=0.0)
        runs.append(_step1(model, nc.make_train_step(
            model, forward, t["y"], t["train_mask"], opt)))
    (loss, grads), (want_loss, want_grads) = runs
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    for key, want in want_grads.items():
        err = (grads[key] - want).abs().max() / want.abs().max()
        assert err <= 1e-5, key


def test_locality_twin_trains_on_its_banded_context_on_the_cpu():
    lb = _example("locality_banded_gcn")
    cpu = torch.device("cpu")
    ctx, x, y, mask = lb.prepare(lb.make_graph(2_000), cpu)
    assert ctx.num_band_edges > ctx.num_real_edges > 0
    assert ctx.band.band.dtype == torch.float32
    enc = lb.make_encoder(cpu, torch.Generator().manual_seed(0))
    step = lb.make_train_step(
        enc, torch.optim.Adam(enc.parameters(), lr=1e-2), ctx, x, y, mask)
    losses = [float(step()) for _ in range(4)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
