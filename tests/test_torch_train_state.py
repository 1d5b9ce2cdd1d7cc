"""The port's training state, checkpoints, metrics and ``label_nll`` against
the JAX package's: the same values and records, and a checkpoint that resumes
a run bit for bit.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import keras_geometric_tpu_torch as kgt_torch
from keras_geometric_tpu.training import checkpoint as jckpt
from keras_geometric_tpu.training import metrics as jmetrics
from keras_geometric_tpu.training import train as jtrain
from keras_geometric_tpu_torch.data.sampling import NeighborSampler
from keras_geometric_tpu_torch.training import (
    MetricLogger,
    TrainState,
    label_nll,
    load_config,
    make_node_classification_step,
    masked_softmax_cross_entropy,
    restore_checkpoint,
    save_checkpoint,
    save_config,
)
from keras_geometric_tpu_torch.training import checkpoint as tckpt
from keras_geometric_tpu_torch.training.sage_minibatch import (
    make_sage_minibatch_step,
    subgraph_to_arrays,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("shape", [(7, 5), (1, 40), (3, 4, 6)])
def test_label_nll_matches_reference(shape):
    rng = np.random.default_rng(len(shape))
    logits = rng.standard_normal(shape).astype(np.float32) * 3
    labels = rng.integers(0, shape[-1], shape[:-1]).astype(np.int32)
    logp = torch.log_softmax(torch.from_numpy(logits), dim=-1)
    got = label_nll(logp, torch.from_numpy(labels))
    want = jtrain.label_nll(jnp.asarray(logp.numpy()), jnp.asarray(labels))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if len(shape) == 2:
        mask = rng.random(shape[0]) < 0.6
        got = masked_softmax_cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(labels),
            torch.from_numpy(mask))
        want = jtrain.masked_softmax_cross_entropy(
            jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def _gcn_run(seed):
    """A GCN with dropout on both layers' outputs; its step and state."""
    rng = np.random.default_rng(0)
    n = 40
    ei = rng.integers(0, n, (2, 160))
    x = torch.from_numpy(rng.standard_normal((n, 6)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 3, n))
    mask = torch.from_numpy(rng.random(n) < 0.7)
    gen = torch.Generator().manual_seed(seed)
    model = kgt_torch.GCN((8, 3), input_dim=6, dropout_rate=0.5,
                          generator=gen, device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=0.02)
    step = make_node_classification_step(model, opt, generator=gen)
    ei = torch.from_numpy(ei)
    state = TrainState(model, opt, generator=gen)
    return state, lambda: step(x, ei, y, mask)


def _sage_run(seed):
    """A two-layer GraphSAGE minibatch run with dropout, over fixed buckets."""
    rng = np.random.default_rng(1)
    n = 60
    ei = np.stack([rng.integers(0, n, 300), rng.integers(0, n, 300)])
    x = torch.from_numpy(rng.standard_normal((n, 5)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 3, n))
    subs = list(NeighborSampler(ei, n, (4, 3), seed=0).epoch(
        np.arange(n), 8))
    gen = torch.Generator().manual_seed(seed)
    layers = torch.nn.ModuleList([
        kgt_torch.SAGEConv(10, input_dim=5, dropout_rate=0.3, generator=gen,
                           device="cpu"),
        kgt_torch.SAGEConv(3, input_dim=10, activation=None, dropout_rate=0.3,
                           generator=gen, device="cpu")])
    opt = torch.optim.Adam(layers.parameters(), lr=0.02)
    step, _ = make_sage_minibatch_step(tuple(layers), 3, opt, generator=gen)
    state = TrainState(layers, opt, generator=gen)
    return state, lambda: step(subgraph_to_arrays(subs[state.step], x, y))


@pytest.mark.parametrize("run", [_gcn_run, _sage_run], ids=["gcn", "sage"])
def test_checkpoint_resumes_a_run_bit_for_bit(tmp_path, run):
    def advance(state, step, count):
        losses = []
        for _ in range(count):
            losses.append(step())
            state.step += 1
        return losses

    state, step = run(seed=5)
    whole = advance(state, step, 6)
    whole_params = {k: v.clone() for k, v in state.model.state_dict().items()}

    state, step = run(seed=5)
    first = advance(state, step, 3)
    assert all(torch.equal(a, b) for a, b in zip(first, whole[:3]))
    config = {"family": run.__name__, "dims": [8, 3], "dropout": 0.5}
    save_checkpoint(str(tmp_path / "ckpt"), state, config=config)
    # The file loads with weights_only (tensors, ints and dicts).
    raw = torch.load(tmp_path / "ckpt" / tckpt.STATE_FILE, weights_only=True)
    assert raw["step"] == 3 and isinstance(raw["generator"], torch.Tensor)
    assert load_config(str(tmp_path / "ckpt" / "model_config.json")) == config

    fresh, fresh_step = run(seed=99)  # other weights, other stream
    assert not torch.equal(next(iter(fresh.model.parameters())),
                           next(iter(state.model.parameters())))
    restored = restore_checkpoint(str(tmp_path / "ckpt"), fresh)
    assert restored is fresh and fresh.step == 3
    rest = advance(fresh, fresh_step, 3)
    for a, b in zip(rest, whole[3:]):
        assert torch.equal(a, b), (a, b)
    for key, value in fresh.model.state_dict().items():
        assert torch.equal(value, whole_params[key]), key
    assert fresh.step == 6


def test_restore_without_a_target_returns_the_saved_dict(tmp_path):
    state, step = _gcn_run(seed=0)
    step()
    save_checkpoint(str(tmp_path / "c"), state)
    got = restore_checkpoint(str(tmp_path / "c"))
    assert set(got) == {"model", "optimizer", "step", "generator"}
    for key, value in state.model.state_dict().items():
        assert torch.equal(got["model"][key], value)
    # A dict of tensors checkpoints as it is.
    save_checkpoint(str(tmp_path / "d"), {"w": torch.arange(3.0)})
    assert torch.equal(restore_checkpoint(str(tmp_path / "d"))["w"],
                       torch.arange(3.0))
    no_gen = TrainState(state.model, state.optimizer)
    with pytest.raises(ValueError, match="generator"):
        no_gen.load_state_dict(got)


def test_config_files_are_the_references(tmp_path):
    config = {"conv": "sage", "hidden_dims": [256, 40], "fanouts": (25, 10),
              "lr": 1e-3, "dtype": np.float32, "nested": {"a": None}}
    save_config(str(tmp_path / "port" / "model_config.json"), config)
    jckpt.save_config(str(tmp_path / "ref" / "model_config.json"), config)
    port_text = (tmp_path / "port" / "model_config.json").read_text()
    assert port_text == (tmp_path / "ref" / "model_config.json").read_text()
    assert load_config(str(tmp_path / "port" / "model_config.json")) == \
        jckpt.load_config(str(tmp_path / "ref" / "model_config.json"))


def test_metric_logger_writes_the_references_records(tmp_path, capsys):
    loggers = (MetricLogger(str(tmp_path / "port.jsonl"), print_every=2),
               jmetrics.MetricLogger(str(tmp_path / "ref.jsonl"),
                                     print_every=2))
    for step in range(4):
        for logger in loggers:
            logger.log(step, loss=torch.tensor(1.5 / (step + 1)), acc=0.25)
    printed = capsys.readouterr().out.splitlines()
    assert printed[0::2] == printed[1::2] and len(printed) == 4
    for logger in loggers:
        logger.close()
    port = [json.loads(l) for l in open(tmp_path / "port.jsonl")]
    ref = [json.loads(l) for l in open(tmp_path / "ref.jsonl")]
    assert len(port) == len(ref) == 4
    for a, b in zip(port, ref):
        assert list(a) == list(b) == ["step", "time", "loss", "acc"]
        assert {k: v for k, v in a.items() if k != "time"} == \
            {k: v for k, v in b.items() if k != "time"}
    assert loggers[0].history == port
    MetricLogger().log(0, loss=1.0)  # no file, no print
