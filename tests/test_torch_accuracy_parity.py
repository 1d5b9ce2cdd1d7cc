"""End-to-end accuracy parity of the port: a 2-layer GCN trained for 150
epochs on the port's ``synthetic_planetoid("cora")`` reaches the same test
accuracy on the plain edge-list path and on a ``prepare_graph`` context (CPU:
the context's kernels are their plain versions), and the JAX package's run of
the same model from the same initial parameters on the same data.

As in the JAX package's own accuracy test, the data is the synthetic
stand-in: only the agreement of the trained outcomes is asserted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import keras_geometric_tpu_torch as kgt_torch
from keras_geometric_tpu.models import GNNEncoder as JGNNEncoder
from keras_geometric_tpu.training import TrainState as JTrainState
from keras_geometric_tpu.training import train as jtrain
from keras_geometric_tpu_torch import convert
from keras_geometric_tpu_torch.data.datasets import synthetic_planetoid
from keras_geometric_tpu_torch.training import (
    make_eval_fn,
    make_node_classification_step,
)

torch.set_num_threads(1)

HIDDEN, LR, EPOCHS = 16, 0.01, 150


@pytest.fixture(scope="module")
def run():
    g = synthetic_planetoid("cora", seed=0)
    c = int(g.y.max()) + 1
    j_model = JGNNEncoder(conv="gcn", hidden_dims=(HIDDEN, c))
    params = j_model.init(jax.random.PRNGKey(0), g.x.shape[1])

    tx = optax.adam(LR)
    state = JTrainState.create(params, tx, jax.random.PRNGKey(1))
    step = jtrain.make_node_classification_step(j_model, tx, donate=False)
    x, ei, y = jnp.asarray(g.x), jnp.asarray(g.edge_index), jnp.asarray(g.y)
    for _ in range(EPOCHS):
        state, _ = step(state, x, ei, y, jnp.asarray(g.train_mask))
    acc_jax = float(jtrain.make_eval_fn(j_model)(
        state.params, x, ei, y, jnp.asarray(g.test_mask)))

    def port_accuracy(use_context):
        if use_context:
            ctx = kgt_torch.prepare_graph(g.edge_index, g.num_nodes,
                                          add_self_loops=True,
                                          gcn_normalize=True, device="cpu")
            model = kgt_torch.GNNEncoder.for_context(
                "gcn", (HIDDEN, c), input_dim=g.x.shape[1], device="cpu")
        else:
            ctx = None
            model = kgt_torch.GCN((HIDDEN, c), input_dim=g.x.shape[1],
                                  device="cpu")
        model.load_state_dict(convert.params_from_jax(params))
        opt = torch.optim.Adam(model.parameters(), lr=LR)
        step = make_node_classification_step(model, opt)
        x_t, y_t = torch.from_numpy(g.x), torch.from_numpy(g.y)
        ei_t = torch.from_numpy(g.edge_index)
        train_mask = torch.from_numpy(g.train_mask)
        for _ in range(EPOCHS):
            step(x_t, ei_t, y_t, train_mask, context=ctx)
        return float(make_eval_fn(model)(
            x_t, ei_t, y_t, torch.from_numpy(g.test_mask), context=ctx))

    return acc_jax, port_accuracy(False), port_accuracy(True)


def test_context_path_matches_the_plain_path(run):
    _, acc_plain, acc_ctx = run
    assert acc_ctx > 0.55, acc_ctx
    assert abs(acc_ctx - acc_plain) <= 0.01, (acc_plain, acc_ctx)


def test_port_matches_the_jax_packages_run(run):
    acc_jax, acc_plain, acc_ctx = run
    assert acc_jax > 0.55, acc_jax
    assert abs(acc_plain - acc_jax) <= 0.02, (acc_jax, acc_plain)
    assert abs(acc_ctx - acc_jax) <= 0.02, (acc_jax, acc_ctx)
