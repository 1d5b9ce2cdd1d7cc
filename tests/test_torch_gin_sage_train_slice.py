"""Port parity for the GIN / GraphSAGE slice as a whole: the same graph and the
same converted weights go through the JAX package's training step on a
context (its gather in interpret mode, its max and pooling through XLA's
``segment_max``) and through
``keras_geometric_tpu_torch.training.make_node_classification_step`` on a
``GraphSAGE(aggregator="pooling")`` and a ``GIN`` with ``aggregator="max"``
(on the CPU the context's kernels, the wide segment max among them, are their
plain versions).

The features are ReLU'd and rounded to halves and the pooling layers' biases
shifted down, so the maxes hold ties; the port must split their cotangents
as XLA does.

Tolerances: step-1 loss 1e-4 and gradients 1e-3 of their largest entry (the
reference's gather backward sums in two bf16 passes, ROADMAP D1); the losses
of three Adam steps 1e-3 (Adam divides by the gradients' root mean square,
so their small differences show in the later losses).
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
from keras_geometric_tpu.training import train as jtrain
from keras_geometric_tpu_torch import convert
from keras_geometric_tpu_torch.kernels import spmm_cuda
from keras_geometric_tpu_torch.training import make_node_classification_step

torch.set_num_threads(1)

N, F_IN, CLASSES = 60, 7, 5
DIMS = (12, CLASSES)
FAMILIES = {
    "sage_pooling": ("sage", {"aggregator": "pooling"}),
    "gin_max": ("gin", {"aggregator": "max", "mlp_hidden": (10,)}),
}


def _workload(seed):
    rng = np.random.default_rng(seed)
    e = 240
    ei = np.stack([rng.integers(0, N, e), rng.integers(0, N - 4, e)]).astype(
        np.int32)
    x = np.round(np.maximum(rng.standard_normal((N, F_IN)), 0.0) * 2) / 2
    y = rng.integers(0, CLASSES, N).astype(np.int64)
    mask = rng.random(N) < 0.6
    jc = j_prepare(ei, N, edge_chunk=64)
    tc = kgt_torch.prepare_graph(ei, N, edge_chunk=64, device="cpu")
    return jc, tc, x.astype(np.float32), y, mask


def _models(name, seed):
    family, conv_kwargs = FAMILIES[name]
    j_enc = JGNNEncoder(family, DIMS, conv_kwargs=tuple(conv_kwargs.items()))
    params = j_enc.init(jax.random.PRNGKey(seed), F_IN)
    for i in range(len(DIMS)):
        layer = params[f"layer_{i}"]
        if "pool_mlp" in layer:  # whole rows of pooled messages tied at 0
            layer["pool_mlp"]["bias"] = layer["pool_mlp"]["bias"] - 0.3
    t_enc = kgt_torch.GNNEncoder(family, DIMS, input_dim=F_IN, device="cpu",
                                 conv_kwargs=conv_kwargs)
    t_enc.load_state_dict(convert.params_from_jax(params))
    return j_enc, params, t_enc


class _ContextModel:
    """The reference's step wants ``apply(params, x, edge_index, training=,
    rng=)``: close over the context."""

    def __init__(self, encoder, context):
        self.encoder, self.context = encoder, context

    def apply(self, params, x, edge_index, training=False, rng=None):
        return self.encoder.apply(params, x, context=self.context,
                                  training=training, rng=rng)


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        name = f"{prefix}.{key}" if prefix else key
        out.update(_flat(value, name) if isinstance(value, dict)
                   else {name: np.asarray(value)})
    return out


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_one_training_step_matches_jax(name):
    jc, tc, x, y, mask = _workload(1)
    j_enc, params, t_enc = _models(name, 1)

    def j_loss(p):
        logits = j_enc.apply(p, jnp.asarray(x), context=jc, training=True)
        return jtrain.masked_softmax_cross_entropy(
            logits, jnp.asarray(y), jnp.asarray(mask))

    with pltpu.force_tpu_interpret_mode():
        ref_loss, ref_grads = jax.value_and_grad(j_loss)(params)
    ref_grads = _flat(ref_grads)
    step = make_node_classification_step(
        t_enc, torch.optim.SGD(t_enc.parameters(), lr=0.0))
    spmm_cuda.reset_launch_counts()
    loss = float(step(torch.from_numpy(x), None, torch.from_numpy(y),
                      torch.from_numpy(mask), context=tc))
    assert abs(loss - float(ref_loss)) <= 1e-4
    assert {n for n, _ in t_enc.named_parameters()} == set(ref_grads)
    for pname, p in t_enc.named_parameters():
        want = ref_grads[pname]
        scale = max(float(np.abs(want).max()), 1e-6)
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=1e-3 * scale, err_msg=pname)
    # CPU tensors take the plain versions: nothing was launched.
    assert not any(spmm_cuda.LAUNCH_COUNTS.values())


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_three_adam_steps_match_jax_and_lower_the_loss(name):
    jc, tc, x, y, mask = _workload(2)
    j_enc, params, t_enc = _models(name, 2)
    tx = optax.adam(1e-2)
    j_step = jtrain.make_node_classification_step(
        _ContextModel(j_enc, jc), tx, donate=False)
    state = jtrain.TrainState.create(params, tx, jax.random.PRNGKey(0))
    j_losses = []
    with pltpu.force_tpu_interpret_mode():
        for _ in range(3):
            state, loss = j_step(state, jnp.asarray(x), None,
                                 jnp.asarray(y), jnp.asarray(mask))
            j_losses.append(float(loss))
    t_step = make_node_classification_step(
        t_enc, torch.optim.Adam(t_enc.parameters(), lr=1e-2))
    args = (torch.from_numpy(x), None, torch.from_numpy(y),
            torch.from_numpy(mask))
    t_losses = [float(t_step(*args, context=tc)) for _ in range(8)]
    np.testing.assert_allclose(t_losses[:3], j_losses, rtol=0, atol=1e-3)
    assert t_losses[-1] < t_losses[0]
