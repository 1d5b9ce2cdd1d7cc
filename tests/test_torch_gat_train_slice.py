"""Port parity for the GATv2 slice as a whole: the same graph and the same
converted weights go through the JAX package's GAT training step (context path,
Pallas kernels in interpret mode) and through
``keras_geometric_tpu_torch.training.make_node_classification_step`` on a
``GAT`` built with ``GNNEncoder.for_context``.

Tolerances: loss 1e-4, parameter gradients rtol 2e-3 / atol 3e-3 (the
reference's f32 kernels split operands into two bf16 passes; its own tests
hold the fused attend's gradients to the same). bf16 IO is held to the port's
own f32 run: loss within 5e-2, gradients within 1e-1 of their largest entry
(every activation and the per-edge cotangent are rounded to 8 mantissa bits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import keras_geometric_tpu_torch as kgt_torch
from keras_geometric_tpu.models import GAT as JGAT
from keras_geometric_tpu.models import GNNEncoder as JGNNEncoder
from keras_geometric_tpu.ops.csr import prepare_graph as j_prepare
from keras_geometric_tpu.training import train as jtrain
from keras_geometric_tpu_torch import convert
from keras_geometric_tpu_torch.kernels import attend_cuda
from keras_geometric_tpu_torch.training import make_node_classification_step

torch.set_num_threads(1)

N, F_IN, HEADS = 60, 7, 2
DIMS = (8, 6)
CLASSES = 6


def _workload(seed=0, e=260):
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, N, e), rng.integers(0, N, e)]).astype(
        np.int32)
    x = rng.standard_normal((N, F_IN)).astype(np.float32)
    y = rng.integers(0, CLASSES, N).astype(np.int32)
    mask = rng.random(N) < 0.6
    jc = j_prepare(ei, N, add_self_loops=True, edge_chunk=64)
    tc = kgt_torch.prepare_graph(ei, N, add_self_loops=True, edge_chunk=64,
                                 device="cpu")
    return jc, tc, x, y, mask, ei


def _models(seed=0, attention_dropout=0.0, **kwargs):
    conv_kwargs = {"heads": HEADS, "dropout": attention_dropout}
    j_enc = JGNNEncoder.for_context(
        "gatv2", DIMS, conv_kwargs=conv_kwargs, **kwargs)
    params = j_enc.init(jax.random.PRNGKey(seed), F_IN)
    t_enc = kgt_torch.GNNEncoder.for_context(
        "gatv2", DIMS, input_dim=F_IN, conv_kwargs=conv_kwargs,
        device="cpu", **kwargs)
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


def _tensors(x, y, mask):
    return torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(mask)


def test_gat_encoder_has_the_reference_shapes():
    j_enc, params, t_enc = _models()
    # Every layer concatenates its heads, the last included: 2 x 6 wide.
    assert t_enc.output_dim == j_enc.output_dim == HEADS * DIMS[-1]
    state = t_enc.state_dict()
    flat = convert.params_from_jax(params)
    assert set(state) == set(flat) == {
        f"layer_{i}.{name}" for i in range(2)
        for name in ("kernel", "att", "bias")}
    for name, value in flat.items():
        assert state[name].shape == value.shape, name
    assert state["layer_1.kernel"].shape == (HEADS * DIMS[0], HEADS * DIMS[1])
    assert state["layer_0.att"].shape == (1, HEADS, DIMS[0])
    assert all(layer.add_self_loops is False for layer in t_enc.layers())
    back = convert.params_to_numpy(state)
    np.testing.assert_array_equal(back["layer_1"]["att"],
                                  np.asarray(params["layer_1"]["att"]))


def test_gat_helper_and_unported_families():
    j_gat = JGAT((64, 40), heads=4)
    t_gat = kgt_torch.GAT((64, 40), heads=4, input_dim=16, device="cpu")
    assert t_gat.conv == "gatv2" and t_gat.output_dim == j_gat.output_dim == 160
    assert [l.heads for l in t_gat.layers()] == [4, 4]
    assert t_gat.layer_1.input_dim == 256
    assert t_gat.layer_0.add_self_loops is True  # plain GAT keeps the loops
    assert kgt_torch.GAT((8, 6), input_dim=4, device="cpu").layer_0.heads == 8
    # 'gin' and 'sage' are ported too (ROADMAP M5): their encoders build.
    for family, layer in (("gin", kgt_torch.GINConv),
                          ("sage", kgt_torch.SAGEConv)):
        enc = kgt_torch.GNNEncoder(family, (4,), input_dim=4, device="cpu")
        assert isinstance(enc.layer_0, layer) and enc.output_dim == 4
    with pytest.raises(ValueError, match="Unknown conv family"):
        kgt_torch.GNNEncoder("gat", (4,), input_dim=4, device="cpu")


def test_one_training_step_matches_jax():
    jc, tc, x, y, mask, _ = _workload()
    j_enc, params, t_enc = _models()

    def j_loss(p):
        logits = j_enc.apply(p, jnp.asarray(x), context=jc)
        return jtrain.masked_softmax_cross_entropy(
            logits, jnp.asarray(y), jnp.asarray(mask))

    with pltpu.force_tpu_interpret_mode():
        ref_loss, ref_grads = jax.value_and_grad(j_loss)(params)

    opt = torch.optim.SGD(t_enc.parameters(), lr=0.0)
    step = make_node_classification_step(t_enc, opt)
    attend_cuda.reset_launch_counts()
    loss = float(step(torch.from_numpy(x), None, torch.from_numpy(y),
                      torch.from_numpy(mask), context=tc))
    assert abs(loss - float(ref_loss)) <= 1e-4
    for name, p in t_enc.named_parameters():
        layer, leaf = name.split(".")
        np.testing.assert_allclose(
            p.grad.numpy(), np.asarray(ref_grads[layer][leaf]), rtol=2e-3,
            atol=3e-3, err_msg=name)
    # CPU tensors take the plain versions: nothing was launched.
    assert not any(attend_cuda.LAUNCH_COUNTS.values())


def test_training_steps_match_jax_and_lower_the_loss():
    jc, tc, x, y, mask, _ = _workload(seed=1)
    j_enc, params, t_enc = _models(seed=1)
    tx = optax.adam(1e-2)
    j_step = jtrain.make_node_classification_step(
        _ContextModel(j_enc, jc), tx, donate=False)
    state = jtrain.TrainState.create(params, tx, jax.random.PRNGKey(0))
    j_losses = []
    with pltpu.force_tpu_interpret_mode():
        for _ in range(3):
            state, loss = j_step(state, jnp.asarray(x), None, jnp.asarray(y),
                                 jnp.asarray(mask))
            j_losses.append(float(loss))
    t_step = make_node_classification_step(
        t_enc, torch.optim.Adam(t_enc.parameters(), lr=1e-2))
    args = _tensors(x, y, mask)
    t_losses = [float(t_step(args[0], None, *args[1:], context=tc))
                for _ in range(8)]
    # Adam divides by the gradient's root mean square, so the kernels' 1e-3
    # gradient differences show in the later losses: 1e-3 here.
    np.testing.assert_allclose(t_losses[:3], j_losses, rtol=0, atol=1e-3)
    assert abs(t_losses[0] - j_losses[0]) <= 1e-4
    assert t_losses[-1] < t_losses[0]


def test_context_encoder_equals_the_plain_edge_index_encoder():
    """The slice through the kernels' plain versions against the same model
    on the raw edge list (library segment ops, self-loops appended there)."""
    _, tc, x, _, _, ei = _workload(seed=2)
    _, params, t_enc = _models(seed=2)
    plain = kgt_torch.GAT(DIMS, heads=HEADS, input_dim=F_IN, device="cpu")
    plain.load_state_dict(convert.params_from_jax(params))
    xt = torch.from_numpy(x)
    a = t_enc(xt, context=tc)
    b = plain(xt, torch.from_numpy(ei))
    np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                               rtol=1e-5, atol=1e-5)


def test_step_drives_attention_dropout_through_the_generator():
    _, tc, x, y, mask, _ = _workload(seed=3)
    args = _tensors(x, y, mask)

    def first_loss(seed):
        _, _, enc = _models(seed=3, dropout_rate=0.2, attention_dropout=0.4)
        step = make_node_classification_step(
            enc, torch.optim.SGD(enc.parameters(), lr=0.0),
            generator=torch.Generator().manual_seed(seed))
        loss = float(step(args[0], None, *args[1:], context=tc))
        assert all(torch.isfinite(p.grad).all() for p in enc.parameters())
        return loss

    assert first_loss(1) == first_loss(1)
    assert first_loss(1) != first_loss(2)


def test_bf16_io_step_keeps_f32_masters_and_follows_the_f32_step():
    _, tc, x, y, mask, _ = _workload(seed=4)
    args = _tensors(x, y, mask)
    runs = {}
    for dtype in (None, torch.bfloat16):
        _, _, enc = _models(seed=4)
        step = make_node_classification_step(
            enc, torch.optim.SGD(enc.parameters(), lr=0.0),
            compute_dtype=dtype)
        loss = float(step(args[0], None, *args[1:], context=tc))
        assert all(p.dtype == p.grad.dtype == torch.float32
                   for p in enc.parameters())
        runs[dtype] = (loss, {k: p.grad for k, p in enc.named_parameters()})
    assert abs(runs[None][0] - runs[torch.bfloat16][0]) <= 5e-2
    for name, ref in runs[None][1].items():
        err = (runs[torch.bfloat16][1][name] - ref).abs().max().item()
        assert err <= 1e-1 * ref.abs().max().item(), name
