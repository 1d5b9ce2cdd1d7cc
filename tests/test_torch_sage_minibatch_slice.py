"""Port parity for the neighbour-sampled GraphSAGE minibatch slice: the same
sampled buckets and the same converted weights go through the JAX package's
``make_sage_minibatch_step`` (XLA segment ops) and the port's (its library-op
segment ops: no hand-written kernel lies on this path).

Tolerances, f32: step-1 logits and loss 1e-5, gradients 1e-4 of their
largest entry, the losses of five Adam steps 1e-4.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from keras_geometric_tpu.data import sampling as jsampling
from keras_geometric_tpu.nn.sage_conv import SAGEConv as JSAGEConv
from keras_geometric_tpu.training import TrainState as JTrainState
from keras_geometric_tpu.training import sage_minibatch as jsage
from keras_geometric_tpu.training.train import masked_softmax_cross_entropy
from keras_geometric_tpu_torch import convert
from keras_geometric_tpu_torch.data import sampling as tsampling
from keras_geometric_tpu_torch.data.datasets import synthetic_planetoid
from keras_geometric_tpu_torch.nn.sage_conv import SAGEConv
from keras_geometric_tpu_torch.training import sage_minibatch as tsage

torch.set_num_threads(1)

N, F_IN, HIDDEN, CLASSES = 150, 9, 12, 4
FANOUTS, BATCH = (5, 3), 16


def _graph(seed=0):
    rng = np.random.default_rng(seed)
    r = np.concatenate([rng.integers(0, N - 10, 700), rng.integers(0, 3, 60)])
    ei = np.stack([rng.integers(0, N, r.shape[0]), r]).astype(np.int32)
    x = rng.standard_normal((N, F_IN)).astype(np.float32)
    y = rng.integers(0, CLASSES, N).astype(np.int32)
    return ei, x, y


def _buckets(count, seed=0):
    ei, x, y = _graph(seed)
    sampler = jsampling.NeighborSampler(ei, N, FANOUTS, seed=seed)
    subs = list(sampler.epoch(np.arange(N), BATCH))[:count]
    return subs, x, y


def _layers(aggregator, seed):
    ref = (JSAGEConv(output_dim=HIDDEN, aggregator=aggregator),
           JSAGEConv(output_dim=CLASSES, activation=None,
                     aggregator=aggregator))
    k0, k1 = jax.random.split(jax.random.PRNGKey(seed))
    params = {"layer_0": ref[0].init(k0, F_IN),
              "layer_1": ref[1].init(k1, HIDDEN)}
    port = (SAGEConv(HIDDEN, input_dim=F_IN, aggregator=aggregator,
                     device="cpu"),
            SAGEConv(CLASSES, input_dim=HIDDEN, activation=None,
                     aggregator=aggregator, device="cpu"))
    for i, layer in enumerate(port):
        layer.load_state_dict(convert.params_from_jax(params[f"layer_{i}"]))
    return ref, params, port


def _close(got, want, tol, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-12) if tol[1] else 1.0
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol[0] * scale, (what, err, scale)


@pytest.mark.parametrize("aggregator", ["mean", "pooling"])
def test_step_one_matches_reference(aggregator):
    (sub,), x, y = _buckets(1)
    ref_layers, params, port_layers = _layers(aggregator, seed=3)
    jdata = jsage.subgraph_to_arrays(sub, x, y)
    tdata = tsage.subgraph_to_arrays(sub, x, y, device="cpu")
    tx = optax.sgd(0.0)
    j_step, j_infer = jsage.make_sage_minibatch_step(ref_layers, CLASSES, tx,
                                                     donate=False)
    opt = torch.optim.SGD([p for l in port_layers for p in l.parameters()],
                          lr=0.0)
    t_step, t_infer = tsage.make_sage_minibatch_step(port_layers, CLASSES, opt)

    _close(t_infer(tdata), j_infer(params, jdata), (1e-5, False), "logits")
    state = JTrainState.create(params, tx, jax.random.PRNGKey(0))
    _, j_loss = j_step(state, jdata)
    t_loss = t_step(tdata)
    assert t_loss.shape == () and not t_loss.requires_grad
    assert abs(float(t_loss) - float(j_loss)) <= 1e-5

    def loss_of(p):  # the reference step's loss, for its gradients
        logits = j_infer(p, jdata)[:BATCH]
        return masked_softmax_cross_entropy(logits, jdata["y_seed"],
                                            jdata["seed_mask"])

    grads = convert.params_to_numpy({
        f"layer_{i}.{k}": p.grad for i, l in enumerate(port_layers)
        for k, p in l.named_parameters()})
    want = jax.grad(loss_of)(params)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat_want) == sum(1 for l in port_layers
                                 for _ in l.parameters())
    for path, leaf in flat_want:
        node = grads
        for key in path:
            node = node[key.key]
        _close(node, leaf, (1e-4, True), jax.tree_util.keystr(path))


@pytest.mark.parametrize("aggregator", ["mean", "pooling"])
def test_five_adam_steps_match_reference(aggregator):
    subs, x, y = _buckets(5, seed=1)
    ref_layers, params, port_layers = _layers(aggregator, seed=4)
    tx = optax.adam(0.01)
    j_step, _ = jsage.make_sage_minibatch_step(ref_layers, CLASSES, tx,
                                               donate=False)
    state = JTrainState.create(params, tx, jax.random.PRNGKey(0))
    opt = torch.optim.Adam([p for l in port_layers for p in l.parameters()],
                           lr=0.01)
    t_step, _ = tsage.make_sage_minibatch_step(port_layers, CLASSES, opt)
    j_losses, t_losses = [], []
    for sub in subs:
        state, loss = j_step(state, jsage.subgraph_to_arrays(sub, x, y))
        j_losses.append(float(loss))
        t_losses.append(float(t_step(
            tsage.subgraph_to_arrays(sub, x, y, device="cpu"))))
    np.testing.assert_allclose(t_losses, j_losses, rtol=0, atol=1e-4)


def test_subgraph_to_arrays_is_the_same_from_numpy_and_from_tensors(tmp_path):
    (sub,), x, y = _buckets(1)
    np.save(tmp_path / "x.npy", x)
    x_map = np.load(tmp_path / "x.npy", mmap_mode="r")  # read-only
    from_numpy = tsage.subgraph_to_arrays(sub, x_map, y, device="cpu")
    from_tensors = tsage.subgraph_to_arrays(
        sub, torch.from_numpy(x), torch.from_numpy(y))
    ref = jsage.subgraph_to_arrays(sub, x, y)
    for key in ("x", "y_seed", "seed_mask"):
        a, b = from_numpy[key], from_tensors[key]
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b), key
        np.testing.assert_array_equal(a.numpy(), np.asarray(ref[key]))
    for la, lb, lr in zip(from_numpy["layers"], from_tensors["layers"],
                          ref["layers"]):
        for a, b, r in zip(la, lb, lr):
            assert torch.equal(a, b)
            np.testing.assert_array_equal(a.numpy(), np.asarray(r))
    real = int(sub.node_mask.sum())
    assert not from_tensors["x"][real:].any()  # padded rows are zero


def test_minibatch_step_uses_the_library_segment_ops_only():
    """No kernel wrapper is reached, and the flag the reference passes does
    not route the unsorted padded edges to a sorted-CSR kernel."""
    from keras_geometric_tpu_torch.kernels import _build, spmm_cuda

    spmm_cuda.reset_launch_counts()
    subs, x, y = _buckets(2)
    _, _, port_layers = _layers("pooling", seed=0)
    opt = torch.optim.Adam([p for l in port_layers for p in l.parameters()])
    step, infer = tsage.make_sage_minibatch_step(port_layers, CLASSES, opt)
    for sub in subs:
        data = tsage.subgraph_to_arrays(sub, x, y, device="cpu")
        r = data["layers"][1][1]
        assert bool((r[1:] < r[:-1]).any())  # padding trails: not sorted
        step(data)
    assert infer(data).shape == (subs[0].node_map.shape[0], CLASSES)
    assert not any(spmm_cuda.LAUNCH_COUNTS.values())
    assert _build.load_library.cache_info().currsize == 0


def test_training_converges():
    """The reference's convergence test, run on the port."""
    g = synthetic_planetoid("cora", seed=5)
    keep = 600
    sel = (g.edge_index[0] < keep) & (g.edge_index[1] < keep)
    ei = g.edge_index[:, sel]
    x, y = g.x[:keep, :64], g.y[:keep]
    c = int(y.max()) + 1
    sampler = tsampling.NeighborSampler(ei, keep, (10, 5), seed=0)
    gen = torch.Generator().manual_seed(0)
    layers = (SAGEConv(32, input_dim=64, generator=gen, device="cpu"),
              SAGEConv(c, input_dim=32, activation=None, generator=gen,
                       device="cpu"))
    opt = torch.optim.Adam([p for l in layers for p in l.parameters()],
                           lr=0.01)
    step, _ = tsage.make_sage_minibatch_step(layers, c, opt)
    x_t, y_t = torch.from_numpy(x), torch.from_numpy(y)
    losses = []
    for _ in range(6):
        for sub in sampler.epoch(np.arange(keep), batch_size=64):
            losses.append(float(step(tsage.subgraph_to_arrays(sub, x_t,
                                                              y_t))))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) * 0.8, (
        losses[:5], losses[-5:])
