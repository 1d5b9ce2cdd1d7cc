"""Port parity for graph-minibatch data parallelism on ``torch.distributed``
(``parallel/data_parallel.py``): ``stack_padded_batches`` and
``make_dp_graph_classifier_step`` over a ``gloo`` group of CPU processes at
world sizes 2 and 4, against the JAX package's on a mesh of as many host CPU
devices.

Cases: four padded buckets a step (``batch_graphs_padded``, 128 nodes / 256
edges, three synthetic graphs of 10-12 nodes each plus the dummy, 6
features, 3 classes: the reference test's generator), so a rank keeps two
buckets at world 2 and one at world 4; ``GraphClassifier(GIN((16, 16)), 3,
readout="mean")`` with the reference's weights (``convert.params_from_jax``);
Adam 1e-2:

- each rank's stacked fields equal its rows of the reference's stacked
  arrays, bit for bit, with the same fields left out;
- three steps: every rank's losses against the reference's step (the global
  mean over every rank's labelled slots) within ``rtol=1e-5, atol=1e-5``
  (the third loss is near 0.04), and the
  parameters after them within ``rtol=2e-4, atol=2e-5`` of the reference's
  and equal bit for bit on every rank;
- no dropout is drawn (the reference applies the model with
  ``training=False``): an encoder with ``dropout_rate=0.5`` gives the same
  loss as without it;
- the error paths: no bucket, a bucket count the ranks do not divide,
  buckets of different shapes.

The ranks import torch and the port only (``torch_ranks``); JAX and the
reference are imported inside the parent's fixtures and tests.
"""

import numpy as np
import pytest
import torch

from torch_ranks import run_ranks

torch.set_num_threads(1)

WORLDS = (2, 4)
BUCKETS, GRAPHS_PER_BUCKET, F_IN, CLASSES, HIDDEN = 4, 3, 6, 3, (16, 16)
NODE_BUCKET, EDGE_BUCKET = 128, 256
STEPS, LR = 3, 1e-2
FIELDS = ("x", "senders", "receivers", "edge_mask", "node_mask", "batch")


def _bucket_graphs(seed, synthetic_graph):
    """The graphs of the step's buckets and their labels, ``-1`` on the
    dummy graph's slot (the reference test's ``make_buckets``)."""
    rng = np.random.default_rng(seed)
    buckets, ys = [], []
    for _ in range(BUCKETS):
        gs, y = [], np.full(GRAPHS_PER_BUCKET + 1, -1, np.int64)
        for i in range(GRAPHS_PER_BUCKET):
            c = int(rng.integers(CLASSES))
            g = synthetic_graph(10 + c, 30, F_IN,
                                seed=int(rng.integers(1 << 31)))
            g.x[:, c] += 2.0
            gs.append(g)
            y[i] = c
        buckets.append(gs)
        ys.append(y)
    return buckets, np.stack(ys)


# ---------------------------------------------------------------------------
# What every rank runs.
# ---------------------------------------------------------------------------


def dp_ranks(rank, world, *, params):
    from keras_geometric_tpu_torch import convert
    from keras_geometric_tpu_torch import parallel as par
    from keras_geometric_tpu_torch.data.datasets import synthetic_graph
    from keras_geometric_tpu_torch.models import GIN, GraphClassifier
    from keras_geometric_tpu_torch.utils import batch_graphs_padded

    mesh = par.make_mesh((world,), ("data",), device_type="cpu")
    m = BUCKETS // world

    def padded(seed, node_bucket=NODE_BUCKET):
        buckets, ys = _bucket_graphs(seed, synthetic_graph)
        return [batch_graphs_padded(gs, node_bucket=node_bucket,
                                    edge_bucket=EDGE_BUCKET, device="cpu")
                for gs in buckets], ys

    def model(dropout_rate=0.0):
        encoder = GIN(HIDDEN, input_dim=F_IN, dropout_rate=dropout_rate,
                      device="cpu")
        out = GraphClassifier(encoder, CLASSES, readout="mean", device="cpu")
        out.load_state_dict(convert.params_from_jax(params))
        return out

    def data_of(seed):
        graphs, ys = padded(seed)
        data = par.stack_padded_batches(graphs, mesh)
        data["y"] = torch.from_numpy(ys[rank * m:(rank + 1) * m])
        return data

    out = {"stacked": {k: v.numpy() for k, v in data_of(0).items()}}
    net = model()
    step = par.make_dp_graph_classifier_step(
        net, torch.optim.Adam(net.parameters(), lr=LR), mesh,
        GRAPHS_PER_BUCKET + 1)
    out["losses"] = [step(data_of(i)).item() for i in range(STEPS)]
    out["params"] = {k: p.detach().numpy().copy()
                     for k, p in net.named_parameters()}

    # No dropout drawn: the same loss with the encoder's dropout on.
    data = data_of(0)
    out["dropout_losses"] = []
    for rate in (0.0, 0.5, 0.5):
        net = model(rate)
        step = par.make_dp_graph_classifier_step(
            net, torch.optim.SGD(net.parameters(), lr=0.0), mesh,
            GRAPHS_PER_BUCKET + 1)
        out["dropout_losses"].append(step(data).item())

    errors = {}
    graphs, _ = padded(0)
    for name, arg in (("indivisible", graphs[:3]),
                      ("shapes", graphs[:-1] + padded(
                          0, node_bucket=2 * NODE_BUCKET)[0][-1:])):
        try:
            par.stack_padded_batches(arg, mesh)
            errors[name] = None
        except ValueError as err:
            errors[name] = str(err)
    out["errors"] = errors
    return out


# ---------------------------------------------------------------------------
# The parent: the reference's step, and the checks.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference():
    """The reference's weights, and its stacked arrays for the first step's
    buckets."""
    import jax

    from keras_geometric_tpu.data.datasets import synthetic_graph
    from keras_geometric_tpu.models import GIN, GraphClassifier
    from keras_geometric_tpu.utils.data_utils import batch_graphs_padded

    model = GraphClassifier(encoder=GIN(HIDDEN), num_classes=CLASSES,
                            readout="mean")
    params = model.init(jax.random.PRNGKey(0), F_IN)
    buckets = [batch_graphs_padded(gs, node_bucket=NODE_BUCKET,
                                   edge_bucket=EDGE_BUCKET)
               for gs in _bucket_graphs(0, synthetic_graph)[0]]
    stacked = {f: np.stack([np.asarray(getattr(b, f)) for b in buckets])
               for f in FIELDS}
    return model, jax.tree_util.tree_map(np.asarray, params), stacked


def _reference_run(reference, world):
    """The reference's step on a mesh of ``world`` host CPU devices: the
    losses of ``STEPS`` steps and the parameters after them."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from keras_geometric_tpu.data.datasets import synthetic_graph
    from keras_geometric_tpu.parallel import make_mesh
    from keras_geometric_tpu.parallel.data_parallel import (
        make_dp_graph_classifier_step,
        stack_padded_batches,
    )
    from keras_geometric_tpu.training import TrainState
    from keras_geometric_tpu.utils.data_utils import batch_graphs_padded

    model, params, _ = reference
    mesh = make_mesh((world,), ("data",), devices=jax.devices()[:world])
    tx = optax.adam(LR)
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, params),
                              tx, jax.random.PRNGKey(1))
    step = make_dp_graph_classifier_step(model, tx, mesh,
                                         GRAPHS_PER_BUCKET + 1)
    losses = []
    for i in range(STEPS):
        buckets, ys = _bucket_graphs(i, synthetic_graph)
        data = stack_padded_batches(
            [batch_graphs_padded(gs, node_bucket=NODE_BUCKET,
                                 edge_bucket=EDGE_BUCKET) for gs in buckets],
            mesh)
        data["y"] = jax.device_put(jnp.asarray(ys, jnp.int32),
                                   NamedSharding(mesh, P("data")))
        state, loss = step(state, data)
        losses.append(float(loss))
    return losses, jax.tree_util.tree_map(np.asarray, state.params)


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def ranks(request, reference, tmp_path_factory):
    world = request.param
    results = run_ranks(dp_ranks, world,
                        tmp_path_factory.mktemp(f"dp_world{world}"),
                        timeout=240, params=reference[1])
    return world, results, _reference_run(reference, world)


def test_each_rank_keeps_its_rows_of_the_stacked_buckets(ranks, reference):
    import jax

    from keras_geometric_tpu.data.datasets import synthetic_graph
    from keras_geometric_tpu.parallel import make_mesh
    from keras_geometric_tpu.parallel.data_parallel import (
        stack_padded_batches,
    )
    from keras_geometric_tpu.utils.data_utils import batch_graphs_padded

    world, results, _ = ranks
    m = BUCKETS // world
    # The reference leaves out the same fields (here: y, which the buckets'
    # graphs do not carry at graph level).
    ref_keys = set(stack_padded_batches(
        [batch_graphs_padded(gs, node_bucket=NODE_BUCKET,
                             edge_bucket=EDGE_BUCKET)
         for gs in _bucket_graphs(0, synthetic_graph)[0]],
        make_mesh((world,), ("data",), devices=jax.devices()[:world])))
    for rank, r in enumerate(results):
        got = r["stacked"]
        assert set(got) - {"y"} == ref_keys - {"y"}
        for field in FIELDS:
            want = reference[2][field][rank * m:(rank + 1) * m]
            assert got[field].shape == want.shape
            np.testing.assert_array_equal(got[field], want, err_msg=field)


def test_dp_steps_match_the_reference_step(ranks):
    from keras_geometric_tpu_torch import convert

    world, results, (want_losses, want_params) = ranks
    want = {k: v.numpy() for k, v in
            convert.params_from_jax(want_params).items()}
    for r in results:
        np.testing.assert_allclose(r["losses"], want_losses, rtol=1e-5,
                                   atol=1e-5)
        assert set(r["params"]) == set(want)
        for key, p in r["params"].items():
            np.testing.assert_allclose(p, want[key], rtol=2e-4, atol=2e-5,
                                       err_msg=key)
    for r in results[1:]:  # replicated: equal on every rank
        assert r["losses"] == results[0]["losses"]
        for key, p in r["params"].items():
            np.testing.assert_array_equal(p, results[0]["params"][key])
    assert results[0]["losses"][-1] < results[0]["losses"][0]


def test_dp_step_draws_no_dropout(ranks):
    _, results, _ = ranks
    for r in results:
        plain, *dropped = r["dropout_losses"]
        assert dropped == [plain, plain]


def test_stack_padded_batches_error_paths(ranks):
    from keras_geometric_tpu.parallel.data_parallel import (
        stack_padded_batches as r_stack,
    )

    from keras_geometric_tpu_torch.parallel import stack_padded_batches

    world, results, _ = ranks
    with pytest.raises(ValueError, match="at least one"):
        stack_padded_batches([], None)
    with pytest.raises(ValueError, match="at least one"):
        r_stack([], None)
    for r in results:
        assert r["errors"]["indivisible"] == (
            f"3 buckets do not divide over the {world} ranks of axis 'data'")
        assert r["errors"]["shapes"] == (
            "buckets differ in the shape of 'x'")
