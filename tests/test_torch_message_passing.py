"""Port parity for the message-passing core: ``propagate`` (plain and
bipartite input, every hook, the empty and no-edge cases, masks),
``MessagePassing`` (its hooks and call convention), ``aggregate`` /
``available_aggregators`` and ``PoolingAggregator``, against the JAX
package's ``nn/message_passing.py`` and ``nn/aggregators.py``, forward and
gradient.

Tolerance 1e-5 relative and times the largest entry: both sides are f32
library ops in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import keras_geometric_tpu_torch as kgt_torch
from keras_geometric_tpu.nn import aggregators as jagg
from keras_geometric_tpu.nn import message_passing as jmp
from keras_geometric_tpu_torch import convert
from keras_geometric_tpu_torch.nn import aggregators as tagg
from keras_geometric_tpu_torch.nn import message_passing as tmp

torch.set_num_threads(1)

N, F = 10, 4


def _graph(seed, e=30):
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, N, e), rng.integers(0, N - 2, e)])
    x = rng.standard_normal((N, F)).astype(np.float32)
    mask = rng.random(e) > 0.2
    return ei.astype(np.int32), x, mask


def _close(got, want, what=""):
    want = np.asarray(want)
    assert np.array_equal(np.isnan(got), np.isnan(want)), what
    got, want = np.nan_to_num(got), np.nan_to_num(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale,
                               err_msg=what)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("aggregator", ["sum", "mean", "max", "min", "std"])
def test_propagate_matches_jax(aggregator, masked):
    ei, x, mask = _graph(len(aggregator))
    cot = np.random.default_rng(3).standard_normal((N, F)).astype(np.float32)
    kw_j = dict(aggregator=aggregator,
                edge_mask=jnp.asarray(mask) if masked else None)
    kw_t = dict(aggregator=aggregator,
                edge_mask=torch.from_numpy(mask) if masked else None)

    def j_loss(xx):
        out = jmp.propagate(xx, jnp.asarray(ei), **kw_j)
        return jnp.sum(out * cot), out

    (_, want), j_grad = jax.value_and_grad(j_loss, has_aux=True)(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = tmp.propagate(xt, torch.from_numpy(ei), **kw_t)
    (got * torch.from_numpy(cot)).sum().backward()
    _close(got.detach().numpy(), want, "forward")
    _close(xt.grad.numpy(), j_grad, "gradient")


def test_propagate_hooks_and_bipartite_input_match_jax():
    rng = np.random.default_rng(5)
    n_src, n_tgt, e = 9, 6, 25
    ei = np.stack([rng.integers(0, n_src, e),
                   rng.integers(0, n_tgt, e)]).astype(np.int32)
    xs = rng.standard_normal((n_src, F)).astype(np.float32)
    xt_np = rng.standard_normal((n_tgt, F)).astype(np.float32)
    ea = rng.standard_normal((e, F)).astype(np.float32)

    def hooks(lib):
        return dict(
            aggregator="sum",
            message_fn=lambda xi, xj, a: xi * xj + a,
            pre_aggregate_fn=lambda m: 2.0 * m,
            update_fn=lambda agg, xtg: agg - xtg,
            post_update_fn=lambda xtg, upd: upd * 0.5 + lib.tanh(xtg),
        )

    want = jmp.propagate((jnp.asarray(xt_np), jnp.asarray(xs)),
                         jnp.asarray(ei), edge_attr=jnp.asarray(ea),
                         **hooks(jnp))
    got = tmp.propagate((torch.from_numpy(xt_np), torch.from_numpy(xs)),
                        torch.from_numpy(ei), edge_attr=torch.from_numpy(ea),
                        **hooks(torch))
    assert got.shape == (n_tgt, F)
    _close(got.numpy(), want)
    # A custom aggregate_fn replaces the registry.
    custom = lambda m, r, n: jnp.zeros((n, m.shape[1])).at[r].add(m)
    want = jmp.propagate(jnp.asarray(xs), jnp.asarray(ei % n_tgt),
                         aggregate_fn=custom)
    got = tmp.propagate(
        torch.from_numpy(xs), torch.from_numpy(ei % n_tgt),
        aggregate_fn=lambda m, r, n: torch.zeros(n, m.shape[1]).index_add(
            0, r, m))
    _close(got.numpy(), want)


def test_propagate_empty_and_edgeless_graphs():
    x = np.ones((0, F), np.float32)
    ei = np.zeros((2, 0), np.int32)
    got = tmp.propagate(torch.from_numpy(x), torch.from_numpy(ei))
    assert got.shape == (0, F)
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    want = jmp.propagate(jnp.asarray(x), jnp.asarray(ei),
                         update_fn=lambda a, t: a + 1.0)
    got = tmp.propagate(torch.from_numpy(x), torch.from_numpy(ei),
                        update_fn=lambda a, t: a + 1.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got.any()  # zeros, and the update is not called


class _JMean(jmp.MessagePassing):
    def message(self, x_i, x_j, edge_attr=None):
        return x_j - 0.5 * x_i

    def update(self, aggregated, x=None):
        return aggregated + x


class _TMean(tmp.MessagePassing):
    def message(self, x_i, x_j, edge_attr=None):
        return x_j - 0.5 * x_i

    def update(self, aggregated, x=None):
        return aggregated + x


@pytest.mark.parametrize("aggregator", ["mean", "max"])
def test_message_passing_class_matches_jax(aggregator):
    ei, x, _ = _graph(9)
    want = _JMean(aggregator)([jnp.asarray(x), ei])
    got = _TMean(aggregator)([torch.from_numpy(x), ei])
    _close(got.numpy(), want)
    base = tmp.MessagePassing.from_config(
        tmp.MessagePassing(aggregator).get_config())
    assert base.aggregator == aggregator
    want = jmp.MessagePassing(aggregator)([jnp.asarray(x), ei, None])
    _close(base([torch.from_numpy(x), ei, None]).numpy(), want)
    with pytest.raises(ValueError, match="x, edge_index"):
        base([torch.from_numpy(x)])


def test_aggregate_registry_matches_jax():
    assert tagg.available_aggregators() == jagg.available_aggregators()
    assert list(tagg.AGGREGATORS) == list(jagg.AGGREGATORS)
    ei, x, mask = _graph(2)
    msgs = x[ei[0]]
    for name in tagg.AGGREGATORS:
        want = jagg.aggregate(name, jnp.asarray(msgs), jnp.asarray(ei[1]), N,
                              mask=jnp.asarray(mask))
        got = kgt_torch.aggregate(name, torch.from_numpy(msgs),
                                  torch.from_numpy(ei[1]), N,
                                  mask=torch.from_numpy(mask))
        _close(got.numpy(), want, name)
    with pytest.raises(ValueError, match="Invalid aggregator"):
        tagg.aggregate("pooling", torch.from_numpy(msgs),
                       torch.from_numpy(ei[1]), N)


@pytest.mark.parametrize("activation", ["relu", None])
def test_pooling_aggregator_matches_jax(activation):
    ei, x, mask = _graph(4)
    msgs = x[ei[0]]
    j_pool = jagg.PoolingAggregator(6, activation=activation)
    params = j_pool.init(jax.random.PRNGKey(1), F)
    params["mlp"]["bias"] = params["mlp"]["bias"] - 0.2  # rows tied at 0
    t_pool = kgt_torch.PoolingAggregator(6, input_dim=F,
                                         activation=activation, device="cpu")
    t_pool.load_state_dict(convert.params_from_jax(params))
    cot = np.random.default_rng(6).standard_normal((N, 6)).astype(np.float32)

    def j_loss(p, m):
        out = j_pool.apply(p, m, jnp.asarray(ei[1]), N,
                           mask=jnp.asarray(mask))
        return jnp.sum(out * cot), out

    (_, want), (j_gp, j_gm) = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(msgs))
    m = torch.from_numpy(msgs).requires_grad_()
    got = t_pool(m, torch.from_numpy(ei[1]), N, mask=torch.from_numpy(mask))
    (got * torch.from_numpy(cot)).sum().backward()
    _close(got.detach().numpy(), want, "forward")
    _close(m.grad.numpy(), j_gm, "d messages")
    _close(t_pool.mlp.kernel.grad.numpy(), j_gp["mlp"]["kernel"], "d kernel")
    _close(t_pool.mlp.bias.grad.numpy(), j_gp["mlp"]["bias"], "d bias")
