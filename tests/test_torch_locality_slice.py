"""Port parity for the locality tier as a whole: one GCN training step on a
``band_window`` context and one GATv2 step on an ``attend_window`` context,
both on a small scrambled community graph relabelled by the LPA cluster order
(the JAX package's skewed benchmark workload at a small size), against the
JAX package's step with the same converted weights (Pallas kernels in
interpret mode, the whole ``jax.grad`` inside it).

Tolerances: GCN loss 1e-4 and gradients 1e-4 (the reference's ``spmm``
parity bound); GATv2 loss 1e-4 and gradients rtol 1e-3 / atol 3e-3 (the
reference's f32 attention kernels split operands into two bf16 passes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import keras_geometric_tpu_torch as kgt_torch
from keras_geometric_tpu.models import GNNEncoder as JGNNEncoder
from keras_geometric_tpu.ops.csr import prepare_graph as j_prepare
from keras_geometric_tpu.training import train as jtrain
from keras_geometric_tpu_torch import convert
from keras_geometric_tpu_torch.data.datasets import community_graph
from keras_geometric_tpu_torch.kernels import band_cuda
from keras_geometric_tpu_torch.ops import reorder
from keras_geometric_tpu_torch.training import make_node_classification_step

torch.set_num_threads(1)

CONTEXT = dict(rtol=1e-4, atol=1e-4)
ATTEND_GRAD = dict(rtol=1e-3, atol=3e-3)


F_IN, CLASSES = 8, 4


@pytest.fixture(scope="module")
def reordered():
    """bench.py's skewed workload at a small size: a scrambled community
    graph, LPA cluster order, features and labels relabelled with it."""
    n = 1_024
    ei = community_graph(n, 6_000, community_size=128, seed=0)
    s, r = ei[0].astype(np.int64), ei[1].astype(np.int64)
    order = reorder.cluster_order(s, r, n)
    inv = reorder.invert_order(order)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, F_IN)).astype(np.float32)[order]
    y = rng.integers(0, CLASSES, n).astype(np.int32)[order]
    mask = rng.random(n) < 0.6
    return n, np.stack([inv[s], inv[r]]).astype(np.int32), x, y, mask


def _padded(n_pad, x, y, mask):
    n = x.shape[0]
    xp = np.zeros((n_pad, x.shape[1]), np.float32)
    xp[:n] = x
    yp = np.zeros(n_pad, np.int32)
    yp[:n] = y
    mp = np.zeros(n_pad, bool)
    mp[:n] = mask
    return xp, yp, mp


def _step_against_jax(j_enc, params, t_enc, jc, tc, x, y, mask):
    def j_loss(p):
        logits = j_enc.apply(p, jnp.asarray(x), context=jc)
        return jtrain.masked_softmax_cross_entropy(
            logits, jnp.asarray(y), jnp.asarray(mask))

    with pltpu.force_tpu_interpret_mode():
        ref_loss, ref_grads = jax.value_and_grad(j_loss)(params)
    step = make_node_classification_step(
        t_enc, torch.optim.SGD(t_enc.parameters(), lr=0.0))
    loss = float(step(torch.from_numpy(x), None, torch.from_numpy(y),
                      torch.from_numpy(mask), context=tc))
    return loss, float(ref_loss), ref_grads


def test_gcn_step_on_a_band_context_matches_jax(reordered):
    n, ei, x, y, mask = reordered
    kw = dict(add_self_loops=True, gcn_normalize=True, symmetric=True,
              densify_self_loops=True, pad_nodes=True, band_window=512,
              attend_full_stream=False)
    tc = kgt_torch.prepare_graph(ei, n, device="cpu", **kw)
    jc = j_prepare(ei, n, **kw)
    assert tc.num_band_edges > tc.num_real_edges  # the band holds most
    x, y, mask = _padded(tc.num_nodes, x, y, mask)
    j_enc = JGNNEncoder.for_context("gcn", (16, CLASSES))
    params = j_enc.init(jax.random.PRNGKey(0), F_IN)
    t_enc = kgt_torch.GNNEncoder.for_context("gcn", (16, CLASSES),
                                             input_dim=F_IN, device="cpu")
    t_enc.load_state_dict(convert.params_from_jax(params))
    band_cuda.reset_launch_counts()
    loss, ref_loss, ref_grads = _step_against_jax(j_enc, params, t_enc, jc,
                                                  tc, x, y, mask)
    assert abs(loss - ref_loss) <= 1e-4
    for name, p in t_enc.named_parameters():
        layer, leaf = name.split(".")
        np.testing.assert_allclose(p.grad.numpy(),
                                   np.asarray(ref_grads[layer][leaf]),
                                   err_msg=name, **CONTEXT)
    assert not any(band_cuda.LAUNCH_COUNTS.values())


def test_gat_step_on_a_window_context_matches_jax(reordered):
    n, ei, x, y, mask = reordered
    kw = dict(add_self_loops=True, edge_chunk=512, pad_nodes=True,
              attend_window=256)
    tc = kgt_torch.prepare_graph(ei, n, device="cpu", **kw)
    jc = j_prepare(ei, n, **kw)
    assert tc.senders.shape[0] % 2048 == 0
    assert tc.attw_plan.num_band_edges > 0.5 * tc.num_real_edges
    x, y, mask = _padded(tc.num_nodes, x, y, mask)
    conv_kwargs = {"heads": 2}
    j_enc = JGNNEncoder.for_context("gatv2", (8, CLASSES),
                                    conv_kwargs=conv_kwargs)
    params = j_enc.init(jax.random.PRNGKey(1), F_IN)
    t_enc = kgt_torch.GNNEncoder.for_context(
        "gatv2", (8, CLASSES), input_dim=F_IN, conv_kwargs=conv_kwargs,
        device="cpu")
    t_enc.load_state_dict(convert.params_from_jax(params))
    loss, ref_loss, ref_grads = _step_against_jax(j_enc, params, t_enc, jc,
                                                  tc, x, y, mask)
    assert abs(loss - ref_loss) <= 1e-4
    for name, p in t_enc.named_parameters():
        layer, leaf = name.split(".")
        np.testing.assert_allclose(
            p.grad.numpy(), np.asarray(ref_grads[layer][leaf]).reshape(
                p.shape), err_msg=name, **ATTEND_GRAD)
