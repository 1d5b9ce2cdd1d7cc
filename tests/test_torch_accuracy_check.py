"""The port's hardware accuracy gate (``tools/accuracy_check_torch.py``) on the
CPU at a small size, where the context's kernels are their plain versions.

- The ``gcn_f32`` run's plain and kernel-path trajectories follow the JAX
  package's run of the reference tool's logic (``tools/accuracy_check.py``:
  ``community_graph``, ``prepare_graph``, ``GNNEncoder``, optax Adam) from the
  same parameters, carried across by ``convert.params_from_jax``: each logged
  loss within 1e-4 relative. The reference's trajectory is its plain (XLA)
  path, the yardstick of its own gate; its context path would run the Pallas
  kernels in interpret mode.
- The narrow GATv2 run in send mode (2 heads, widths 8 / 7) passes the gate.
- The gate fails where the kernel path's context has its edge weights scaled
  by 1.1 (the tool's control): the reference's limit can fail.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from keras_geometric_tpu.data.datasets.synthetic import (
    community_graph as j_community_graph,
)
from keras_geometric_tpu.models import GNNEncoder as JGNNEncoder
from keras_geometric_tpu.ops.csr import prepare_graph as j_prepare_graph
import chip_smoke
from keras_geometric_tpu_torch import convert
from keras_geometric_tpu_torch.ops import csr

torch.set_num_threads(1)

N, E, STEPS = 2_048, 16_384, 10
REL_TOL = 1e-4

tool = chip_smoke.accuracy_tool()


@pytest.fixture(scope="module")
def edges():
    ei = tool.community_edges(N, E)
    np.testing.assert_array_equal(ei, j_community_graph(N, 2 * (E // 2),
                                                        seed=0))
    return ei


def _jax_trajectory(ei, cfg):
    """The reference tool's plain path at this size: the losses at the
    logged steps and the final train accuracy, and its initial parameters."""
    x_np, y_np = tool.node_data(N, cfg.feats, cfg.classes)
    x, y = jnp.asarray(x_np), jnp.asarray(y_np.astype(np.int32))
    ctx = j_prepare_graph(ei, N, add_self_loops=True, gcn_normalize=True,
                          symmetric=True)
    enc = JGNNEncoder(conv="gcn", hidden_dims=cfg.dims, conv_kwargs=tuple(
        {"add_self_loops": False, "normalize": False}.items()))
    params0 = enc.init(jax.random.PRNGKey(0), cfg.feats)
    tx = optax.adam(cfg.lr)

    def forward(p):
        h = x
        layers = enc._layers()
        for i, layer in enumerate(layers):
            h = layer.apply(p[f"layer_{i}"], h, ctx.edge_index,
                            edge_weight=ctx.edge_weight)
            if i < len(layers) - 1:
                h = jax.nn.relu(h)
        return h

    def loss_fn(p):
        logp = jax.nn.log_softmax(forward(p).astype(jnp.float32))
        return jnp.mean(-jnp.take_along_axis(logp, y[:, None], axis=1)[:, 0])

    @jax.jit
    def step(p, opt_state):
        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, opt_state = tx.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, loss

    p, opt_state, losses = params0, tx.init(params0), []
    for i in range(STEPS):
        p, opt_state, loss = step(p, opt_state)
        if i in tool.logged_steps(STEPS):
            losses.append(float(loss))
    acc = float(jnp.mean(jnp.argmax(forward(p), -1) == y))
    return losses, acc, params0


def test_gcn_f32_trajectories_follow_the_jax_packages(edges):
    cfg = tool.RUNS["gcn_f32"]
    j_losses, j_acc, params0 = _jax_trajectory(edges, cfg)
    rec = tool.run_gate(cfg, steps=STEPS, device="cpu", edges=edges,
                        num_nodes=N,
                        initial_state=convert.params_from_jax(params0))
    assert rec["ok"], rec["faults"]
    assert rec["logged_steps"] == [0, 9]
    for path in ("losses_plain", "losses_kernel"):
        got = np.array(rec[path])
        np.testing.assert_allclose(got, j_losses, rtol=REL_TOL, atol=0)
    assert j_losses[-1] < 0.5 * j_losses[0]  # it trains
    assert abs(rec["acc_plain"] - j_acc) < tool.ACC_GAP_LIMIT
    assert abs(rec["acc_kernel"] - j_acc) < tool.ACC_GAP_LIMIT
    # On the CPU no kernel launches: both paths take the plain versions.
    assert rec["kernel_launches_per_step"] == {}
    assert rec["expected_launches_per_step"] == {}


def test_narrow_gatv2_send_mode_run_passes_the_gate(edges):
    cfg = dataclasses.replace(tool.RUNS["gat_send_products_widths"],
                              dims=(8, 7), heads=2)
    saved = csr.ATTEND_BWD_MODE, csr.ATTEND_SCORE_CACHE
    rec = tool.run_gate(cfg, steps=STEPS, device="cpu", edges=edges,
                        num_nodes=N)
    assert (csr.ATTEND_BWD_MODE, csr.ATTEND_SCORE_CACHE) == saved
    assert rec["ok"], rec["faults"]
    assert rec["io_dtype"] == "bfloat16"
    assert rec["max_rel_gap"] < tool.LOSS_GAP_LIMIT
    assert rec["losses_kernel"][-1] < rec["losses_kernel"][0]


def test_the_gate_fails_on_edge_weights_scaled_by_1_1(edges):
    cfg = tool.RUNS[tool.CONTROL_RUN]
    assert tool.CONTROL_WEIGHT_SCALE == 1.1
    rec = tool.run_gate(cfg, steps=STEPS, device="cpu", edges=edges,
                        num_nodes=N, kernel_weight_scale=1.1)
    assert not rec["ok"]
    assert rec["max_rel_gap"] >= tool.LOSS_GAP_LIMIT, rec
    assert any("relative loss gap" in f for f in rec["faults"])
    assert tool.control_caught(rec)
    # The same paths on the context as prepared pass.
    rec = tool.run_gate(cfg, steps=STEPS, device="cpu", edges=edges,
                        num_nodes=N)
    assert rec["ok"], rec["faults"]
    assert not tool.control_caught(rec)
