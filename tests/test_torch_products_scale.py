"""The port at ogbn-products scale, on the CPU.

- ``chip_smoke.py``'s plain versions in blocks (``PlainContext(ctx,
  block_slots=...)``: ``spmm`` and ``attend`` over runs of whole receiver
  rows, each block under ``torch.utils.checkpoint``), which the card's
  products runs hold step 1 against because no ``[E, F]`` array of that
  graph fits whole: here, on a few hundred nodes in blocks of 64 slots,
  against the unblocked plain versions. The forward is the same arithmetic
  row by row, so the logits and the loss are equal bit for bit; the
  gradients add the blocks' parts in another order: within 1e-6 of their
  largest entry in f32, and in bf16 IO within one bf16 unit (2**-7) of it
  (an intermediate cotangent summed in another order may round to the
  neighbouring bf16 value). ``attend_case`` in blocks, the check the
  card's products phase holds the attention kernels with, against the
  same check unblocked.
- The twin of the reference's tier-1 products test
  (``tests/test_products_scale.py``): ``partition_graph`` and
  ``build_kernel_plan`` at 1/8 of ogbn-products (306,128 nodes, 15,464,785
  random edges from seed 0) under the same 120 s budget.
- Step 1 at the products widths on a small graph against the JAX package
  (Pallas kernels in interpret mode): the GCN 100 -> 256 -> 47, whose first
  layer propagates first at F = 100, and the send-mode GATv2 4 x (64, 47),
  both in f32. The loss is held to 1e-4, the slices' limit. Each gradient is
  held to a share of its own largest entry, since the entries are small here
  (largest 3.4e-3 to 6.1e-2): 1e-4 for the GCN, the GCN slice's number, and
  1e-3 for the GATv2, whose attention gradients add more terms per entry
  (seen: at most 2.0e-6 and 4.0e-5 of the largest entry). Each test also
  shows that its limit has teeth: step 1 at weights scaled by 1.01 fails it.
"""

import copy
import importlib.util
import pathlib
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import keras_geometric_tpu_torch as kgt_torch
from keras_geometric_tpu.models import GNNEncoder as JGNNEncoder
from keras_geometric_tpu.ops import csr as j_csr
from keras_geometric_tpu.training import train as jtrain
from keras_geometric_tpu_torch import convert
from keras_geometric_tpu_torch.ops import csr as t_csr
from keras_geometric_tpu_torch.parallel import (
    build_kernel_plan,
    partition_graph,
)
from keras_geometric_tpu_torch.training import make_node_classification_step

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PRODUCTS_N, PRODUCTS_E = 2_449_029, 123_718_280
F_IN, HIDDEN, CLASSES = 100, 256, 47  # ogbn-products' widths
GAT_DIMS, GAT_HEADS = (64, CLASSES), 4
BLOCK_SLOTS = 64
GCN_GRAD_TOL, GAT_GRAD_TOL = 1e-4, 1e-3  # of each leaf's largest entry
GCN_PREPARE = dict(add_self_loops=True, gcn_normalize=True, symmetric=True,
                   densify_self_loops=True, pad_nodes=True)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _gcn_graph(seed=0, n=300, half=2_000):
    """A symmetric random graph of a few hundred nodes, as ogbn-products'
    stand-in is built (both directions of each pair)."""
    rng = np.random.default_rng(seed)
    a, b = rng.integers(0, n, half), rng.integers(0, n, half)
    ei = np.stack([np.concatenate([a, b]), np.concatenate([b, a])])
    return ei.astype(np.int32), n


def _gat_graph(seed=0, n=300, e=3_000):
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    return ei.astype(np.int32), n


def _node_data(n_pad, n, seed):
    rng = np.random.default_rng(seed)
    x = np.zeros((n_pad, F_IN), np.float32)
    x[:n] = rng.standard_normal((n, F_IN))
    y = np.zeros(n_pad, np.int64)
    y[:n] = rng.integers(0, CLASSES, n)
    mask = (np.arange(n_pad) < n) & (rng.random(n_pad) < 0.6)
    return torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(mask)


def _gcn_model():
    return kgt_torch.GNNEncoder.for_context(
        "gcn", (HIDDEN, CLASSES), input_dim=F_IN,
        generator=torch.Generator().manual_seed(0), device="cpu")


def _gat_model():
    return kgt_torch.GNNEncoder.for_context(
        "gatv2", GAT_DIMS, input_dim=F_IN, conv_kwargs={"heads": GAT_HEADS},
        generator=torch.Generator().manual_seed(0), device="cpu")


def _step1(make_model, ctx, x, y, mask, dtype):
    """Logits, loss and gradients of step 1 through the training entry point
    (an optimizer that leaves the parameters where they are)."""
    model = make_model()
    cast = model if dtype is None else copy.deepcopy(model).to(dtype)
    logits = cast(x.to(dtype or torch.float32), context=ctx).detach()
    step = make_node_classification_step(
        model, torch.optim.SGD(model.parameters(), lr=0.0),
        compute_dtype=dtype)
    loss = float(step(x, None, y, mask, context=ctx))
    return logits, loss, {k: p.grad.clone()
                          for k, p in model.named_parameters()}


def _assert_blocked_equals_whole(make_model, ctx, x, y, mask, dtype):
    smoke = _chip_smoke()
    whole = smoke.PlainContext(ctx)
    blocked = smoke.PlainContext(ctx, block_slots=BLOCK_SLOTS)
    w_logits, w_loss, w_grads = _step1(make_model, whole, x, y, mask, dtype)
    b_logits, b_loss, b_grads = _step1(make_model, blocked, x, y, mask, dtype)
    # The graph really is cut: more than ten blocks.
    assert [len(b) > 10 for b in blocked.blocks.values()] == [True]
    assert torch.equal(b_logits, w_logits)
    assert b_loss == w_loss
    assert set(b_grads) == set(w_grads)
    # bf16 IO: a cotangent summed in another order may round to the
    # neighbouring bf16 value, a unit of 2**-7, before it is used further.
    tol = 1e-6 if dtype is None else 2.0 ** -7
    for name, want in w_grads.items():
        scale = want.abs().max().item()
        assert scale > 0, name
        err = (b_grads[name] - want).abs().max().item()
        assert err <= tol * scale, (name, err, scale)


def test_row_blocks_cover_every_row_in_runs_of_whole_rows():
    smoke = _chip_smoke()
    lengths = np.array([3, 0, 70, 5, 5, 0, 0, 64, 1, 0])
    row_ptr = torch.from_numpy(np.concatenate([[0], np.cumsum(lengths)]))
    blocks = smoke.row_blocks(row_ptr.to(torch.int32), 64)
    assert blocks == [(0, 2, 0, 3), (2, 3, 3, 73), (3, 7, 73, 83),
                      (7, 8, 83, 147), (8, 10, 147, 148)]


@pytest.mark.parametrize("dtype", [None, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_blocked_plain_gcn_step_equals_the_whole_one(dtype):
    ei, n = _gcn_graph()
    ctx = kgt_torch.prepare_graph(ei, n, device="cpu", **GCN_PREPARE)
    if dtype is not None:
        ctx = ctx.with_weight_dtype(dtype)
    x, y, mask = _node_data(ctx.num_nodes, n, seed=1)
    _assert_blocked_equals_whole(_gcn_model, ctx, x, y, mask, dtype)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_blocked_plain_gat_send_step_equals_the_whole_one(dtype,
                                                          monkeypatch):
    monkeypatch.setattr(t_csr, "ATTEND_BWD_MODE", "send")
    ei, n = _gat_graph()
    ctx = kgt_torch.prepare_graph(ei, n, add_self_loops=True, edge_chunk=64,
                                  device="cpu")
    assert ctx.edge_mask_ss is not None  # padded slots in the last row
    x, y, mask = _node_data(n, n, seed=2)
    _assert_blocked_equals_whole(_gat_model, ctx, x, y, mask, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_blocked_attend_case_equals_the_whole_one(dtype):
    """``attend_case`` with its plain versions and masses in blocks, as the
    card's products phase holds the four send-mode attention kernels. On
    CPU tensors each wrapper runs its plain version whole, so this holds
    the blocked plain versions against the whole ones: every row's terms
    added in the same order (the forward, rho and the sender backward
    equal bit for bit); ``datt`` adds the blocks' parts in another order."""
    smoke = _chip_smoke()
    ei, n = _gat_graph(seed=7)
    ctx = kgt_torch.prepare_graph(ei, n, add_self_loops=True, edge_chunk=64,
                                  device="cpu")
    gen = torch.Generator().manual_seed(8)
    heads, f = GAT_HEADS, GAT_DIMS[1]
    ht, att, gout, _ = smoke.attend_inputs(gen, n, heads, f, dtype,
                                           ctx.senders.shape[0], False, "cpu")
    graph = (ctx.senders, ctx.receivers, ctx.row_ptr, ctx.edge_mask)
    ss = (ctx.receivers_ss, ctx.senders_sorted, ctx.row_ptr_bwd)
    blocks = smoke.row_blocks(ctx.row_ptr, BLOCK_SLOTS)
    send_blocks = smoke.row_blocks(ctx.row_ptr_bwd, BLOCK_SLOTS)
    assert len(blocks) > 10 and len(send_blocks) > 10
    errs, plain = smoke.attend_case(
        graph, ht, att, gout, None, "blocked", blocks=blocks, emit_v=False,
        send=(ss, ctx.edge_mask_ss, send_blocks))
    assert set(errs) == set(plain) == {
        "sddmm_stats_agg_sorted", "attend_rho_sorted",
        "attend_recv_bwd_full_sorted", "attend_send_bwd_sorted"}
    for name in ("sddmm_stats_agg_sorted", "attend_rho_sorted",
                 "attend_send_bwd_sorted"):
        assert errs[name] == 0.0, (name, errs[name])
    dht, datt = plain["attend_recv_bwd_full_sorted"]()
    whole_errs, whole = smoke.attend_case(graph, ht, att, gout, None, "whole")
    assert max(whole_errs.values()) == 0.0
    w_dht, w_datt, _ = whole["attend_recv_bwd_full_sorted"]()
    assert torch.equal(dht, w_dht)
    scale = w_datt.float().abs().max().item()
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -7
    assert (datt.float() - w_datt.float()).abs().max().item() <= tol * scale


def test_eighth_products_preprocessing_under_budget():
    """The port's twin of the reference's tier-1 products test, with its
    assertions and budget."""
    n, e = PRODUCTS_N // 8, PRODUCTS_E // 8  # 306,128 nodes, 15,464,785
    rng = np.random.default_rng(0)
    ei = np.stack([rng.integers(0, n, e, dtype=np.int32),
                   rng.integers(0, n, e, dtype=np.int32)])
    t0 = time.perf_counter()
    pg = partition_graph(ei, n, 8, gcn_normalize=True, add_self_loops=True)
    kp = build_kernel_plan(pg)
    elapsed = time.perf_counter() - t0
    assert elapsed < 120, f"preprocessing took {elapsed:.0f}s"
    assert pg.edge_mask.sum() == e + n  # all edges + self loops placed
    real = int((kp.loc.weight > 0).sum() + (kp.rem.weight > 0).sum())
    assert real == e + n
    assert int(kp.rem.senders.max()) < 8 * kp.halo_size


def _grad_errors(model, ref_grads):
    """Each leaf's largest gradient error, as a share of the reference
    gradient's largest entry."""
    errors = {}
    for name, p in model.named_parameters():
        layer, leaf = name.split(".")
        want = np.asarray(ref_grads[layer][leaf])
        scale = float(np.abs(want).max())
        assert scale > 0, name
        errors[name] = float(np.abs(p.grad.numpy() - want).max()) / scale
    return errors


def _assert_step1_matches(model, ctx, x, y, mask, ref_loss, ref_grads, tol):
    """Step 1 through the training entry point against the JAX package's
    loss and gradients; then the same limit rejects step 1 taken at weights
    scaled by 1.01."""
    shifted = copy.deepcopy(model)
    with torch.no_grad():
        for p in shifted.parameters():
            p.mul_(1.01)
    losses, errors = [], []
    for m in (model, shifted):
        step = make_node_classification_step(
            m, torch.optim.SGD(m.parameters(), lr=0.0))
        losses.append(float(step(x, None, y, mask, context=ctx)))
        errors.append(_grad_errors(m, ref_grads))
    assert abs(losses[0] - float(ref_loss)) <= 1e-4
    assert max(errors[0].values()) <= tol, errors[0]
    assert max(errors[1].values()) > tol, errors[1]


def test_products_width_gcn_step_matches_jax():
    ei, n = _gcn_graph(seed=3, n=200, half=1_200)
    jc = j_csr.prepare_graph(ei, n, **GCN_PREPARE)
    tc = kgt_torch.prepare_graph(ei, n, device="cpu", **GCN_PREPARE)
    x, y, mask = _node_data(tc.num_nodes, n, seed=4)
    t_enc = _gcn_model()
    # F_in < F_out: the first layer propagates its 100 columns first.
    assert t_enc.layer_0.kernel.shape == (F_IN, HIDDEN) and F_IN < HIDDEN
    j_enc = JGNNEncoder.for_context("gcn", (HIDDEN, CLASSES))
    params = j_enc.init(jax.random.PRNGKey(0), F_IN)
    t_enc.load_state_dict(convert.params_from_jax(params))

    def j_loss(p):
        logits = j_enc.apply(p, jnp.asarray(x.numpy()), context=jc)
        return jtrain.masked_softmax_cross_entropy(
            logits, jnp.asarray(y.numpy()), jnp.asarray(mask.numpy()))

    with pltpu.force_tpu_interpret_mode():
        ref_loss, ref_grads = jax.value_and_grad(j_loss)(params)
    _assert_step1_matches(t_enc, tc, x, y, mask, ref_loss, ref_grads,
                          tol=GCN_GRAD_TOL)


def test_products_width_gat_send_step_matches_jax(monkeypatch):
    for module in (j_csr, t_csr):
        monkeypatch.setattr(module, "ATTEND_BWD_MODE", "send")
    ei, n = _gat_graph(seed=5, n=120, e=900)
    jc = j_csr.prepare_graph(ei, n, add_self_loops=True, edge_chunk=64)
    tc = kgt_torch.prepare_graph(ei, n, add_self_loops=True, edge_chunk=64,
                                 device="cpu")
    x, y, mask = _node_data(n, n, seed=6)
    conv_kwargs = {"heads": GAT_HEADS}
    j_enc = JGNNEncoder.for_context("gatv2", GAT_DIMS,
                                    conv_kwargs=conv_kwargs)
    params = j_enc.init(jax.random.PRNGKey(1), F_IN)
    t_enc = _gat_model()
    t_enc.load_state_dict(convert.params_from_jax(params))

    def j_loss(p):
        logits = j_enc.apply(p, jnp.asarray(x.numpy()), context=jc)
        return jtrain.masked_softmax_cross_entropy(
            logits, jnp.asarray(y.numpy()), jnp.asarray(mask.numpy()))

    with pltpu.force_tpu_interpret_mode():
        ref_loss, ref_grads = jax.value_and_grad(j_loss)(params)
    _assert_step1_matches(t_enc, tc, x, y, mask, ref_loss, ref_grads,
                          tol=GAT_GRAD_TOL)
