"""Port parity for partitioned full-graph training on ``torch.distributed``:
the per-rank bodies, the distributed step and the evaluation function over a
``gloo`` group of CPU processes at world sizes 2 and 4, against the JAX
package's single-device layers (no ``shard_map``: the reference's own
distributed tests hang in interpret mode on the CPU).

On the CPU every kernel wrapper takes its plain version, so the kernelized
bodies here pin the plans, the overlap's algebra and the collectives; the
kernels themselves are held against the same plain versions on the card
(``chip_smoke.py``).

Cases, on the reference tests' graph (100 nodes, 400 random edges, 12
features, seed 7), encoders of widths (8, 6) with the reference's
parameters (``convert.params_from_jax``):

- every conv family's forward (GCN on a partition with the normalization
  and self-loops folded in; GIN sum / mean / max; GraphSAGE mean / sum /
  max / min / pooling / std; GATv2 with two heads) on the library bodies
  (all-gather), the library bodies over the halo exchange, and the
  kernelized bodies (GATv2 with and without an attend plan; GraphSAGE std
  and GATv2 without one take the warned fallback), reassembled from the
  ranks: ``rtol=2e-4, atol=2e-5`` (GATv2 ``5e-4 / 5e-5``), the reference
  tests' limits;
- one training step's loss (within ``1e-5``) and gradients (within ``2e-4``
  of each tensor's largest entry), the parameters equal on every rank after
  Adam steps, and a step with message dropout that every rank agrees on;
- the evaluation function's accuracy, library and kernelized;
- the messages-form path of ``spmm_local_overlapped`` (per-edge scales of
  1) against its linear path;
- ``pooled_max_local`` on tied inputs (ReLU'd, rounded values, rows tied at
  0) against the reference's pieces composed without ``shard_map``: the
  per-stream ``segment_max_wide_sorted`` in interpret mode, ``jnp.maximum``
  and the fixup, forward and gradients (1e-6).

The ranks import torch and the port only (``torch_ranks``): JAX and the
reference are imported inside the parent's fixtures and test functions.
"""

import numpy as np
import pytest
import torch

from torch_ranks import run_ranks

torch.set_num_threads(1)

N, E, F, CLASSES, DIMS = 100, 400, 12, 5, (8, 6)
WORLDS = (2, 4)

# name -> (conv family, conv kwargs)
FAMILIES = {
    "gcn": ("gcn", {}),
    "gin_sum": ("gin", {"aggregator": "sum"}),
    "gin_mean": ("gin", {"aggregator": "mean"}),
    "gin_max": ("gin", {"aggregator": "max"}),
    "sage_mean": ("sage", {"aggregator": "mean"}),
    "sage_sum": ("sage", {"aggregator": "sum"}),
    "sage_max": ("sage", {"aggregator": "max"}),
    "sage_min": ("sage", {"aggregator": "min"}),
    "sage_pooling": ("sage", {"aggregator": "pooling"}),
    "sage_std": ("sage", {"aggregator": "std"}),
    "gatv2": ("gatv2", {"heads": 2, "add_self_loops": False}),
}
PATHS = ("library", "halo", "kernelized")
FORWARD_CASES = [(name, path) for name in FAMILIES for path in PATHS] + [
    ("gatv2", "kernelized_no_ap")]
STEP_CASES = [("gcn", "library"), ("gcn", "halo"), ("gcn", "kernelized"),
              ("gatv2", "library"), ("gatv2", "kernelized"),
              ("gin_sum", "kernelized"), ("sage_mean", "kernelized"),
              ("gin_mean", "kernelized"), ("sage_pooling", "library")]
# The kernelized bodies that take the library fallback (once per layer).
# GATv2's fallback reads the plan's edges through the same view.
FALLBACKS = {("sage_std", "kernelized"): {"kp_xla_edges"},
             ("gatv2", "kernelized_no_ap"): {"gatv2_kp_fallback",
                                             "kp_xla_edges"}}


def _graph():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((N, F)).astype(np.float32)
    ei = np.stack([rng.integers(0, N, E),
                   rng.integers(0, N, E)]).astype(np.int32)
    y = rng.integers(0, CLASSES, N).astype(np.int64)
    train = np.random.default_rng(8).random(N) < 0.6
    return x, ei, y, train


def _tied(rng, rows, f):
    m = np.maximum(rng.standard_normal((rows, f)) - 0.3, 0.0)
    return (np.round(m * 2) / 2).astype(np.float32)


# ---------------------------------------------------------------------------
# What every rank runs.
# ---------------------------------------------------------------------------


def distributed_ranks(rank, world, *, params):
    import keras_geometric_tpu_torch as kgt
    from keras_geometric_tpu_torch import convert
    from keras_geometric_tpu_torch import parallel as par
    from keras_geometric_tpu_torch.parallel import attend_plan, spmd
    from keras_geometric_tpu_torch.parallel.kernel_plan import (
        pooled_max_local,
        spmm_local_overlapped,
    )

    mesh = par.make_mesh(device_type="cpu")
    group = mesh.get_group("graph")
    x, ei, y, train = _graph()
    masks = {"train_mask": train, "test_mask": ~train}
    shards = {}

    def shard(gcn):
        if gcn not in shards:
            pg = par.partition_graph(ei, N, world, gcn_normalize=gcn,
                                     add_self_loops=gcn)
            hp = par.build_halo_plan(pg)
            kp = par.build_kernel_plan(pg)
            ap = attend_plan.build_attend_plan(pg, halo_plan=hp)
            plain = par.shard_partitioned_graph(
                pg, mesh, x=x, y=y, masks=masks, kernel_plan=kp,
                attend_plan=ap)
            halo = par.shard_partitioned_graph(pg, mesh, x=x, y=y,
                                               masks=masks, halo_plan=hp)
            shards[gcn] = (plain, halo, kp, ap)
        return shards[gcn]

    def encoder(name, dropout=0.0):
        family, kw = FAMILIES[name]
        gen = torch.Generator().manual_seed(0)
        if family == "gcn" and dropout:
            enc = kgt.GNNEncoder(
                "gcn", DIMS, input_dim=F, generator=gen, device="cpu",
                conv_kwargs=(("add_self_loops", False), ("normalize", False),
                             ("dropout_rate", dropout)))
        elif family == "gcn":
            enc = par.distributed_gcn_encoder(DIMS, input_dim=F,
                                              generator=gen, device="cpu")
        else:
            enc = kgt.GNNEncoder(family, DIMS, input_dim=F, conv_kwargs=kw,
                                 generator=gen, device="cpu")
        enc.load_state_dict(convert.params_from_jax(params[name]))
        return enc

    def library(data):
        # The same shard without its plans: the library bodies.
        return {k: v for k, v in data.items() if k not in ("kp", "ap")}

    def forward(enc, name, path):
        plain, halo, _, _ = shard(name == "gcn")
        if path == "library":
            return spmd.encoder_apply_local(
                enc, plain["x"], plain["senders"], plain["receivers"],
                plain["edge_weight"], plain["edge_mask"], group=group)
        if path == "halo":
            return spmd.encoder_apply_local(
                enc, halo["x"], halo["senders"], halo["receivers"],
                halo["edge_weight"], halo["edge_mask"], group=group,
                halo_send_idx=halo["send_idx"])
        return spmd.encoder_apply_local_kernelized(
            enc, plain["x"], plain["kp"],
            None if path == "kernelized_no_ap" else plain["ap"], group=group)

    out = {"forward": {}, "fallbacks": {}, "step": {}, "eval": {}}
    for name, path in FORWARD_CASES:
        enc = encoder(name).eval()
        before = dict(spmd.FALLBACK_COUNTS)
        with torch.no_grad():
            out["forward"][name, path] = forward(enc, name, path).numpy()
        out["fallbacks"][name, path] = {
            k: spmd.FALLBACK_COUNTS[k] - before[k] for k in before}

    for name, path in STEP_CASES:
        enc = encoder(name)
        plain, halo, _, _ = shard(name == "gcn")
        # The data dict picks the body: its kernel shard, its halo senders
        # or neither.
        data = {"halo": halo, "kernelized": plain}.get(path, library(plain))
        step = par.make_distributed_train_step(
            enc, torch.optim.SGD(enc.parameters(), lr=0.0), mesh)
        loss = step(data).item()
        grads = {k: p.grad.numpy().copy() for k, p in enc.named_parameters()}
        out["step"][name, path] = (loss, grads)
        evaluate = par.make_distributed_eval_fn(enc, mesh)
        out["eval"][name, path] = evaluate(data, data["test_mask"]).item()

    # Replicated parameters stay equal on every rank; message dropout.
    plain, _, kp, _ = shard(True)
    for key, dropout in (("adam", 0.0), ("dropout", 0.5)):
        enc = encoder("gcn", dropout=dropout)
        step = par.make_distributed_train_step(
            enc, torch.optim.Adam(enc.parameters(), lr=1e-2), mesh,
            generator=torch.Generator().manual_seed(rank))
        losses = [step(plain).item() for _ in range(3)]
        out[key] = (losses, torch.cat([p.detach().reshape(-1)
                                       for p in enc.parameters()]).numpy())

    # The messages-form path with scales of 1 against the linear path.
    h = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (plain["x"].shape[0], 7)).astype(np.float32))
    ones = {"loc": torch.ones(kp.loc.senders.shape[1]),
            "rem": torch.ones(kp.rem.senders.shape[1])}
    pair = []
    for scale in (None, ones):
        hh = h.clone().requires_grad_()
        o = spmm_local_overlapped(hh, plain["kp"], group=group,
                                  message_scale=scale)
        (o * torch.arange(o.numel()).reshape(o.shape).sin()).sum().backward()
        pair.append((o.detach().numpy(), hh.grad.numpy()))
    out["messages_form"] = pair

    # pooled_max_local on tied inputs: the max and the min (negated).
    plain_f, _, kp_f, _ = shard(False)
    L = kp_f.nodes_per_part
    h_all = _tied(np.random.default_rng(21), world * L, 10)
    g_all = np.random.default_rng(22).standard_normal(
        (world * L, 10)).astype(np.float32)
    pooled = {}
    for kind, mlp in (("max", lambda m: m), ("min", torch.neg)):
        hh = torch.from_numpy(h_all[rank * L:(rank + 1) * L]).requires_grad_()
        o = pooled_max_local(hh, plain_f["kp"], mlp, group=group)
        (o * torch.from_numpy(g_all[rank * L:(rank + 1) * L])).sum().backward()
        pooled[kind] = (o.detach().numpy(), hh.grad.numpy())
    out["pooled"] = pooled
    return out


# ---------------------------------------------------------------------------
# The parent: the reference's single-device results, and the checks.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference():
    """The JAX package's parameters and single-device results."""
    import jax
    import jax.numpy as jnp

    import keras_geometric_tpu as kgt
    from keras_geometric_tpu.models import GNNEncoder
    from keras_geometric_tpu.nn.module import get_activation
    from keras_geometric_tpu.parallel import distributed_gcn_encoder

    x, ei, y, train = _graph()
    ei_loops, _ = kgt.add_self_loops(jnp.asarray(ei), N)
    ew = kgt.gcn_norm(ei_loops, N)
    params, logits_fn = {}, {}
    for name, (family, kw) in FAMILIES.items():
        if family == "gcn":
            enc = distributed_gcn_encoder(DIMS)

            def fwd(p, enc=enc):
                h = jnp.asarray(x)
                layers = enc._layers()
                for i, layer in enumerate(layers):
                    h = layer.apply(p[f"layer_{i}"], h, ei_loops,
                                    edge_weight=ew)
                    if i < len(layers) - 1:
                        h = get_activation(enc.activation)(h)
                return h
        else:
            enc = GNNEncoder(conv=family, hidden_dims=DIMS,
                             conv_kwargs=tuple(kw.items()))

            def fwd(p, enc=enc):
                return enc.apply(p, jnp.asarray(x), jnp.asarray(ei))
        params[name] = enc.init(jax.random.PRNGKey(0), F)
        logits_fn[name] = fwd

    def loss_fn(name):
        def loss(p):
            logp = jax.nn.log_softmax(logits_fn[name](p), axis=-1)
            nll = -jnp.take_along_axis(logp, jnp.asarray(y)[:, None], 1)[:, 0]
            m = jnp.asarray(train, jnp.float32)
            return jnp.sum(nll * m) / jnp.maximum(jnp.sum(m), 1.0)
        return loss

    forward = {name: np.asarray(fn(params[name]))
               for name, fn in logits_fn.items()}
    steps = {}
    for name in {n for n, _ in STEP_CASES}:
        loss, grads = jax.value_and_grad(loss_fn(name))(params[name])
        logits = forward[name]
        acc = float(((logits.argmax(-1) == y) & ~train).sum() / (~train).sum())
        steps[name] = (float(loss), jax.tree_util.tree_map(np.asarray, grads),
                       acc)
    numpy_params = jax.tree_util.tree_map(np.asarray, params)
    return numpy_params, forward, steps


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def ranks(request, reference, tmp_path_factory):
    params, _, _ = reference
    world = request.param
    results = run_ranks(distributed_ranks, world,
                        tmp_path_factory.mktemp(f"world{world}"),
                        timeout=300, params=params)
    return world, results


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        name = f"{prefix}.{key}" if prefix else key
        if isinstance(value, dict):
            out.update(_flat(value, name))
        else:
            out[name] = np.asarray(value)
    return out


@pytest.mark.parametrize("name,path", FORWARD_CASES,
                         ids=[f"{n}-{p}" for n, p in FORWARD_CASES])
def test_forward_matches_jax_single_device(ranks, reference, name, path):
    _, results = ranks
    got = np.concatenate([r["forward"][name, path] for r in results])[:N]
    want = reference[1][name]
    tol = (5e-4, 5e-5) if name == "gatv2" else (2e-4, 2e-5)
    np.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1])
    taken = FALLBACKS.get((name, path), set())
    for r in results:
        assert r["fallbacks"][name, path] == {
            k: len(DIMS) * (k in taken) for k in r["fallbacks"][name, path]}


@pytest.mark.parametrize("name,path", STEP_CASES,
                         ids=[f"{n}-{p}" for n, p in STEP_CASES])
def test_step_loss_gradients_and_eval_match_jax(ranks, reference, name,
                                                path):
    _, results = ranks
    want_loss, want_grads, want_acc = reference[2][name]
    want_grads = _flat(want_grads)
    for r in results:
        loss, grads = r["step"][name, path]
        assert abs(loss - want_loss) <= 1e-5, (loss, want_loss)
        assert set(grads) == set(want_grads)
        for key, g in grads.items():
            scale = float(np.abs(want_grads[key]).max())
            np.testing.assert_allclose(g, want_grads[key], rtol=0,
                                       atol=2e-4 * max(scale, 1e-12),
                                       err_msg=key)
        assert abs(r["eval"][name, path] - want_acc) <= 1e-6


def test_parameters_stay_replicated_and_dropout_steps_agree(ranks):
    _, results = ranks
    for key in ("adam", "dropout"):
        losses0, params0 = results[0][key]
        assert all(np.isfinite(losses0))
        for r in results[1:]:
            losses, params = r[key]
            assert losses == losses0
            np.testing.assert_array_equal(params, params0)
    # Dropout changes the loss (the masks are drawn and applied).
    assert results[0]["dropout"][0][0] != results[0]["adam"][0][0]


def test_messages_form_matches_the_linear_path(ranks):
    _, results = ranks
    for r in results:
        (lin_out, lin_grad), (msg_out, msg_grad) = r["messages_form"]
        np.testing.assert_allclose(msg_out, lin_out, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(msg_grad, lin_grad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["max", "min"])
def test_pooled_max_local_tie_rule_matches_jax_pieces(ranks, monkeypatch,
                                                      kind):
    """Within a stream the kernel's tie rule (every tied element gets the
    whole cotangent), across the two streams ``jnp.maximum``'s; the
    reference's pieces composed on one process, the halo table built from
    the plan's send table."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from keras_geometric_tpu.kernels import spmm_pallas as K
    from keras_geometric_tpu.parallel import kernel_plan as j_kp
    from keras_geometric_tpu.parallel import partition as j_part

    world, results = ranks
    _, ei, _, _ = _graph()
    pg = j_part.partition_graph(ei, N, world)
    kp = j_kp.build_kernel_plan(pg, edge_chunk=128, row_block=8)
    L = pg.nodes_per_part
    h_all = _tied(np.random.default_rng(21), world * L, 10)
    g_all = np.random.default_rng(22).standard_normal(
        (world * L, 10)).astype(np.float32)
    monkeypatch.setattr(K, "expand_sorted", functools.partial(
        K.expand_sorted, precision=jax.lax.Precision.HIGHEST))
    sign = 1.0 if kind == "max" else -1.0

    def tables(ts, p):
        return K.RowTables(
            bounds=ts.bounds[p], work_block=ts.work_block[p],
            work_chunk=ts.work_chunk[p], work_first=ts.work_first[p],
            work_cfirst=ts.work_cfirst[p], edge_chunk=ts.edge_chunk,
            row_block=ts.row_block)

    def pieces(h):
        parts = []
        for p in range(world):
            local = h[p * L:(p + 1) * L]
            halo = jnp.concatenate([
                h[q * L:(q + 1) * L][jnp.asarray(kp.send_idx[q, p])]
                for q in range(world)])
            maxes = [K.segment_max_wide_sorted(
                sign * src[jnp.asarray(es.senders[p])],
                jnp.asarray(es.receivers[p]), L, tables=tables(es.tables, p),
                mask=jnp.asarray((es.weight[p] != 0).astype(np.float32)),
                empty_to_zero=False)[:L]
                for es, src in ((kp.loc, local), (kp.rem, halo))]
            out = jnp.maximum(*maxes)
            parts.append(jnp.where(out <= -1e30 / 2, 0.0, out))
        return jnp.concatenate(parts)

    with pltpu.force_tpu_interpret_mode():
        h = jnp.asarray(h_all)
        want_out = np.asarray(pieces(h))
        want = np.asarray(jax.grad(
            lambda h: jnp.sum(pieces(h) * g_all))(h))
    got_out = np.concatenate([r["pooled"][kind][0] for r in results])
    got_grad = np.concatenate([r["pooled"][kind][1] for r in results])
    np.testing.assert_array_equal(got_out, want_out)
    np.testing.assert_allclose(got_grad, want, rtol=1e-6, atol=1e-6)
    # The inputs hold ties (maxes at 0 that several messages share), where
    # the rule differs from the single-device layers' split rule
    # (GraphContext.scatter_max): same forward, other gradients.
    assert (got_out == 0).any()
    import keras_geometric_tpu_torch as kgt_torch

    ctx = kgt_torch.prepare_graph(ei, N, device="cpu")
    h = torch.from_numpy(h_all[:N]).requires_grad_()
    split = ctx.scatter_max(sign * ctx.gather(h))
    (split * torch.from_numpy(g_all[:N])).sum().backward()
    np.testing.assert_array_equal(split.detach().numpy(), got_out[:N])
    assert np.abs(h.grad.numpy() - got_grad[:N]).max() > 1e-3
