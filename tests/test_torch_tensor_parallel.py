"""Port parity for tensor (feature and head) parallelism on
``torch.distributed`` (``parallel/tensor_parallel.py``): the per-rank bodies
over a ``gloo`` group of CPU processes, a 1-D ``model`` mesh at world sizes 2
and 4 and a 2-D ``(graph, model)`` mesh of ``(1, 2)`` / ``(2, 2)``, against
the JAX package.

Cases, on a graph of 40 nodes and 160 random edges (seed 0), 6 input
features; the GCN pair 6 -> 16 -> 5 (relu between, GCN-normalised edge
weights, nonzero biases); GATv2 with 4 heads of 3 columns, concat and mean;
the reference's weights (``GCNConv.init`` / ``GATv2Conv.init``):

- the shard functions bit for bit against the reference's (concat and mean
  bias, ``att`` as ``(1, H, F)`` and ``(H, F)``, with and without biases),
  and the indivisible case raising in both;
- every block's forward, reassembled from the ranks, against the
  reference's bodies under ``jax.shard_map`` on the host's CPU devices (XLA
  bodies: no Pallas, so the interpret-mode hang of ``shard_map`` does not
  arise) and against the unsharded JAX layers;
- every block's gradients (each parameter shard, and ``x``) against
  ``jax.grad`` of the unsharded layers for the cotangent the test draws; on
  the 2-D mesh the parameters' gradients are summed over the graph group
  only (``distributed._sum_gradients``), as a 2-D step would;
- the model-axis backward rules: ``row_parallel_dense``'s sum, the head
  gather and the replicated input's sum give the unsharded gradient, where
  the two traps (``torch.distributed.nn``'s ``all_reduce``, the graph
  axis's reduce-scatter) give T times it;
- the replicated biases' gradient on every rank, T times what each of the
  reference's stacked copies gets under ``shard_map`` (ROADMAP D18);
- head-mean mode without ``heads_total`` raising in both packages.

Tolerance: ``rtol=2e-4, atol=2e-5`` (``tests/test_tensor_parallel.py``'s)
for the forwards and the gradients; the shard functions bit for bit; the
backward rules' ratio to the unsharded gradient within 1e-5 of 1 (or of T).

The ranks import torch and the port only (``torch_ranks``); JAX and the
reference are imported inside the parent's fixtures and tests.
"""

import numpy as np
import pytest
import torch

from torch_ranks import run_ranks

torch.set_num_threads(1)

N, E, F_IN, HIDDEN, F_OUT = 40, 160, 6, 16, 5
HEADS, F_HEAD = 4, 3
WORLDS = (2, 4)
GRIDS = {2: (1, 2), 4: (2, 2)}  # (graph, model) of the 2-D blocks
MODES = ("concat", "mean")
RTOL, ATOL = 2e-4, 2e-5
RATIO_TOL = 1e-5


def _graph():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, F_IN)).astype(np.float32)
    ei = np.stack([rng.integers(0, N, E),
                   rng.integers(0, N, E)]).astype(np.int32)
    g_gcn = rng.standard_normal((N, F_OUT)).astype(np.float32)
    g_gat = {"concat": rng.standard_normal(
        (N, HEADS * F_HEAD)).astype(np.float32),
        "mean": rng.standard_normal((N, F_HEAD)).astype(np.float32)}
    return x, ei, g_gcn, g_gat


def _primitive_inputs():
    rng = np.random.default_rng(3)
    return {k: rng.standard_normal(shape).astype(np.float32) for k, shape in (
        ("x", (7, 8)), ("w1", (8, HIDDEN)), ("w2", (HIDDEN, F_OUT)),
        ("g", (7, F_OUT)), ("heads", (7, HEADS, F_HEAD)),
        ("g_heads", (7, HEADS * F_HEAD)))}


# ---------------------------------------------------------------------------
# What every rank runs.
# ---------------------------------------------------------------------------


def _leaves(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        name = f"{prefix}.{key}" if prefix else key
        if isinstance(value, dict):
            out.update(_leaves(value, name))
        else:
            out[name] = value
    return out


def _as_params(tree):
    return {k: _as_params(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)).requires_grad_()
            for k, v in tree.items()}


def tp_ranks(rank, world, *, gcn_params, gat_params, edge_weight):
    from keras_geometric_tpu_torch import parallel as par
    from keras_geometric_tpu_torch.parallel import tensor_parallel as tp
    from keras_geometric_tpu_torch.parallel.distributed import _sum_gradients
    from keras_geometric_tpu_torch.parallel.halo import all_gather_rows

    x_np, ei, g_gcn, g_gat = _graph()
    senders, receivers = torch.from_numpy(ei[0]), torch.from_numpy(ei[1])
    weight = torch.from_numpy(edge_weight)
    mask = torch.ones(E, dtype=torch.bool)
    out = {}

    def run(block, p_np, x_in, g, graph_group=None):
        p = _as_params(p_np)
        x = torch.from_numpy(x_in).requires_grad_()
        o = block(p, x)
        o.backward(torch.from_numpy(g))
        leaves = _leaves(p)
        if graph_group is not None:
            _sum_gradients(leaves.values(), graph_group)
        return (o.detach().numpy(), x.grad.numpy(),
                {k: v.grad.numpy() for k, v in leaves.items()})

    # 1-D model mesh.
    mesh = par.make_mesh((world,), ("model",), device_type="cpu")
    group, t = mesh.get_group("model"), mesh.get_local_rank("model")
    out["gcn"] = run(
        lambda p, x: tp.tp_gcn_block_local(p, x, senders, receivers, weight,
                                           mask, group=group),
        tp.shard_params_tp(gcn_params, world)[t], x_np, g_gcn)
    for mode in MODES:
        out[f"gat_{mode}"] = run(
            lambda p, x: tp.tp_gatv2_block_local(
                p, x, senders, receivers, mask, group=group,
                concat=mode == "concat", heads_total=HEADS),
            tp.shard_params_gatv2_tp(gat_params[mode], world)[t], x_np,
            g_gat[mode])
    try:
        tp.tp_gatv2_block_local(
            _as_params(tp.shard_params_gatv2_tp(gat_params["mean"],
                                                world)[t]),
            torch.from_numpy(x_np), senders, receivers, mask, group=group,
            concat=False)
        out["mean_without_heads_total"] = None
    except ValueError as err:
        out["mean_without_heads_total"] = str(err)

    # The model-axis backward rules, and the two traps they avoid.
    prim = _primitive_inputs()
    s = HIDDEN // world
    cols = slice(t * s, (t + 1) * s)
    for name, reduce in (("rules", None), ("trap", "dist_nn")):
        x = torch.from_numpy(prim["x"]).requires_grad_()
        w1 = torch.from_numpy(prim["w1"][:, cols].copy()).requires_grad_()
        w2 = torch.from_numpy(prim["w2"][cols].copy()).requires_grad_()
        if reduce is None:
            h = tp.column_parallel_dense(x, w1, group=group)
            o = tp.row_parallel_dense(h, w2, group=group)
        else:
            import torch.distributed.nn.functional as dist_nn

            o = dist_nn.all_reduce(tp.column_parallel_dense(x, w1) @ w2,
                                   group=group)
        o.backward(torch.from_numpy(prim["g"]))
        hs = HEADS // world
        a = torch.from_numpy(
            prim["heads"][:, t * hs:(t + 1) * hs].copy()).requires_grad_()
        if reduce is None:
            gathered = tp._GatherBlocks.apply(a, 1, group)
        else:
            gathered = all_gather_rows(a.movedim(1, 0), group).movedim(0, 1)
        gathered.reshape(7, -1).backward(torch.from_numpy(prim["g_heads"]))
        out[name] = {"x": x.grad.numpy(), "w1": w1.grad.numpy(),
                     "w2": w2.grad.numpy(), "heads": a.grad.numpy(),
                     "out": o.detach().numpy(),
                     "gathered": gathered.detach().numpy()}

    # 2-D (graph, model) mesh.
    g_ax, t_ax = GRIDS[world]
    mesh2 = par.make_mesh((g_ax, t_ax), ("graph", "model"),
                          device_type="cpu")
    graph_group, model_group = mesh2.get_group("graph"), \
        mesh2.get_group("model")
    part, t2 = mesh2.get_local_rank("graph"), mesh2.get_local_rank("model")
    out["coords"] = (part, t2)
    for name, pg_kwargs in (("gcn", {"edge_weight": edge_weight}),
                            ("gat", {})):
        pg = par.partition_graph(ei, N, g_ax, **pg_kwargs)
        L = pg.nodes_per_part
        rows = slice(part * L, (part + 1) * L)

        def pad(a):
            padded = np.zeros((g_ax * L, a.shape[1]), np.float32)
            padded[:N] = a
            return padded[rows]

        s_g, r_l, m_l = (torch.from_numpy(np.ascontiguousarray(a[part]))
                         for a in (pg.senders_global, pg.receivers_local,
                                   pg.edge_mask))
        if name == "gcn":
            w_l = torch.from_numpy(np.ascontiguousarray(pg.edge_weight[part]))
            out["gcn_2d"] = run(
                lambda p, x: tp.tp_graph_gcn_block_local(
                    p, x, s_g, r_l, w_l, m_l, graph_group=graph_group,
                    model_group=model_group),
                tp.shard_params_tp(gcn_params, t_ax)[t2], pad(x_np),
                pad(g_gcn), graph_group)
            continue
        for mode in MODES:
            out[f"gat_{mode}_2d"] = run(
                lambda p, x: tp.tp_graph_gatv2_block_local(
                    p, x, s_g, r_l, m_l, graph_group=graph_group,
                    model_group=model_group, concat=mode == "concat",
                    heads_total=HEADS),
                tp.shard_params_gatv2_tp(gat_params[mode], t_ax)[t2],
                pad(x_np), pad(g_gat[mode]), graph_group)
    return out


# ---------------------------------------------------------------------------
# The parent: the reference's results, and the checks.
# ---------------------------------------------------------------------------


def _flat(tree):
    return {k: np.asarray(v) for k, v in _leaves(tree).items()}


@pytest.fixture(scope="module")
def reference():
    """The reference's weights, unsharded outputs and gradients, and its
    bodies under ``shard_map`` (forward; the replicated biases' gradients)
    on the host's CPU devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    import keras_geometric_tpu as kgt
    from keras_geometric_tpu.parallel import make_mesh, partition_graph
    from keras_geometric_tpu.parallel import tensor_parallel as rtp

    x, ei, g_gcn, g_gat = _graph()
    xj, eij = jnp.asarray(x), jnp.asarray(ei)
    ew = np.asarray(kgt.gcn_norm(eij, N))
    rng = np.random.default_rng(1)
    gcn1 = kgt.GCNConv(HIDDEN, add_self_loops=False, normalize=False)
    gcn2 = kgt.GCNConv(F_OUT, add_self_loops=False, normalize=False)
    gcn_params = {"layer_0": gcn1.init(jax.random.PRNGKey(0), F_IN),
                  "layer_1": gcn2.init(jax.random.PRNGKey(1), HIDDEN)}
    for layer in gcn_params.values():  # nonzero biases: their paths count
        layer["bias"] = jnp.asarray(
            0.1 * rng.standard_normal(layer["bias"].shape), jnp.float32)

    def gcn(p, xx):
        h = jax.nn.relu(gcn1.apply(p["layer_0"], xx, eij,
                                   edge_weight=jnp.asarray(ew)))
        return gcn2.apply(p["layer_1"], h, eij, edge_weight=jnp.asarray(ew))

    layers, gat_params = {}, {}
    for mode in MODES:
        layers[mode] = kgt.GATv2Conv(F_HEAD, heads=HEADS, add_self_loops=False,
                                     concat=mode == "concat")
        p = layers[mode].init(jax.random.PRNGKey(3), F_IN)
        p["bias"] = jnp.asarray(0.1 * rng.standard_normal(p["bias"].shape),
                                jnp.float32)
        gat_params[mode] = p

    def unsharded(fn, params, g):
        def loss(p, xx):
            o = fn(p, xx)
            return jnp.sum(o * g), o

        (_, out), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(params, xj)
        return np.asarray(out), np.asarray(gx), jax.tree_util.tree_map(
            np.asarray, gp)

    want = {"gcn": unsharded(gcn, gcn_params, g_gcn)}
    for mode in MODES:
        want[f"gat_{mode}"] = unsharded(
            lambda p, xx, mode=mode: layers[mode].apply(p, xx, eij),
            gat_params[mode], g_gat[mode])

    def stack(shards):
        return jax.tree_util.tree_map(
            lambda *xs: jnp.stack([jnp.asarray(v) for v in xs]), *shards)

    senders, receivers = eij[0], eij[1]
    mask = jnp.ones(E, bool)
    blocks = {
        "gcn": (rtp.shard_params_tp, gcn_params, g_gcn,
                lambda p, xx: rtp.tp_gcn_block_local(
                    p, xx, senders, receivers, jnp.asarray(ew), mask)),
        **{f"gat_{mode}": (
            rtp.shard_params_gatv2_tp, gat_params[mode], g_gat[mode],
            lambda p, xx, mode=mode: rtp.tp_gatv2_block_local(
                p, xx, senders, receivers, mask, concat=mode == "concat",
                heads_total=HEADS)) for mode in MODES}}
    sharded = {}
    for world in WORLDS:
        mesh = make_mesh((world,), ("model",), devices=jax.devices()[:world])
        for name, (shard, params, g, body) in blocks.items():
            def local(p, xx, body=body):
                return body(jax.tree_util.tree_map(lambda a: a[0], p), xx)

            fn = jax.shard_map(local, mesh=mesh, in_specs=(P("model"), P()),
                               out_specs=P(), check_vma=False)
            def loss(p, xx, fn=fn, g=g):
                o = fn(p, xx)
                return jnp.sum(o * g), o

            (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
                stack(shard(params, world)), xj)
            sharded[world, name] = (np.asarray(out),
                                    jax.tree_util.tree_map(np.asarray, grads))

        # The 2-D bodies' forward on a (graph, model) mesh.
        g_ax, t_ax = GRIDS[world]
        mesh2 = make_mesh((g_ax, t_ax), ("graph", "model"),
                          devices=jax.devices()[:world])
        for name, pg_kwargs in (("gcn", {"edge_weight": ew}), ("gat", {})):
            pg = partition_graph(ei, N, g_ax, **pg_kwargs)
            x_pad = np.zeros((g_ax * pg.nodes_per_part, F_IN), np.float32)
            x_pad[:N] = x
            edges = [pg.senders_global, pg.receivers_local] + (
                [pg.edge_weight] if name == "gcn" else []) + [pg.edge_mask]
            runs = ([("gcn", gcn_params, rtp.shard_params_tp,
                      rtp.tp_graph_gcn_block_local, {})]
                    if name == "gcn" else
                    [(f"gat_{mode}", gat_params[mode],
                      rtp.shard_params_gatv2_tp,
                      rtp.tp_graph_gatv2_block_local,
                      {"concat": mode == "concat", "heads_total": HEADS})
                     for mode in MODES])
            for key, params, shard, body, kw in runs:
                def local(xx, *rest, body=body, kw=kw, k=len(edges)):
                    e_args = [a[0] for a in rest[:k]]
                    p = jax.tree_util.tree_map(lambda a: a[0], rest[k])
                    return body(p, xx, *e_args, **kw)

                fn = jax.jit(jax.shard_map(
                    local, mesh=mesh2,
                    in_specs=(P("graph"),) * (1 + len(edges)) + (P("model"),),
                    out_specs=P("graph"), check_vma=False))
                sharded[world, f"{key}_2d"] = np.asarray(fn(
                    x_pad, *edges, stack(shard(params, t_ax))))[:N]

    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    return dict(gcn_params=to_np(gcn_params),
                gat_params={m: to_np(p) for m, p in gat_params.items()},
                edge_weight=ew, want=want, sharded=sharded)


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def ranks(request, reference, tmp_path_factory):
    world = request.param
    results = run_ranks(tp_ranks, world,
                        tmp_path_factory.mktemp(f"tp_world{world}"),
                        timeout=240, gcn_params=reference["gcn_params"],
                        gat_params=reference["gat_params"],
                        edge_weight=reference["edge_weight"])
    return world, results


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


def _shard_fn(name):
    from keras_geometric_tpu_torch.parallel import tensor_parallel as tp

    return tp.shard_params_tp if name == "gcn" else tp.shard_params_gatv2_tp


def _params_of(reference, name):
    return (reference["gcn_params"] if name == "gcn"
            else reference["gat_params"][name.removeprefix("gat_")])


def _replicated(name):
    """The parameters every model rank holds whole."""
    return {"gcn": {"layer_1.bias"}, "gat_mean": {"bias"}}.get(name, set())


def _grads_held(got, want_tree, name, t, size):
    """Rank ``t``'s parameter gradients (of a ``size``-way model axis)
    against its shard of the unsharded gradients; a replicated parameter's
    against the whole."""
    want = _flat(_shard_fn(name)(want_tree, size)[t])
    assert set(got) == set(want)
    for key, g in got.items():
        _close(g, want[key], f"{name} d {key} (shard {t})")


# -- the shard functions ------------------------------------------------------


@pytest.mark.parametrize("num_shards", [1, 2, 4])
@pytest.mark.parametrize("case", ["gcn", "gcn_no_bias", "gat_concat",
                                  "gat_mean", "gat_att_2d", "gat_no_bias"])
def test_shard_functions_bit_equal_to_the_reference(case, num_shards):
    from keras_geometric_tpu.parallel import tensor_parallel as rtp

    from keras_geometric_tpu_torch.parallel import tensor_parallel as tp

    rng = np.random.default_rng(11)
    r = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    if case.startswith("gcn"):
        params = {"layer_0": {"kernel": r(F_IN, HIDDEN), "bias": r(HIDDEN)},
                  "layer_1": {"kernel": r(HIDDEN, F_OUT), "bias": r(F_OUT)}}
        if case == "gcn_no_bias":
            del params["layer_0"]["bias"], params["layer_1"]["bias"]
        got, want = (tp.shard_params_tp(params, num_shards),
                     rtp.shard_params_tp(params, num_shards))
    else:
        params = {"kernel": r(F_IN, HEADS * F_HEAD),
                  "att": r(1, HEADS, F_HEAD),
                  "bias": r(F_HEAD if case == "gat_mean"
                            else HEADS * F_HEAD)}
        if case == "gat_att_2d":
            params["att"] = params["att"][0]
        if case == "gat_no_bias":
            del params["bias"]
        got, want = (tp.shard_params_gatv2_tp(params, num_shards),
                     rtp.shard_params_gatv2_tp(params, num_shards))
    assert len(got) == len(want) == num_shards
    for g, w in zip(got, want):
        g, w = _flat(g), _flat(w)
        assert set(g) == set(w)
        for key in w:
            assert g[key].dtype == w[key].dtype
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def test_shard_functions_raise_where_the_reference_asserts():
    from keras_geometric_tpu.parallel import tensor_parallel as rtp

    from keras_geometric_tpu_torch.parallel import tensor_parallel as tp

    gcn = {"layer_0": {"kernel": np.zeros((F_IN, 6))},
           "layer_1": {"kernel": np.zeros((6, F_OUT))}}
    gat = {"kernel": np.zeros((F_IN, 3 * F_HEAD)),
           "att": np.zeros((1, 3, F_HEAD))}
    for shard, rshard, params in ((tp.shard_params_tp, rtp.shard_params_tp,
                                   gcn),
                                  (tp.shard_params_gatv2_tp,
                                   rtp.shard_params_gatv2_tp, gat)):
        with pytest.raises(AssertionError):
            rshard(params, 4)
        with pytest.raises(ValueError, match="must divide the model axis"):
            shard(params, 4)


def test_column_parallel_dense_without_a_group_is_a_plain_product():
    """No collective and no process group: ``x @ W (+ b)``."""
    from keras_geometric_tpu_torch.parallel import column_parallel_dense

    rng = np.random.default_rng(2)
    x, w, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((5, 4), (4, 3), (3,)))
    assert not torch.distributed.is_initialized()
    assert torch.equal(column_parallel_dense(x, w), x @ w)
    assert torch.equal(column_parallel_dense(x, w, b), x @ w + b)


# -- the 1-D blocks -------------------------------------------------------------


@pytest.mark.parametrize("name", ["gcn", "gat_concat", "gat_mean"])
def test_1d_block_forward_matches_shard_map_and_unsharded(ranks, reference,
                                                          name):
    world, results = ranks
    want = reference["want"][name][0]
    via_shard_map = reference["sharded"][world, name][0]
    _close(via_shard_map, want, f"{name}: the reference's own bodies")
    for r in results:  # every model rank holds the whole output
        _close(r[name][0], via_shard_map, f"{name} vs shard_map")
        _close(r[name][0], want, f"{name} vs unsharded")


@pytest.mark.parametrize("name", ["gcn", "gat_concat", "gat_mean"])
def test_1d_block_gradients_match_unsharded(ranks, reference, name):
    world, results = ranks
    _, want_dx, want_grads = reference["want"][name]
    for t, r in enumerate(results):
        _, dx, grads = r[name]
        _close(dx, want_dx, f"{name} d x (rank {t})")
        _grads_held(grads, want_grads, name, t, world)


# -- the 2-D blocks -------------------------------------------------------------


@pytest.mark.parametrize("name", ["gcn", "gat_concat", "gat_mean"])
def test_2d_block_forward_and_gradients_match_unsharded(ranks, reference,
                                                        name):
    world, results = ranks
    g_ax, t_ax = GRIDS[world]
    want_out, want_dx, want_grads = reference["want"][name]
    _close(reference["sharded"][world, f"{name}_2d"], want_out,
           f"{name} 2-D: the reference's own bodies")
    by_coord = {r["coords"]: r[f"{name}_2d"] for r in results}
    assert sorted(by_coord) == [(p, t) for p in range(g_ax)
                                for t in range(t_ax)]
    for t in range(t_ax):
        out = np.concatenate([by_coord[p, t][0] for p in range(g_ax)])[:N]
        dx = np.concatenate([by_coord[p, t][1] for p in range(g_ax)])[:N]
        _close(out, reference["sharded"][world, f"{name}_2d"],
               f"{name} 2-D vs shard_map (model rank {t})")
        _close(out, want_out, f"{name} 2-D vs unsharded (model rank {t})")
        _close(dx, want_dx, f"{name} 2-D d x (model rank {t})")
        for p in range(g_ax):  # summed over the graph group only
            _grads_held(by_coord[p, t][2], want_grads, name, t, t_ax)


# -- the model-axis backward rules ---------------------------------------------


def _ratio(got, want):
    return float(np.sum(got * want) / np.sum(want * want))


def test_model_axis_backwards_give_the_unsharded_gradient_not_t_times(ranks):
    """``row_parallel_dense``'s sum, the head gather and the replicated
    input's sum: the unsharded gradient (ratio 1); the traps,
    ``torch.distributed.nn``'s ``all_reduce`` and the graph axis's
    reduce-scatter: T times it on the parameters and the heads."""
    world, results = ranks
    prim = _primitive_inputs()
    x, w1, w2, g = (prim[k] for k in ("x", "w1", "w2", "g"))
    want = {"x": g @ w2.T @ w1.T, "w1": x.T @ (g @ w2.T),
            "w2": (x @ w1).T @ g, "heads": prim["g_heads"].reshape(
                7, HEADS, F_HEAD)}
    s, hs = HIDDEN // world, HEADS // world
    for t, r in enumerate(results):
        mine = {"x": want["x"], "w1": want["w1"][:, t * s:(t + 1) * s],
                "w2": want["w2"][t * s:(t + 1) * s],
                "heads": want["heads"][:, t * hs:(t + 1) * hs]}
        _close(r["rules"]["out"], x @ w1 @ w2, "the primitives' output")
        _close(r["rules"]["gathered"],
               prim["heads"], "the gathered heads")
        for key, w in mine.items():
            assert abs(_ratio(r["rules"][key], w) - 1) <= RATIO_TOL, key
            _close(r["rules"][key], w, f"d {key} (rank {t})")
            trap = _ratio(r["trap"][key], w)
            # The trap's x has no "f": its gradient is the rank's part only.
            if key != "x":
                assert abs(trap - world) <= RATIO_TOL * world, (key, trap)
        assert abs(_ratio(r["trap"]["x"], want["x"]) - 1) > 1e-2


def test_replicated_bias_gradients_are_t_times_the_references_copies(
        ranks, reference):
    """ROADMAP D18: every rank's replicated bias gets the whole gradient;
    each of the reference's stacked copies under ``shard_map`` gets 1/T."""
    world, results = ranks
    for name in ("gcn", "gat_mean"):
        (key,) = _replicated(name)
        copies = _flat(reference["sharded"][world, name][1])[key]
        whole = _flat(reference["want"][name][2])[key]
        _close(copies.sum(axis=0), whole, f"{name}: the copies' sum")
        for t, r in enumerate(results):
            _close(r[name][2][key], world * copies[t], f"{name} {key}")
    # The head-sharded parameters match the reference's per-shard ones.
    for t, r in enumerate(results):
        ref = _flat(reference["sharded"][world, "gat_concat"][1])
        for key, g in r["gat_concat"][2].items():
            _close(g, ref[key][t], f"gat_concat {key} vs shard_map")


def test_mean_mode_without_heads_total_raises(ranks):
    import jax.numpy as jnp

    from keras_geometric_tpu.parallel import tensor_parallel as rtp

    _, results = ranks
    for r in results:
        assert r["mean_without_heads_total"] == (
            "heads_total required for mean (concat=False)")
    p = {"kernel": jnp.zeros((F_IN, HEADS * F_HEAD)),
         "att": jnp.zeros((HEADS, F_HEAD))}
    with pytest.raises(ValueError, match="heads_total required"):
        # The reference's check sits after its local attention, before the
        # first model-axis collective: it raises outside shard_map too.
        rtp.tp_gatv2_block_local(
            p, jnp.zeros((3, F_IN)), jnp.zeros(2, jnp.int32),
            jnp.zeros(2, jnp.int32), jnp.ones(2, bool), concat=False)
