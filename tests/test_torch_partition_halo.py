"""Port parity for the distribution tier's host plans and halo exchange.

``partition_graph``, ``community_partition_order``, ``build_halo_plan`` and
``build_hier_halo_plan`` of ``keras_geometric_tpu_torch.parallel`` give the
JAX package's arrays bit for bit (values and types) on the reference tests'
graph (100 nodes, 400 edges, seed 7), on a community graph, and on a 2 x 2
hierarchical layout. ``exchange`` and ``exchange_hier`` run over a ``gloo``
group of CPU processes (world 2 and 4; the hierarchical one on a (host,
chip) = (2, 2) mesh) and return the tables the host computes from the plan,
and the gradients of those host-built tables (autograd on one process).

The ranks import torch and the port only: JAX and the reference are
imported inside the parent's test functions.
"""

import numpy as np
import pytest
import torch

from keras_geometric_tpu_torch.parallel import halo as t_halo
from keras_geometric_tpu_torch.parallel import partition as t_part
from torch_ranks import run_ranks

torch.set_num_threads(1)

N, E, F = 100, 400, 6


def _graph():
    rng = np.random.default_rng(7)
    ei = np.stack([rng.integers(0, N, E), rng.integers(0, N, E)])
    w = rng.random(E).astype(np.float32)
    return ei.astype(np.int32), w


def _assert_same(got, want):
    """NamedTuples equal field for field: arrays bit for bit with the same
    type, scalars equal."""
    assert type(got)._fields == type(want)._fields
    for field in got._fields:
        a, b = getattr(got, field), getattr(want, field)
        if isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray), field
            assert a.dtype == b.dtype and a.shape == b.shape, field
            assert np.array_equal(a, b), field
        else:
            assert a == b, field


PARTITION_OPTIONS = {
    "plain": dict(),
    "gcn": dict(gcn_normalize=True, add_self_loops=True),
    "weighted": dict(add_self_loops=True, with_weight=True),
    "chunk8": dict(edge_multiple=8),
}


@pytest.mark.parametrize("parts", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("option", sorted(PARTITION_OPTIONS))
def test_partition_graph_bit_equal(option, parts):
    from keras_geometric_tpu.parallel import partition as j_part

    ei, w = _graph()
    kw = dict(PARTITION_OPTIONS[option])
    if kw.pop("with_weight", False):
        kw["edge_weight"] = w
    _assert_same(t_part.partition_graph(ei, N, parts, **kw),
                 j_part.partition_graph(ei, N, parts, **kw))


@pytest.mark.parametrize("parts", [2, 4])
def test_community_partition_order_bit_equal(parts):
    from keras_geometric_tpu.data.datasets.synthetic import (
        community_graph as j_cg,
    )
    from keras_geometric_tpu.parallel import partition as j_part
    from keras_geometric_tpu_torch.data.datasets import community_graph

    n = 600
    ei = community_graph(n, 4000, seed=3)
    assert np.array_equal(ei, np.asarray(j_cg(n, 4000, seed=3)))
    got = t_part.community_partition_order(ei[0], ei[1], n, parts)
    want = j_part.community_partition_order(ei[0], ei[1], n, parts)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(np.sort(got), np.arange(n))


@pytest.mark.parametrize("halo_multiple", [1, 8])
@pytest.mark.parametrize("parts", [1, 2, 4, 8])
def test_build_halo_plan_bit_equal(parts, halo_multiple):
    from keras_geometric_tpu.parallel import halo as j_halo
    from keras_geometric_tpu.parallel import partition as j_part

    ei, _ = _graph()
    _assert_same(
        t_halo.build_halo_plan(t_part.partition_graph(ei, N, parts),
                               halo_multiple=halo_multiple),
        j_halo.build_halo_plan(j_part.partition_graph(ei, N, parts),
                               halo_multiple=halo_multiple))


@pytest.mark.parametrize("parts,hosts", [(4, 2), (8, 2), (8, 4)],
                         ids=["2x2", "2x4", "4x2"])
def test_build_hier_halo_plan_bit_equal(parts, hosts):
    from keras_geometric_tpu.parallel import halo as j_halo
    from keras_geometric_tpu.parallel import partition as j_part

    ei, _ = _graph()
    _assert_same(
        t_halo.build_hier_halo_plan(t_part.partition_graph(ei, N, parts),
                                    hosts),
        j_halo.build_hier_halo_plan(j_part.partition_graph(ei, N, parts),
                                    hosts))


# ---------------------------------------------------------------------------
# The exchanges over gloo.
# ---------------------------------------------------------------------------


def _inputs(world):
    rng = np.random.default_rng(world)
    pg = t_part.partition_graph(_graph()[0], N, world)
    h = rng.standard_normal((pg.padded_num_nodes, F)).astype(np.float32)
    return pg, h


def _flat_tables(pg, plan, h):
    """The flat exchange's tables, built on the host from the plan; their
    rows are views of ``h`` (a torch tensor), so autograd gives the
    exchange's gradient."""
    P, L, H = pg.num_parts, pg.nodes_per_part, plan.halo_size
    send = torch.from_numpy(plan.send_idx.astype(np.int64))
    tables = []
    for p in range(P):
        halo = [h[q * L:(q + 1) * L][send[q, p]] for q in range(P)]
        tables.append(torch.cat([h[p * L:(p + 1) * L]] + halo))
        assert tables[-1].shape == (L + P * H, F)
    return tables


def _hier_tables(pg, plan, h):
    P, L = pg.num_parts, pg.nodes_per_part
    CP, HP = plan.chips_per_host, plan.hosts
    intra_idx = torch.from_numpy(plan.send_idx_intra.astype(np.int64))
    inter_idx = torch.from_numpy(plan.send_idx_inter.astype(np.int64))
    shard = lambda q: h[q * L:(q + 1) * L]  # noqa: E731
    tables = []
    for p in range(P):
        a, c = divmod(p, CP)
        # Rows each chip of this host sent this chip, in chip order.
        intra = [shard(a * CP + cq)[intra_idx[a * CP + cq, c]]
                 for cq in range(CP)]
        # Per source lane c2 and source host b: the rows (b, c2) sent to
        # host a (its all-to-all on lane c2, gathered over the lanes).
        inter = [shard(b * CP + c2)[inter_idx[b * CP + c2, a]]
                 for c2 in range(CP) for b in range(HP)]
        tables.append(torch.cat([shard(p)] + intra + inter))
    return tables


def exchange_ranks(rank, world, *, h, send_idx, hier):
    """On each rank: the flat exchange (and, with ``hier``, the hierarchical
    one on a (2, world // 2) mesh) of its shard, with the gradients of
    ``sum(table * g)`` for a fixed ``g`` per rank."""
    from keras_geometric_tpu_torch.parallel import halo, make_mesh

    mesh = make_mesh(device_type="cpu")
    L = h.shape[0] // world
    out = {}
    h_local = torch.from_numpy(h[rank * L:(rank + 1) * L]).requires_grad_()
    table = halo.exchange(h_local, torch.from_numpy(send_idx[rank]),
                          group=mesh.get_group("graph"))
    g = torch.from_numpy(np.random.default_rng(100 + rank).standard_normal(
        tuple(table.shape)).astype(np.float32))
    (table * g).sum().backward()
    out["flat"] = (table.detach().numpy(), h_local.grad.numpy(), g.numpy())
    # The overlapped form's halo block, waited on, is the same rows.
    halo_rows, work = halo.exchange_start(
        h_local.detach(), torch.from_numpy(send_idx[rank]),
        group=mesh.get_group("graph"))
    work.wait()
    out["start"] = halo_rows.numpy()
    if hier is not None:
        intra, inter = hier
        mesh2 = make_mesh((2, world // 2), ("host", "chip"),
                          device_type="cpu")
        assert tuple(mesh2.get_coordinate()) == divmod(rank, world // 2)
        h_local.grad = None
        table = halo.exchange_hier(
            h_local, torch.from_numpy(intra[rank]),
            torch.from_numpy(inter[rank]),
            host_group=mesh2.get_group("host"),
            chip_group=mesh2.get_group("chip"))
        g = torch.from_numpy(np.random.default_rng(200 + rank)
                             .standard_normal(tuple(table.shape))
                             .astype(np.float32))
        (table * g).sum().backward()
        out["hier"] = (table.detach().numpy(), h_local.grad.numpy(),
                       g.numpy())
    return out


def _check(tables, results, key, pg, h_t, ids):
    """Each rank's table equals the host's; its gradient equals autograd's
    over the host-built tables (f32 sums in another order: 1e-5); every
    edge's sender row is the global one."""
    loss = 0
    for p, res in enumerate(results):
        table, _, g = res[key]
        np.testing.assert_array_equal(table, tables[p].detach().numpy())
        loss = loss + (tables[p] * torch.from_numpy(g)).sum()
        valid = pg.edge_mask[p]
        np.testing.assert_array_equal(
            table[ids[p][valid]], h_t.detach().numpy()[pg.senders_global[p]
                                                       [valid]])
    loss.backward()
    L = pg.nodes_per_part
    for p, res in enumerate(results):
        np.testing.assert_allclose(res[key][1],
                                   h_t.grad[p * L:(p + 1) * L].numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_exchanges_over_gloo_match_the_host_tables(world, tmp_path):
    pg, h = _inputs(world)
    plan = t_halo.build_halo_plan(pg)
    hier = None
    if world == 4:
        hplan = t_halo.build_hier_halo_plan(pg, 2)
        hier = (hplan.send_idx_intra, hplan.send_idx_inter)
    results = run_ranks(exchange_ranks, world, tmp_path, h=h,
                        send_idx=plan.send_idx, hier=hier)
    h_t = torch.from_numpy(h).requires_grad_()
    _check(_flat_tables(pg, plan, h_t), results, "flat", pg, h_t,
           plan.senders_local)
    L = pg.nodes_per_part
    for p, res in enumerate(results):
        np.testing.assert_array_equal(res["start"], res["flat"][0][L:])
    if hier is not None:
        h_t = torch.from_numpy(h).requires_grad_()
        _check(_hier_tables(pg, hplan, h_t), results, "hier", pg, h_t,
               hplan.senders_local)
