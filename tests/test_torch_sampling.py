"""The port's neighbour sampler against the JAX package's: ``uniform_sample``
and ``NeighborSampler`` give bit-equal results for the same seed on both the
native branch (``native/libgraph_core.so``, which both packages load) and the
numpy branch (the library patched away in both packages together); and the
reference's properties of the buckets and of ``prefetch`` hold.
"""

import numpy as np
import pytest

from keras_geometric_tpu import native as jnative
from keras_geometric_tpu.data import sampling as jsampling
from keras_geometric_tpu_torch import native as tnative
from keras_geometric_tpu_torch.data import sampling as tsampling

BRANCHES = ["native", "numpy"]


@pytest.fixture(params=BRANCHES)
def branch(request, monkeypatch):
    if request.param == "numpy":
        for module in (jnative, tnative):
            monkeypatch.setattr(module, "_lib", lambda: None)
    else:
        assert tnative.available() and jnative.available()
    assert tnative.available() == jnative.available() == (
        request.param == "native")
    return request.param


def skewed_graph(n=240, seed=0):
    """Nodes of degree 0 (the last 20), below and above 25 (a few hubs)."""
    rng = np.random.default_rng(seed)
    live = n - 20
    r = np.concatenate([rng.integers(0, live, 900),
                        rng.integers(0, 6, 240)])  # six hubs of ~45 each
    s = rng.integers(0, n, r.shape[0])
    return np.stack([s, r]).astype(np.int32), n


def test_the_graph_has_every_kind_of_node():
    ei, n = skewed_graph()
    deg = np.bincount(ei[1], minlength=n)
    assert (deg == 0).sum() >= 20 and (deg > 25).sum() >= 6
    assert ((deg > 0) & (deg < 5)).any() and ((deg > 10) & (deg < 25)).any()


@pytest.mark.parametrize("fanout", [1, 3, 10, 25])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_uniform_sample_matches_reference(branch, fanout, seed):
    ei, n = skewed_graph()
    order = np.argsort(ei[1], kind="stable")
    sorted_senders = ei[0][order]
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(ei[1], minlength=n), out=row_ptr[1:])
    seeds = np.random.default_rng(seed).permutation(n)[:64]
    seeds = np.concatenate([seeds, [n - 1, 0]])  # degree 0, a hub
    got = tnative.uniform_sample(sorted_senders, row_ptr, seeds, fanout,
                                 seed=seed)
    want = jnative.uniform_sample(sorted_senders, row_ptr, seeds, fanout,
                                  seed=seed)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    deg = np.diff(row_ptr)[seeds]
    assert ((got >= 0).sum(1) == np.minimum(deg, fanout)).all()
    for i, v in enumerate(seeds):  # every draw is an in-neighbour, no repeat
        picked = got[i][got[i] >= 0]
        pool = list(sorted_senders[row_ptr[v]:row_ptr[v + 1]])
        for g in picked:
            pool.remove(g)


def _buckets_equal(a, b):
    assert type(a).__name__ == type(b).__name__ == "SampledSubgraph"
    for field in ("node_map", "node_mask", "seed_ids", "seed_mask"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and x.shape == y.shape, field
        np.testing.assert_array_equal(x, y)
    assert len(a.layers) == len(b.layers)
    for la, lb in zip(a.layers, b.layers):
        for x, y in zip(la, lb):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("fanouts", [(5, 3), (25, 10)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sampler_buckets_are_bit_equal(branch, fanouts, seed):
    ei, n = skewed_graph()
    ref = jsampling.NeighborSampler(ei, n, fanouts, seed=seed)
    port = tsampling.NeighborSampler(ei, n, fanouts, seed=seed)
    # One padded batch with a degree-0 seed and a hub, then an epoch
    # (shuffled first, from the same generator), then another sample.
    seeds = np.array([n - 1, 0, 17, 3, 101])
    _buckets_equal(ref.sample(seeds, batch_size=8),
                   port.sample(seeds, batch_size=8))
    nodes = np.arange(0, n, 3)
    ref_epoch = list(ref.epoch(nodes, 16))
    port_epoch = list(port.epoch(nodes, 16))
    assert len(ref_epoch) == len(port_epoch) == -(-len(nodes) // 16)
    for a, b in zip(ref_epoch, port_epoch):
        _buckets_equal(a, b)
    _buckets_equal(ref.sample(seeds), port.sample(seeds))


def test_sampler_refuses_more_seeds_than_the_batch():
    ei, n = skewed_graph()
    with pytest.raises(ValueError, match="batch_size"):
        tsampling.NeighborSampler(ei, n, (3,)).sample(np.arange(5),
                                                      batch_size=4)


@pytest.mark.parametrize("fanouts", [(5, 3), (25, 10)])
def test_bucket_properties(branch, fanouts):
    """The reference's bucket contract: real edges, fanout respected,
    receiver-sorted real edges with trailing masked slots, first-seen local
    ids, capacities ``B * (1 + f0 + f0 * f1)``."""
    ei, n = skewed_graph()
    true_edges = set(zip(ei[0].tolist(), ei[1].tolist()))
    sampler = tsampling.NeighborSampler(ei.T, n, fanouts, seed=4)
    b = 8
    sub = sampler.sample(np.array([0, 1, 2, n - 1, 50]), batch_size=b)
    f0, f1 = fanouts
    assert sub.node_map.shape == (b * (1 + f0 + f0 * f1),)
    assert [l[0].shape[0] for l in sub.layers] == [b * f0, b * f0 * f1]
    np.testing.assert_array_equal(sub.node_mask, sub.node_map >= 0)
    used = int(sub.node_mask.sum())
    assert sub.node_mask[:used].all() and not sub.node_mask[used:].any()
    assert len(set(sub.node_map[:used].tolist())) == used
    for (s_loc, r_loc, mask), fanout in zip(sub.layers, fanouts):
        real = int(mask.sum())
        assert mask[:real].all() and not mask[real:].any()
        assert (np.diff(r_loc[:real]) >= 0).all()
        assert not s_loc[real:].any() and not r_loc[real:].any()
        for j in range(real):
            assert (sub.node_map[s_loc[j]], sub.node_map[r_loc[j]]) in \
                true_edges
        assert np.bincount(r_loc[mask]).max() <= fanout
    s, r, mask = sub.layers[0]
    counts = np.bincount(r[mask], minlength=b)
    assert counts.max() <= f0 and counts[3] == 0  # node n-1 has degree 0
    np.testing.assert_array_equal(sub.seed_mask, np.arange(b) < 5)


def test_fixed_shapes_across_batches():
    ei, n = skewed_graph()
    sampler = tsampling.NeighborSampler(ei, n, (5, 3))
    shapes = {(sub.node_map.shape, tuple(l[0].shape for l in sub.layers))
              for sub in sampler.epoch(np.arange(n), batch_size=8)}
    assert len(shapes) == 1


def test_prefetch_preserves_order_and_count():
    ei, n = skewed_graph()
    direct = list(tsampling.NeighborSampler(ei, n, (3,)).epoch(
        np.arange(n), 16, shuffle=False))
    fetched = list(tsampling.prefetch(tsampling.NeighborSampler(
        ei, n, (3,)).epoch(np.arange(n), 16, shuffle=False), depth=2))
    assert len(direct) == len(fetched) == n // 16
    for a, b in zip(direct, fetched):
        _buckets_equal(a, b)
    assert list(tsampling.prefetch(iter(range(7)), depth=1)) == list(range(7))


def test_prefetch_raises_what_the_iterator_raised():
    def items():
        yield 1
        yield 2
        raise KeyError("sampling failed")

    got = []
    with pytest.raises(KeyError, match="sampling failed"):
        for item in tsampling.prefetch(items(), depth=1):
            got.append(item)
    assert got == [1, 2]
