"""Port parity for the locality tier's host code: the node reorderings
(``ops/reorder.py``), the community graph generator and the band / window
plans (``kernels/band_cuda.py``) give the same arrays as the JAX package's,
element for element (all of it is host numpy, so equality is exact).
"""

import numpy as np
import pytest
import torch

import keras_geometric_tpu_torch as kgt_torch
from keras_geometric_tpu.data.datasets.synthetic import (
    community_graph as j_community_graph,
)
from keras_geometric_tpu.kernels import band_pallas
from keras_geometric_tpu.ops import reorder as j_reorder
from keras_geometric_tpu.ops.csr import prepare_graph as j_prepare
from keras_geometric_tpu_torch.data.datasets import community_graph
from keras_geometric_tpu_torch.kernels import band_cuda
from keras_geometric_tpu_torch.ops import reorder

torch.set_num_threads(1)


def _local_edges(n=700, e=4000, seed=0, directed=False):
    """Receiver-local senders with a far minority (as the reference's band
    tests draw them)."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, e // 2)
    s = np.clip(r + rng.integers(-100, 100, e // 2), 0, n - 1)
    far = rng.random(e // 2) < 0.2
    s[far] = rng.integers(0, n, far.sum())
    if directed:
        return np.stack([s, r])
    return np.stack([np.concatenate([s, r]), np.concatenate([r, s])])


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("inter_locality", [0.0, 0.3])
def test_community_graph_is_bit_equal_to_the_reference(seed, inter_locality):
    kw = dict(community_size=128, seed=seed, inter_locality=inter_locality)
    got = community_graph(2_000, 12_000, **kw)
    want = j_community_graph(2_000, 12_000, **kw)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_community_graph_options_follow_the_reference():
    kw = dict(p_intra=0.6, power=1.1, scramble=False, seed=3)
    np.testing.assert_array_equal(community_graph(1_000, 5_000, **kw),
                                  j_community_graph(1_000, 5_000, **kw))


@pytest.fixture(scope="module")
def scrambled():
    ei = j_community_graph(2_048, 24_000, community_size=256, seed=5)
    return ei[0].astype(np.int64), ei[1].astype(np.int64), 2_048


@pytest.mark.parametrize("chain", [True, False])
def test_cluster_order_and_lpa_equal_the_reference(scrambled, chain):
    s, r, n = scrambled
    np.testing.assert_array_equal(reorder.lpa_labels(s, r, n),
                                  j_reorder.lpa_labels(s, r, n))
    got = reorder.cluster_order(s, r, n, chain=chain)
    np.testing.assert_array_equal(got, j_reorder.cluster_order(
        s, r, n, chain=chain))
    inv = reorder.invert_order(got)
    np.testing.assert_array_equal(inv, j_reorder.invert_order(got))
    cov = reorder.band_coverage(inv[s], inv[r])
    assert cov == j_reorder.band_coverage(inv[s], inv[r])
    assert cov[1024] > reorder.band_coverage(s, r)[1024]


@pytest.mark.parametrize("hub_k", [0, 16])
def test_rcm_orders_equal_the_reference(scrambled, hub_k):
    s, r, n = scrambled
    np.testing.assert_array_equal(reorder.degree_order(s, r, n),
                                  j_reorder.degree_order(s, r, n))
    np.testing.assert_array_equal(reorder.rcm_order(s, r, n),
                                  j_reorder.rcm_order(s, r, n))
    np.testing.assert_array_equal(
        reorder.hub_rcm_order(s, r, n, hub_k=hub_k),
        j_reorder.hub_rcm_order(s, r, n, hub_k=hub_k))


def test_band_coverage_hot_window_equals_the_reference(scrambled):
    s, r, _ = scrambled
    kw = dict(windows=(256, 512), hot_k=64)
    assert reorder.band_coverage(s, r, **kw) == j_reorder.band_coverage(
        s, r, **kw)


@pytest.mark.parametrize("window,row_block", [(512, 256), (256, 256),
                                              (512, 128)])
@pytest.mark.parametrize("weighted", [True, False])
def test_band_plan_equals_the_reference(window, row_block, weighted):
    ei = _local_edges()
    w = None
    if weighted:
        w = np.random.default_rng(1).random(ei.shape[1]).astype(np.float32)
    n = 1_024
    got, local = band_cuda.build_band_plan(ei[0], ei[1], w, n, window=window,
                                           row_block=row_block)
    want, j_local = band_pallas.build_band_plan(ei[0], ei[1], w, n,
                                                window=window,
                                                row_block=row_block)
    np.testing.assert_array_equal(local, j_local)
    np.testing.assert_array_equal(got.band.numpy(), np.asarray(want.band))
    np.testing.assert_array_equal(got.base_idx.numpy(),
                                  np.asarray(want.base_idx))
    assert got.base_idx.dtype == torch.int32
    assert (got.window, got.row_block, got.num_edges, got.n_pad) == (
        want.window, want.row_block, want.num_edges, want.n_pad)
    # The clamp keeps every window inside [0, n_pad): the last block's too.
    base = got.base_idx.numpy().astype(np.int64) * (window // 2)
    assert base.min() >= 0 and base.max() + window <= n
    np.testing.assert_array_equal(
        band_cuda._block_base_rows(n, window, row_block),
        band_pallas._block_base_rows(n, window, row_block))


def test_band_plan_exclude_and_rejections_follow_the_reference():
    ei = _local_edges(directed=True)
    exclude = (ei[0] == ei[0, 0]) & (ei[1] == ei[1, 0])
    got, local = band_cuda.build_band_plan(ei[0], ei[1], None, 768,
                                           window=512, exclude=exclude)
    want, j_local = band_pallas.build_band_plan(ei[0], ei[1], None, 768,
                                                window=512, exclude=exclude)
    np.testing.assert_array_equal(local, j_local)
    np.testing.assert_array_equal(got.band.numpy(), np.asarray(want.band))
    # The fit criterion is endpoint-symmetric.
    _, local_t = band_cuda.build_band_plan(ei[1], ei[0], None, 768,
                                           window=512)
    _, local_f = band_cuda.build_band_plan(ei[0], ei[1], None, 768,
                                           window=512)
    np.testing.assert_array_equal(local_f, local_t)
    with pytest.raises(ValueError, match="multiple"):
        band_cuda.build_band_plan(np.array([0]), np.array([1]), None, 700,
                                  window=512)
    with pytest.raises(ValueError, match="multiple of 256"):
        band_cuda.build_band_plan(np.array([0]), np.array([1]), None, 1024,
                                  window=384)


@pytest.mark.parametrize("e,far_frac,chunk", [(1500, 0.25, 512),
                                              (300, 0.25, 256),
                                              (1500, 1.0, 512),
                                              (1500, 0.0, 1024)])
def test_window_scatter_plan_equals_the_reference(e, far_frac, chunk):
    rng = np.random.default_rng(2)
    n, window = 1_024, 256
    r = np.sort(rng.integers(0, n, e))
    s = np.clip(r + rng.integers(-120, 120, e), 0, n - 1)
    far = rng.random(e) < far_frac
    s[far] = rng.integers(0, n, int(far.sum()))
    e_pad = -(-e // chunk) * chunk
    senders = np.concatenate([s, np.full(e_pad - e, n - 1)])
    eligible = np.arange(e_pad) < e
    got, mask, tab = band_cuda.build_window_scatter_plan(
        senders, n, eligible, window=window, edge_chunk=chunk)
    want, j_mask, j_tab = band_pallas.build_window_scatter_plan(
        senders, n, eligible, window=window, edge_chunk=chunk)
    np.testing.assert_array_equal(mask, j_mask)
    np.testing.assert_array_equal(tab, j_tab)
    for name in ("work_win", "work_chunk", "work_flags"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    assert (got.window, got.num_windows, got.edge_chunk, got.num_band_edges,
            got.num_work) == (want.window, want.num_windows, want.edge_chunk,
                              want.num_band_edges, want.num_work)
    # The kernel's tables: row r's slots are the slots whose table entry is
    # r, in ascending order; the work list has a piece for every row of
    # every window (so every row is written).
    rows = got.num_windows * got.window
    idx = got.scatter_idx.numpy()
    row_ptr = got.scatter_row_ptr.numpy()
    assert row_ptr.shape == (rows + 1,) and row_ptr[0] == 0
    assert row_ptr[-1] == idx.shape[0] == got.num_band_edges
    for r in np.unique(tab[tab >= 0]):
        np.testing.assert_array_equal(idx[row_ptr[r]:row_ptr[r + 1]],
                                      np.nonzero(tab == r)[0])
    pieces = got.scatter_work.pieces.numpy()
    np.testing.assert_array_equal(np.unique(pieces[:, 0]), np.arange(rows))


def test_window_scatter_plan_rejections():
    with pytest.raises(ValueError, match="edge_chunk"):
        band_cuda.build_window_scatter_plan(np.zeros(100), 512,
                                            np.ones(100, bool), window=256,
                                            edge_chunk=64)
    with pytest.raises(ValueError, match="multiple of window"):
        band_cuda.build_window_scatter_plan(np.zeros(128), 500,
                                            np.ones(128, bool), window=256,
                                            edge_chunk=64)


CONTEXTS = {
    "symmetric_densified": dict(
        add_self_loops=True, gcn_normalize=True, symmetric=True,
        densify_self_loops=True, pad_nodes=True, band_window=512),
    "directed": dict(add_self_loops=True, gcn_normalize=True,
                     pad_nodes=True, band_window=512),
    "unit_weights": dict(pad_nodes=True, band_window=512),
    "both_tiers": dict(add_self_loops=True, pad_nodes=True, band_window=512,
                       attend_window=256, edge_chunk=128),
    "attend_window": dict(add_self_loops=True, pad_nodes=True,
                          attend_window=256),
    "attend_window_chunk": dict(add_self_loops=True, pad_nodes=True,
                                attend_window=512, attend_window_chunk=1024,
                                edge_chunk=256),
}
ARRAYS = ("senders", "receivers", "edge_weight", "bwd_perm", "senders_sorted",
          "edge_mask", "in_degree", "self_weight", "receivers_ss",
          "edge_weight_ss", "edge_mask_ss", "attw_sender", "attw_perm_res",
          "attw_res_weight", "attw_senders_res")


def _assert_contexts_equal(tc, jc):
    assert (tc.num_nodes, tc.num_real_edges, tc.num_edges, tc.num_diag,
            tc.num_band_edges, tc.num_real_nodes, tc.is_symmetric,
            tc.has_unit_weights) == (
        jc.num_nodes, jc.num_real_edges, jc.num_edges, jc.num_diag,
        jc.num_band_edges, jc.num_real_nodes, jc.is_symmetric,
        jc.has_unit_weights)
    for name in ARRAYS:
        a, b = getattr(tc, name), getattr(jc, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)
    for name in ("band", "band_bwd"):
        a, b = getattr(tc, name), getattr(jc, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a.band.numpy(), np.asarray(b.band))
            np.testing.assert_array_equal(a.base_idx.numpy(),
                                          np.asarray(b.base_idx))
            assert a.num_edges == b.num_edges
    assert (tc.attw_plan is None) == (jc.attw_plan is None)
    if tc.attw_plan is not None:
        for name in ("work_win", "work_chunk", "work_flags"):
            np.testing.assert_array_equal(getattr(tc.attw_plan, name),
                                          getattr(jc.attw_plan, name))
        # The residual's row pointers: the reference's tables reduce to them.
        senders_res = tc.attw_senders_res.numpy()
        np.testing.assert_array_equal(
            tc.attw_res_row_ptr.numpy(),
            np.searchsorted(senders_res, np.arange(tc.num_nodes + 1)))
    assert (tc.full is None) == (jc.full is None)
    if tc.full is not None:
        _assert_contexts_equal(tc.full, jc.full)


@pytest.mark.parametrize("kind", list(CONTEXTS))
def test_prepared_arrays_equal_the_reference(kind):
    kw = CONTEXTS[kind]
    ei = _local_edges(directed=kind != "symmetric_densified")
    tc = kgt_torch.prepare_graph(ei, 700, device="cpu", **kw)
    jc = j_prepare(ei, 700, **kw)
    _assert_contexts_equal(tc, jc)


def test_defaults_grains_and_companion_follow_the_reference():
    ei = _local_edges(directed=True)
    # attend_full_stream defaults to True on a band context only.
    band = kgt_torch.prepare_graph(ei, 700, pad_nodes=True, band_window=512,
                                   device="cpu")
    assert band.full is not None and band.full_stream() is band.full
    assert band.full.band is None and band.full.num_edges == band.num_edges
    off = kgt_torch.prepare_graph(ei, 700, pad_nodes=True, band_window=512,
                                  attend_full_stream=False, device="cpu")
    with pytest.raises(ValueError, match="attend_full_stream"):
        off.full_stream()
    with pytest.raises(ValueError, match="attend_full_stream"):
        off.gather(torch.zeros(off.num_nodes, 4))
    # The band-aware node grain: max(W/2, row block), at least W.
    small = kgt_torch.prepare_graph(np.array([[0, 1], [1, 0]]), 10,
                                    pad_nodes=True, band_window=1024,
                                    device="cpu")
    assert small.num_nodes == j_prepare(np.array([[0, 1], [1, 0]]), 10,
                                        pad_nodes=True,
                                        band_window=1024).num_nodes == 1024
    # E_pad at the window scatter's grain (2048 by default).
    win = kgt_torch.prepare_graph(ei, 700, add_self_loops=True,
                                  pad_nodes=True, attend_window=256,
                                  device="cpu")
    assert win.senders.shape[0] % 2048 == 0
    assert win.senders.shape[0] == j_prepare(
        ei, 700, add_self_loops=True, pad_nodes=True,
        attend_window=256).senders.shape[0]
    for kw in (dict(band_window=512), dict(attend_window=256)):
        with pytest.raises(ValueError, match="pad_nodes"):
            kgt_torch.prepare_graph(ei, 700, device="cpu", **kw)


def test_all_local_graph_keeps_the_residual_nonempty():
    n = 512
    s = np.arange(n)
    r = (s + 1) % n
    ei = np.stack([np.concatenate([s, r]), np.concatenate([r, s])])
    kw = dict(pad_nodes=True, band_window=512, symmetric=True)
    tc = kgt_torch.prepare_graph(ei, n, device="cpu", **kw)
    jc = j_prepare(ei, n, **kw)
    assert tc.num_real_edges > 0
    _assert_contexts_equal(tc, jc)


def test_placement_and_weight_dtype_reach_the_plans():
    ei = _local_edges(directed=True)
    ctx = kgt_torch.prepare_graph(ei, 700, add_self_loops=True,
                                  gcn_normalize=True, pad_nodes=True,
                                  band_window=512, attend_window=256,
                                  device="cpu")
    bf = ctx.with_weight_dtype(torch.bfloat16)
    assert bf.band.band.dtype == bf.band_bwd.band.dtype == torch.bfloat16
    assert bf.band.base_idx.dtype == torch.int32
    assert bf.edge_weight.dtype == bf.full.edge_weight.dtype == torch.bfloat16
    assert bf.full.attw_res_weight.dtype == torch.float32
    assert bf.full.attw_plan.scatter_idx.dtype == torch.int32
    np.testing.assert_array_equal(
        bf.band.band.float().numpy(),
        ctx.band.band.to(torch.bfloat16).float().numpy())
    moved = ctx.to("cpu")
    assert moved.band.band.device.type == "cpu"
    assert moved.full.attw_plan.scatter_work.pieces.device.type == "cpu"
    assert moved.full.attw_plan.work_win is ctx.full.attw_plan.work_win
