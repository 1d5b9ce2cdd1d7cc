"""The window scatter's sender-order tables and the composed score kernel's
work list, on the CPU, against the JAX package.

The window scatter's CUDA kernel (``band_cuda.window_scatter_sum``) walks the
window-eligible slots in sender order: a list built from ``sender_tab``
alone, a row pointer over every window's rows and that list's pieces of at
most 32 slots. These tests rebuild the kernel's sums from those tables in
the kernel's order (each piece summed in f32 in slot order, a split row's
shares added in piece order) and hold them against the reference's Pallas
kernel run as ``tests/test_torch_band.py`` runs it, on a plan with a row of
at least 40 eligible slots, a window no chunk chose and a padded tail. The
composed score kernel (``sddmm_cuda.sddmm_scores_sorted``) walks the pieces
of ``row_ptr`` and reads each slot's receiver from its piece: the tests pin
that ``GraphContext.sddmm_scores`` hands it ``row_ptr``, that a tensor on the
card without it is refused, that the pieces cover every slot of a padded
stream with its own receiver, and that the CPU path still matches the
reference.

Tolerances: the table sums against the Pallas kernel 2e-5 (f32) and one bf16
unit in the last place (bf16), as in ``tests/test_torch_band.py``; the f64
sum of the tables against the Pallas kernel the same; the scores 1e-4 (f32)
and 2e-2 (bf16), as in ``tests/test_torch_softmax_sddmm_kernels.py``.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import keras_geometric_tpu_torch as kgt_torch
from keras_geometric_tpu.kernels import band_pallas, sddmm_pallas, spmm_pallas
from keras_geometric_tpu_torch.kernels import band_cuda, sddmm_cuda, spmm_cuda

torch.set_num_threads(1)

N, WINDOW, CHUNK = 1_024, 256, 256
HUB, HUB_SLOTS = 384, 40  # a sender row of 40 slots or more (two pieces)
KERNEL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
          torch.bfloat16: dict(rtol=2.0 ** -7, atol=1e-3)}


def _window_case(seed=4, e=1_500):
    """Senders near their receivers; window 2 ([512, 768)) holds no sender,
    so no chunk chooses it; 40 slots whose receivers lie near HUB send from
    HUB; the stream is padded to the chunk grain."""
    rng = np.random.default_rng(seed)
    r = np.sort(rng.integers(0, N, e))
    s = np.clip(r + rng.integers(-100, 100, e), 0, N - 1)
    s = np.where((s >= 512) & (s < 768), s - 256, s)
    near = np.nonzero((r >= HUB - 20) & (r < HUB + 20))[0][:HUB_SLOTS]
    assert near.shape[0] == HUB_SLOTS
    s[near] = HUB
    e_pad = -(-e // CHUNK) * CHUNK
    senders = np.concatenate([s, np.full(e_pad - e, N - 1)])
    return senders, np.arange(e_pad) < e


def _plans():
    senders, eligible = _window_case()
    got = band_cuda.build_window_scatter_plan(
        senders, N, eligible, window=WINDOW, edge_chunk=CHUNK)
    want = band_pallas.build_window_scatter_plan(
        senders, N, eligible, window=WINDOW, edge_chunk=CHUNK)
    return got, want


def _pieces_sum(v, plan):
    """The kernel's sums from the plan's tables: each piece's slots added in
    f32 in list order (one fused multiply-add a slot with weight 1 rounds as
    a plain add), a split row's f32 shares added in piece order."""
    idx = plan.scatter_idx.numpy()
    work = plan.scatter_work
    rows = plan.num_windows * plan.window
    out = np.zeros((rows, v.shape[1]), np.float32)
    shares = np.zeros((work.num_shares, v.shape[1]), np.float32)
    for row, lo, hi, share in work.pieces.numpy():
        acc = np.zeros(v.shape[1], np.float32)
        for k in range(lo, hi):
            acc = acc + v[idx[k]]
        if share < 0:
            out[row] = acc
        else:
            shares[share] = acc
    fix_ptr = work.fix_ptr.numpy()
    for k, row in enumerate(work.fix_rows.numpy()):
        acc = np.zeros(v.shape[1], np.float32)
        for p in range(fix_ptr[k], fix_ptr[k + 1]):
            acc = acc + shares[p]
        out[row] = acc
    return out


def _row_walk_sum(v, plan):
    """A serial f32 walk of each row of the same list, no pieces."""
    idx = plan.scatter_idx.numpy()
    row_ptr = plan.scatter_row_ptr.numpy()
    out = np.zeros((row_ptr.shape[0] - 1, v.shape[1]), np.float32)
    for r in range(out.shape[0]):
        for k in range(row_ptr[r], row_ptr[r + 1]):
            out[r] = out[r] + v[idx[k]]
    return out


def _pallas_window_sum(v, tab, j_plan, dtype):
    j_dtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    with pltpu.force_tpu_interpret_mode():
        want = band_pallas.window_scatter_sum(
            jnp.asarray(v, j_dtype), jnp.asarray(tab), j_plan)
    return np.asarray(want, np.float32)


def test_window_tables_come_from_sender_tab_alone():
    (plan, mask, tab), (j_plan, j_mask, j_tab) = _plans()
    # The reference's arrays stay element for element the reference's.
    np.testing.assert_array_equal(mask, j_mask)
    np.testing.assert_array_equal(tab, j_tab)
    for name in ("work_win", "work_chunk", "work_flags"):
        np.testing.assert_array_equal(getattr(plan, name),
                                      getattr(j_plan, name))
    # The kernel's tables are a function of sender_tab: rebuilt from the
    # table alone (no senders, no eligibility), they are the same.
    idx, row_ptr = band_cuda._sender_order(tab, plan.num_windows * WINDOW)
    np.testing.assert_array_equal(plan.scatter_idx.numpy(), idx)
    np.testing.assert_array_equal(plan.scatter_row_ptr.numpy(), row_ptr)
    lengths = np.diff(row_ptr)
    assert lengths[HUB] >= HUB_SLOTS > spmm_cuda.RECV_BWD_PIECE
    assert not lengths[2 * WINDOW:3 * WINDOW].any()  # the empty window
    # Every row has a piece; the hub row is split, in slot order.
    work = plan.scatter_work
    pieces = work.pieces.numpy()
    np.testing.assert_array_equal(np.unique(pieces[:, 0]),
                                  np.arange(lengths.shape[0]))
    np.testing.assert_array_equal(work.fix_rows.numpy(),
                                  np.nonzero(lengths > 32)[0])
    assert HUB in work.fix_rows.numpy()
    hub = pieces[pieces[:, 0] == HUB]
    assert hub[:, 1].tolist() == [row_ptr[HUB], row_ptr[HUB] + 32]
    assert (hub[:, 3] >= 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [8, 16])
def test_window_tables_sum_to_the_jax_kernel(f, dtype):
    (plan, _, tab), (j_plan, _, _) = _plans()
    rng = np.random.default_rng(f)
    v = rng.standard_normal((tab.shape[0], f)).astype(np.float32)
    v = torch.from_numpy(v).to(dtype).float().numpy()  # the kernel's inputs
    want = _pallas_window_sum(v, tab, j_plan, dtype)
    # The f64 sum over the tables, in their order.
    idx = plan.scatter_idx.numpy()
    row_ptr = plan.scatter_row_ptr.numpy()
    exact = np.zeros((N, f))
    for r in range(N):
        exact[r] = v[idx[row_ptr[r]:row_ptr[r + 1]]].astype(np.float64).sum(0)
    got = torch.from_numpy(exact).to(dtype).float().numpy()
    np.testing.assert_allclose(got, want, **KERNEL[dtype])
    # The kernel's order: pieces, then the split row's shares.
    pieces = torch.from_numpy(_pieces_sum(v, plan)).to(dtype).float().numpy()
    np.testing.assert_allclose(pieces, want, **KERNEL[dtype])
    # The plain version (the CPU path) agrees too.
    plain = band_cuda.window_scatter_sum(torch.from_numpy(v).to(dtype),
                                         torch.from_numpy(tab), plan)
    np.testing.assert_allclose(plain.float().numpy(), want, **KERNEL[dtype])


def test_one_piece_rows_get_the_row_walk_bits():
    (plan, _, tab), _ = _plans()
    rng = np.random.default_rng(7)
    v = rng.standard_normal((tab.shape[0], 16)).astype(np.float32)
    pieces, rows = _pieces_sum(v, plan), _row_walk_sum(v, plan)
    one = np.diff(plan.scatter_row_ptr.numpy()) <= spmm_cuda.RECV_BWD_PIECE
    assert (~one).sum() == plan.scatter_work.fix_rows.shape[0] >= 1
    np.testing.assert_array_equal(pieces[one], rows[one])
    np.testing.assert_allclose(pieces[HUB], rows[HUB], rtol=1e-6,
                               atol=1e-6)


def _composed_case(dtype, heads=2, f=4, seed=5):
    rng = np.random.default_rng(seed)
    n, e = 40, 150
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    ctx = kgt_torch.prepare_graph(ei.astype(np.int32), n,
                                  add_self_loops=True, edge_chunk=64,
                                  device="cpu")
    ht = rng.standard_normal((n, heads * f)).astype(np.float32)
    att = rng.standard_normal((heads, f)).astype(np.float32)
    hj = ht[ctx.senders.numpy()]
    to = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
    return ctx, ht, hj, att, to


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_context_hands_the_score_kernel_its_row_ptr(monkeypatch, dtype):
    ctx, ht, hj, att, to = _composed_case(dtype)
    seen = {}
    real = sddmm_cuda.sddmm_scores_sorted

    def spy(*args, **kwargs):
        seen.update(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(sddmm_cuda, "sddmm_scores_sorted", spy)
    got = ctx.sddmm_scores(to(ht), to(hj), to(att))
    assert seen["row_ptr"] is ctx.row_ptr
    # On the CPU the wrapper takes the plain version, which matches the
    # reference's score kernel.
    j_dtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    recv = ctx.receivers.numpy()
    tables = spmm_pallas.build_row_tables(recv, ctx.num_nodes, edge_chunk=64,
                                          row_block=32)
    with pltpu.force_tpu_interpret_mode():
        want = sddmm_pallas.sddmm_scores_sorted(
            jnp.asarray(ht, j_dtype), jnp.asarray(hj, j_dtype),
            jnp.asarray(att, j_dtype), tables=tables, negative_slope=0.2)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)
    assert torch.equal(got, sddmm_cuda.sddmm_scores_sorted_plain(
        to(ht), to(hj), to(att), ctx.receivers))


def test_score_kernel_refuses_a_card_tensor_without_row_ptr():
    on_card = types.SimpleNamespace(is_cuda=True, shape=(4, 6))
    recv = torch.tensor([0, 0, 2, 3], dtype=torch.int32)
    with pytest.raises(ValueError, match="row_ptr is required"):
        sddmm_cuda.sddmm_scores_sorted(on_card, on_card, torch.ones(2, 3),
                                       recv)


def test_score_pieces_cover_every_slot_with_its_receiver():
    """The score kernel writes slot e's score from its piece's row: the
    pieces of a padded stream's row_ptr cover [0, E) once, in order, and
    each slot's receiver is its piece's row (the padded tail included)."""
    ctx, *_ = _composed_case(torch.float32)
    work = spmm_cuda.recv_bwd_work(ctx.row_ptr)
    pieces = work.pieces.numpy()
    e = ctx.receivers.shape[0]
    assert e > ctx.num_real_edges  # the stream has a padded tail
    np.testing.assert_array_equal(pieces[1:, 1], pieces[:-1, 2])
    assert pieces[0, 1] == 0 and pieces[-1, 2] == e
    assert (pieces[:, 2] - pieces[:, 1] <= spmm_cuda.RECV_BWD_PIECE).all()
    row_of_slot = np.repeat(pieces[:, 0], pieces[:, 2] - pieces[:, 1])
    np.testing.assert_array_equal(row_of_slot, ctx.receivers.numpy())
