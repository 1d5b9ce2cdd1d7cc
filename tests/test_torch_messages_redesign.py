"""The messages-form scatter (K1, ``spmm_cuda.scatter_sum_sorted``) in its
CUDA kernel's order of summation, and the expand (K2,
``spmm_cuda.expand_sorted``) at pack counts that are not a power of two, on
the CPU, against the JAX package.

The kernel walks the pieces of ``spmm_cuda.recv_bwd_work(row_ptr,
split_piece=SPLIT_PIECE)``: a row of at most 32 slots is one piece, a longer
one (a hub, or the padded tail that ``prepare_graph`` puts in the last row)
comes in pieces of 8. Each piece is summed in f32 in slot order, each slot
adding its product ``w * message`` rounded to f32 (zero where masked); a
whole row is rounded once at the store, a split row's f32 shares are added
in piece order and then rounded once. The model below repeats that order in
numpy f32 and is held against the reference's Pallas kernel run in
interpret mode at ``Precision.HIGHEST``, on a stream with rows of 0, 1, 8,
9, 32, 33 slots and a 700-slot padded tail (Cora's shape: 708), and bit for
bit against a serial slot-order walk on every row of at most 32 slots.
The kernel's flat index arithmetic (an item's piece or slot by a
multiply-high and a shift) is held against integer division.

Tolerances: f32 1e-5 (ROADMAP D1: another order of f32 sums; the reference
at ``HIGHEST``); bf16 by ``chip_smoke.py``'s rule, ``1e-6 + 2e-5 * mass +
2**-7 * |reference|`` element by element (mass: the sum of the terms'
magnitudes). The reference rounds a weight to the data's type before its
product (ROADMAP D5), so bf16 data is weighted here by bf16 values, as the
training runs weight it. The expand is one product and one rounding: equal
to the reference's bits in f32, within one bf16 rounding in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from keras_geometric_tpu.kernels import spmm_pallas
from keras_geometric_tpu_torch.kernels import spmm_cuda

torch.set_num_threads(1)

PRECISION = jax.lax.Precision.HIGHEST
PIECE, SPLIT = spmm_cuda.RECV_BWD_PIECE, spmm_cuda.SPLIT_PIECE
# Slots of each row: empty, one, a piece of 8, 9, a whole piece, one more
# than a piece (split into 8s), some short rows, and the padded tail.
LENGTHS = (0, 1, 8, 9, 32, 33, 3, 0, 5, 12, 2, 700)
N = len(LENGTHS)
ATOL, RTOL_MASS, ULP_BF16 = 1e-6, 2e-5, 2.0 ** -7  # chip_smoke.py


def _stream():
    recv = np.repeat(np.arange(N), LENGTHS).astype(np.int32)
    row_ptr = np.concatenate([[0], np.cumsum(LENGTHS)]).astype(np.int32)
    return recv, row_ptr


def _work(row_ptr):
    return spmm_cuda.recv_bwd_work(torch.from_numpy(row_ptr),
                                   split_piece=SPLIT)


def _terms(msgs, w, mask):
    """Each slot's f32 term: the product rounded to f32, 0 where masked."""
    t = msgs.astype(np.float32)
    if w is not None:
        t = t * w.astype(np.float32)[:, None]
    if mask is not None:
        t = np.where(mask[:, None], t, np.float32(0.0))
    return t.astype(np.float32)


def _walk(terms):
    """f32 sum in slot order from 0."""
    acc = np.zeros(terms.shape[1], np.float32)
    for t in terms:
        acc = (acc + t).astype(np.float32)
    return acc


def _model(msgs, w, mask, row_ptr):
    """K1's messages form in the kernel's order, in f32 (not yet rounded to
    the data's type)."""
    work = _work(row_ptr)
    terms = _terms(msgs, w, mask)
    out = np.zeros((N, msgs.shape[1]), np.float32)
    part = np.zeros((work.num_shares, msgs.shape[1]), np.float32)
    for row, lo, hi, share in work.pieces.numpy():
        acc = _walk(terms[lo:hi])
        if share < 0:
            out[row] = acc
        else:
            part[share] = acc
    fix_ptr = work.fix_ptr.numpy()
    for k, row in enumerate(work.fix_rows.numpy()):
        out[row] = _walk(part[fix_ptr[k]:fix_ptr[k + 1]])
    return out


def _rounded(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).float().numpy()


def _inputs(f, dtype, weighted, masked, seed):
    recv, row_ptr = _stream()
    rng = np.random.default_rng(seed)
    msgs = _rounded(rng.standard_normal((recv.size, f)).astype(np.float32),
                    dtype)
    w = mask = None
    if weighted:
        w = _rounded(rng.uniform(0.05, 1.0, recv.size).astype(np.float32),
                     dtype)
    if masked:
        mask = rng.random(recv.size) < 0.8
    return recv, row_ptr, msgs, w, mask


def _jax_dtype(dtype):
    return jnp.float32 if dtype == torch.float32 else jnp.bfloat16


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("f", [4, 7, 16, 40])
def test_piece_order_matches_the_jax_kernel(f, dtype, weighted, masked):
    recv, row_ptr, msgs, w, mask = _inputs(f, dtype, weighted, masked,
                                           seed=f)
    got = _rounded(_model(msgs, w, mask, row_ptr), dtype)
    with pltpu.force_tpu_interpret_mode():
        ref = spmm_pallas.scatter_sum_sorted(
            jnp.asarray(msgs).astype(_jax_dtype(dtype)), jnp.asarray(recv), N,
            weights=None if w is None else jnp.asarray(w),
            mask=None if mask is None else jnp.asarray(mask),
            precision=PRECISION)
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == torch.float32:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        mass = np.zeros((N, f))
        np.add.at(mass, recv, np.abs(_terms(msgs, w, mask)))
        allowed = ATOL + RTOL_MASS * mass + ULP_BF16 * np.abs(ref)
        assert (np.abs(got - ref) <= allowed).all()
    # Empty rows are zero; every slot of the tail counted.
    assert not got[[0, 7]].any()


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
@pytest.mark.parametrize("f", [4, 7, 16, 40])
def test_rows_of_one_piece_get_a_serial_walks_bits(f, weighted, masked):
    """On a row of at most 32 slots the kernel's order is a serial walk's:
    the same f32 bits before the rounding, so the same bits after it in
    either type; a longer row sums the same terms in shares of 8."""
    recv, row_ptr, msgs, w, mask = _inputs(f, torch.float32, weighted,
                                           masked, seed=10 + f)
    got = _model(msgs, w, mask, row_ptr)
    terms = _terms(msgs, w, mask)
    for row in range(N):
        lo, hi = row_ptr[row], row_ptr[row + 1]
        serial = _walk(terms[lo:hi])
        if hi - lo <= PIECE:
            assert np.array_equal(got[row], serial)
        else:  # the same sum in another order
            np.testing.assert_allclose(got[row], serial, rtol=1e-5,
                                       atol=1e-5)


def test_pieces_cover_every_slot_once():
    """The list the kernel walks: the pieces tile [0, E) in order, each row
    has at least one (an empty row one empty piece), a row of at most 32
    slots is one piece, a longer one pieces of 8 whose shares are numbered
    in piece order, and it is the score backward's list on the same
    ``row_ptr``."""
    recv, row_ptr = _stream()
    work = _work(row_ptr)
    pieces = work.pieces.numpy()
    np.testing.assert_array_equal(pieces[1:, 1], pieces[:-1, 2])
    assert pieces[0, 1] == 0 and pieces[-1, 2] == recv.size
    np.testing.assert_array_equal(
        np.repeat(pieces[:, 0], pieces[:, 2] - pieces[:, 1]), recv)
    assert set(pieces[:, 0]) == set(range(N))
    split_rows = []
    for row, length in enumerate(LENGTHS):
        mine = pieces[pieces[:, 0] == row]
        sizes = mine[:, 2] - mine[:, 1]
        if length <= PIECE:
            assert len(mine) == 1 and sizes[0] == length and mine[0, 3] == -1
        else:
            split_rows.append(row)
            assert len(mine) == -(-length // SPLIT)
            assert (sizes[:-1] == SPLIT).all() and 0 < sizes[-1] <= SPLIT
    assert work.fix_rows.tolist() == split_rows
    shares = pieces[pieces[:, 3] >= 0, 3]
    np.testing.assert_array_equal(shares, np.arange(work.num_shares))
    fix_ptr = work.fix_ptr.numpy()
    for k, row in enumerate(split_rows):
        np.testing.assert_array_equal(
            pieces[pieces[:, 0] == row, 3],
            np.arange(fix_ptr[k], fix_ptr[k + 1]))
    from keras_geometric_tpu_torch.kernels import sddmm_cuda

    assert sddmm_cuda.BWD_SPLIT_PIECE == SPLIT


def _fast_div(x, d):
    """make_fast_div / fast_div of csrc/spmm.cu in Python integers."""
    if d == 1:
        return x
    log2 = (d - 1).bit_length()  # ceil(log2(d))
    mul = ((1 << (31 + log2)) + d - 1) // d
    assert mul < 1 << 32
    return ((x * mul) >> 32) >> (log2 - 1)


def test_flat_index_arithmetic_is_integer_division():
    """An item's piece (K1) or slot (K2) is its flat index over the pack
    count, by a multiply-high and a shift, for every index below 2^31."""
    rng = np.random.default_rng(4)
    edges = [0, 1, 2 ** 31 - 1, 2 ** 31 - 2, 2 ** 30, 2 ** 30 - 1]
    for d in list(range(1, 70)) + [80, 160, 255, 256, 320, 1433, 4096,
                                   65_537, 2 ** 20 + 1]:
        xs = edges + [int(x) for x in rng.integers(0, 2 ** 31, 200)]
        xs += [q * d + r for q in (0, 1, (2 ** 31 - 1) // d - 1)
               for r in (0, d - 1)]
        for x in xs:
            if 0 <= x < 2 ** 31:
                assert _fast_div(x, d) == x // d, (x, d)


def test_split_row_tickets_are_kept_zeroed_on_row_ptr():
    _, row_ptr = _stream()
    rp = torch.from_numpy(row_ptr)
    first = spmm_cuda._split_row_tickets(rp, 5)
    assert first.dtype == torch.int32 and first.numel() >= 5
    assert not first.any()
    assert spmm_cuda._split_row_tickets(rp, 3) is first
    wider = spmm_cuda._split_row_tickets(rp, 40)
    assert wider.numel() >= 40 and not wider.any()
    assert spmm_cuda._split_row_tickets(rp, 40) is wider


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("f", [4, 7, 16, 40])
def test_cpu_path_matches_the_model(f, dtype):
    """The wrapper on a CPU tensor (its plain version), forward, against
    the kernel's order: within one rounding of the data's type."""
    recv, row_ptr, msgs, w, mask = _inputs(f, dtype, True, True, seed=20 + f)
    got = spmm_cuda.scatter_sum_sorted(
        torch.from_numpy(msgs).to(dtype), torch.from_numpy(recv), N,
        row_ptr=torch.from_numpy(row_ptr), weights=torch.from_numpy(w),
        mask=torch.from_numpy(mask))
    assert got.dtype == dtype and got.shape == (N, f)
    model = _model(msgs, w, mask, row_ptr)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(), _rounded(model, dtype),
                               rtol=tol, atol=1e-5)


# Widths whose 16-byte pack count is not a power of two (f32: 4 values a
# pack, bf16: 8): 3, 5, 10 and 20 packs.
EXPAND_CASES = [(torch.float32, 12), (torch.float32, 20),
                (torch.float32, 40), (torch.bfloat16, 24),
                (torch.bfloat16, 40), (torch.bfloat16, 160)]


@pytest.mark.parametrize("dtype,f", EXPAND_CASES,
                         ids=[f"{str(d)[6:]}-F{f}" for d, f in EXPAND_CASES])
def test_expand_plain_matches_the_jax_kernel_with_weights_and_mask(dtype, f):
    """``expand_sorted_plain`` (the kernel's bits: one f32 product, one
    rounding, 0 where masked) against the reference's expand with weights,
    and against its scatter's VJP with weights and a mask."""
    recv, _, _, w, mask = _inputs(f, dtype, True, True, seed=30 + f)
    rng = np.random.default_rng(40 + f)
    rows = _rounded(rng.standard_normal((N, f)).astype(np.float32), dtype)
    t_rows = torch.from_numpy(rows).to(dtype)
    t_recv, t_w = torch.from_numpy(recv), torch.from_numpy(w)
    jdt = _jax_dtype(dtype)
    with pltpu.force_tpu_interpret_mode():
        ref = spmm_pallas.expand_sorted(
            jnp.asarray(rows).astype(jdt), jnp.asarray(recv),
            weights=jnp.asarray(w), precision=PRECISION)

        def scatter(m):
            return spmm_pallas.scatter_sum_sorted(
                m, jnp.asarray(recv), N, weights=jnp.asarray(w),
                mask=jnp.asarray(mask), precision=PRECISION)

        _, vjp = jax.vjp(scatter, jnp.zeros((recv.size, f), jdt))
        (ref_masked,) = vjp(jnp.asarray(rows).astype(jdt))
    got = spmm_cuda.expand_sorted_plain(t_rows, t_recv, weights=t_w)
    got_masked = spmm_cuda.expand_sorted_plain(t_rows, t_recv, weights=t_w,
                                               mask=torch.from_numpy(mask))
    # The kernel's arithmetic: the f32 product of the two values, rounded.
    exact = _rounded((rows[recv] * w[:, None]).astype(np.float32), dtype)
    assert np.array_equal(got.float().numpy(), exact)
    assert np.array_equal(got_masked.float().numpy(),
                          np.where(mask[:, None], exact, 0.0))
    for g, r in ((got, ref), (got_masked, ref_masked)):
        r = np.asarray(r.astype(jnp.float32))
        if dtype == torch.float32:
            assert np.array_equal(g.numpy(), r)
        else:
            np.testing.assert_allclose(g.float().numpy(), r, rtol=2.0 ** -7,
                                       atol=0)
    # The autograd wiring: the scatter's VJP is this expand, mask and all.
    msgs = torch.zeros(recv.size, f, dtype=dtype, requires_grad=True)
    spmm_cuda.scatter_sum_sorted(msgs, t_recv, N, weights=t_w,
                                 mask=torch.from_numpy(mask)).backward(t_rows)
    assert torch.equal(msgs.grad, got_masked)
