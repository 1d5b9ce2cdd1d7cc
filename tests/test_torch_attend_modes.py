"""Port parity for the selectable modes of the fused GATv2 attention:
``ATTEND_BWD_MODE`` ("permute" / "send") and ``ATTEND_SCORE_CACHE`` (True /
False) in ``ops/csr.py``, set together in the JAX package and in the port.

``GraphContext.attend``'s value and cotangents ``(d ht, d att)`` are held
against the reference's in all four combinations, without dropout, with a
dropout mask and its sender-order twin, and with a dropout mask alone (which
the send mode answers with the permute finish, as the reference does); spies
on the port's kernel wrappers check which finish and which forward ran.
Then ``GATv2Conv`` in send mode with attention dropout, whose mask pair is
drawn by ``edge_dropout.attention_keep_masks``, against the reference layer
fed the same pair. The whole ``jax.grad`` runs in Pallas interpret mode.

Tolerances: f32 1e-4 (the reference's f32 kernels split each operand into
two bf16 passes; ROADMAP D1); bf16 2e-2 (the reference rounds its terms to
bf16 before its sums, the port once at the store; ROADMAP D5); each relative
and times the result's largest entry (at least 1), since the reference's
error follows the size of the terms, not of each sum. Between the port's
own modes 1e-5 in f32: the same arithmetic summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import keras_geometric_tpu_torch as kgt_torch
from keras_geometric_tpu.nn.gatv2_conv import GATv2Conv as JGATv2Conv
from keras_geometric_tpu.ops import csr as j_csr
from keras_geometric_tpu.ops import edge_dropout as j_edge_dropout
from keras_geometric_tpu_torch import convert
from keras_geometric_tpu_torch.kernels import attend_cuda, spmm_cuda
from keras_geometric_tpu_torch.ops import csr as t_csr
from keras_geometric_tpu_torch.ops import edge_dropout

torch.set_num_threads(1)

N, HEADS, F, F_IN = 24, 2, 8, 5
PREPARE = dict(add_self_loops=True, edge_chunk=16)


def _graph(seed=0, e=70):
    """Random directed edges; the last three nodes receive only their
    self-loops, and the stream is padded (padded slots sit in the last
    node's row in both orders)."""
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, N, e), rng.integers(0, N - 3, e)])
    return ei.astype(np.int32)


def _contexts(ei):
    jc = j_csr.prepare_graph(ei, N, **PREPARE)
    tc = kgt_torch.prepare_graph(ei, N, device="cpu", **PREPARE)
    assert tc.edge_mask_ss is not None  # the stream has padded slots
    return jc, tc


def _set_modes(monkeypatch, mode, cache):
    for module in (j_csr, t_csr):
        monkeypatch.setattr(module, "ATTEND_BWD_MODE", mode)
        monkeypatch.setattr(module, "ATTEND_SCORE_CACHE", cache)


def _spy(monkeypatch, module, name):
    """Records the keyword arguments of each call of ``module.name``."""
    calls = []
    original = getattr(module, name)

    def wrapper(*args, **kwargs):
        calls.append(kwargs)
        return original(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapper)
    return calls


def _np(t):
    return t.detach().float().numpy()


def _assert_close(got, want, dtype, what):
    want = np.asarray(want, np.float32)
    tol = 1e-4 if dtype == "float32" else 2e-2
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _inputs(tc, dtype, drop, seed):
    rng = np.random.default_rng(seed)
    ht = rng.standard_normal((N, HEADS * F)).astype(np.float32)
    att = rng.standard_normal((HEADS, F)).astype(np.float32)
    g = rng.standard_normal((N, HEADS * F)).astype(np.float32)
    mask = mask_ss = None
    if drop != "nodrop":
        e_pad = int(tc.senders.shape[0])
        mask = ((rng.random((e_pad, HEADS)) < 0.7) / 0.7).astype(np.float32)
        if drop == "drop_ss":
            mask_ss = mask[tc.bwd_perm.numpy()]
    if dtype == "bfloat16":  # the values both sides see
        ht, att, g = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                      for a in (ht, att, g))
    return ht, att, g, mask, mask_ss


def _reference(jc, ht, att, g, mask, mask_ss, dtype):
    jd = jnp.dtype(dtype)
    j_mask = None if mask is None else jnp.asarray(mask, jd)
    j_mask_ss = None if mask_ss is None else jnp.asarray(mask_ss, jd)

    def attend(ht_, att_):
        return jc.attend(ht_, att_, drop_mask=j_mask, drop_mask_ss=j_mask_ss)

    args = (jnp.asarray(ht, jd), jnp.asarray(att, jd))
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(attend, *args)
        d_ht, d_att = vjp(jnp.asarray(g, jd))
    return [np.asarray(x.astype(jnp.float32)) for x in (out, d_ht, d_att)]


def _port(tc, ht, att, g, mask, mask_ss, dtype):
    td = getattr(torch, dtype)
    t_ht = torch.from_numpy(ht).to(td).requires_grad_(True)
    t_att = torch.from_numpy(att).to(td).requires_grad_(True)
    t_mask = None if mask is None else torch.from_numpy(mask).to(td)
    t_mask_ss = None if mask_ss is None else torch.from_numpy(mask_ss).to(td)
    out = tc.attend(t_ht, t_att, drop_mask=t_mask, drop_mask_ss=t_mask_ss)
    out.backward(torch.from_numpy(g).to(td))
    return [_np(x) for x in (out, t_ht.grad, t_att.grad)]


# Every combination with and without dropout in f32; the mask alone (the
# fallback) where it changes the path, in send mode; in bf16 the default and
# the combination that changes every kernel's mode.
CASES = [(mode, cache, drop, "float32")
         for mode in ("permute", "send") for cache in (True, False)
         for drop in ("nodrop", "drop_ss")]
CASES += [("send", cache, "drop_only", "float32") for cache in (True, False)]
CASES += [("permute", True, "drop_ss", "bfloat16"),
          ("send", False, "drop_ss", "bfloat16")]


@pytest.mark.parametrize("mode,cache,drop,dtype", CASES)
def test_attend_modes_match_jax(monkeypatch, mode, cache, drop, dtype):
    jc, tc = _contexts(_graph(seed=1))
    ht, att, g, mask, mask_ss = _inputs(tc, dtype, drop, seed=2)
    _set_modes(monkeypatch, mode, cache)
    ref = _reference(jc, ht, att, g, mask, mask_ss, dtype)

    fwd = _spy(monkeypatch, attend_cuda, "sddmm_stats_agg_sorted")
    send = _spy(monkeypatch, attend_cuda, "attend_send_bwd_sorted")
    finish = _spy(monkeypatch, spmm_cuda, "gather_scatter_sum_sorted")
    got = _port(tc, ht, att, g, mask, mask_ss, dtype)
    for what, a, b in zip(("value", "d ht", "d att"), got, ref):
        _assert_close(a, b, dtype, f"{what} ({mode}, cache={cache}, {drop})")

    # Which kernels ran: the forward keeps scores only with the cache; the
    # send finish runs unless a mask came without its sender-order twin.
    assert [c["emit_scores"] for c in fwd] == [cache]
    use_send = mode == "send" and drop != "drop_only"
    assert (len(send), len(finish)) == ((1, 0) if use_send else (0, 1))


@pytest.mark.parametrize("drop", ["nodrop", "drop_ss"])
def test_the_four_mode_combinations_agree_with_each_other(monkeypatch, drop):
    """The same attend in every combination gives the default's value
    exactly (the forward is one kernel either way) and its cotangents to
    f32 rounding."""
    _, tc = _contexts(_graph(seed=3))
    ht, att, g, mask, mask_ss = _inputs(tc, "float32", drop, seed=4)
    results = {}
    for mode in ("permute", "send"):
        for cache in (True, False):
            _set_modes(monkeypatch, mode, cache)
            results[mode, cache] = _port(tc, ht, att, g, mask, mask_ss,
                                         "float32")
    base = results["permute", True]
    for key, got in results.items():
        assert np.array_equal(got[0], base[0]), key
        for a, b in zip(got[1:], base[1:]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                       err_msg=str(key))


def test_an_unknown_mode_raises(monkeypatch):
    _, tc = _contexts(_graph(seed=5))
    ht, att, g, _, _ = _inputs(tc, "float32", "nodrop", seed=6)
    monkeypatch.setattr(t_csr, "ATTEND_BWD_MODE", "scatter")
    t_ht = torch.from_numpy(ht).requires_grad_(True)
    out = tc.attend(t_ht, torch.from_numpy(att))
    with pytest.raises(ValueError, match="ATTEND_BWD_MODE"):
        out.backward(torch.from_numpy(g))


def _layers(seed=0, **kwargs):
    j_layer = JGATv2Conv(**kwargs)
    params = j_layer.init(jax.random.PRNGKey(seed), F_IN)
    params["bias"] = params["bias"] + 0.1 * jnp.arange(
        params["bias"].shape[0], dtype=jnp.float32)
    kwargs = dict(kwargs)
    t_layer = kgt_torch.GATv2Conv(kwargs.pop("output_dim"), input_dim=F_IN,
                                  device="cpu", **kwargs)
    t_layer.load_state_dict(convert.params_from_jax(params))
    return j_layer, params, t_layer


@pytest.mark.parametrize("mode", ["permute", "send"])
def test_layer_dropout_draws_the_pair_in_send_mode_and_matches_jax(
        monkeypatch, mode):
    """``GATv2Conv`` trained with attention dropout on a context: in send
    mode it draws the mask pair with ``attention_keep_masks`` and the
    backward runs the sender kernel; in permute mode it draws one mask. The
    draw is replaced by the reference layer's own pair (from its key), so
    both layers see the same masks; output and parameter gradients match."""
    ei = _graph(seed=7)
    jc, tc = _contexts(ei)
    x = np.random.default_rng(8).standard_normal((N, F_IN)).astype(
        np.float32)
    kw = dict(output_dim=F, heads=HEADS, dropout=0.3, add_self_loops=False)
    j_layer = JGATv2Conv.for_context(F, heads=HEADS, dropout=0.3)
    _, params, t_layer = _layers(**kw)
    key = jax.random.PRNGKey(9)
    e_pad = int(tc.senders.shape[0])
    j_mask, j_mask_ss = j_edge_dropout.attention_keep_masks(
        key, e_pad, jc.bwd_perm, HEADS, 0.3, dtype=jnp.float32)
    pair = (torch.from_numpy(np.array(j_mask)),
            torch.from_numpy(np.array(j_mask_ss)))
    drawn = []

    def pair_draw(generator, num_edges, perm, heads, rate, dtype):
        drawn.append((num_edges, heads, rate, dtype))
        assert torch.equal(perm, tc.bwd_perm)
        return pair

    monkeypatch.setattr(edge_dropout, "attention_keep_masks", pair_draw)
    monkeypatch.setattr(edge_dropout, "keep_mask_at",
                        lambda *a, **k: pair[0])
    _set_modes(monkeypatch, mode, True)
    send = _spy(monkeypatch, attend_cuda, "attend_send_bwd_sorted")

    def j_loss(p):
        out = j_layer.apply(p, jnp.asarray(x), context=jc, training=True,
                            rng=key)
        return jnp.sum(out ** 2), out

    with pltpu.force_tpu_interpret_mode():
        (_, ref), ref_grads = jax.value_and_grad(j_loss, has_aux=True)(params)
    t_layer.train()
    out = t_layer(torch.from_numpy(x), context=tc,
                  generator=torch.Generator().manual_seed(0))
    (out ** 2).sum().backward()
    _assert_close(_np(out), ref, "float32", "layer output")
    for name, p in t_layer.named_parameters():
        _assert_close(_np(p.grad), ref_grads[name], "float32", name)
    if mode == "send":
        assert drawn == [(e_pad, HEADS, 0.3, torch.float32)]
        assert len(send) == 1 and send[0]["drop_ss"] is not None
    else:
        assert drawn == [] and send == []
