"""Heads wider than 256 columns in the port's attention: ``GATv2Conv`` with
320 channels per head on a context, against the JAX package's layer on a
plain ``edge_index`` (pure XLA), forward and gradients; and, on a card, every
attention kernel at 320 and 512 columns per head against its plain version,
with the recomputed scores and the score-and-statistics kernel's outputs
bit for bit equal to the one-pass forward's.

On the CPU the context's kernels are their plain versions, so the CPU cases
pin the layer's arithmetic at these widths; the ``cuda`` cases (skipped
without a card) hold the wide kernels, which walk a head in 256-column slabs,
against the same plain versions.

Tolerance: 1e-4 relative to the largest entry (at least 1) against the
reference: both sides are f32 library ops in another order (ROADMAP D1).
On the card, f32 1e-4 and bf16 2e-2 of the largest entry, as
``tests/test_torch_two_pass_attend.py`` holds the narrow kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import keras_geometric_tpu_torch as kgt_torch
from keras_geometric_tpu.nn.gatv2_conv import GATv2Conv as JGATv2Conv
from keras_geometric_tpu_torch import convert
from keras_geometric_tpu_torch.kernels import attend_cuda, sddmm_cuda

torch.set_num_threads(1)

N, F_IN = 24, 6
TOL = 1e-4


def _graph(seed):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, N, 80)
    r = rng.integers(0, N - 2, 80)  # the last two nodes receive only loops
    keep = s != r
    ei = np.stack([s[keep], r[keep]]).astype(np.int32)
    x = rng.standard_normal((N, F_IN)).astype(np.float32)
    return ei, x


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale,
                               err_msg=what)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "composed"])
@pytest.mark.parametrize("heads,f", [(1, 320), (2, 300)])
def test_gatv2conv_wide_heads_on_a_context_match_jax(heads, f, fused):
    ei, x = _graph(heads)
    j_layer = JGATv2Conv(output_dim=f, heads=heads)
    params = j_layer.init(jax.random.PRNGKey(heads), F_IN)
    params["bias"] = params["bias"] + 0.05
    t_layer = kgt_torch.GATv2Conv(f, input_dim=F_IN, heads=heads,
                                  add_self_loops=False, fused_attend=fused,
                                  device="cpu")
    t_layer.load_state_dict(convert.params_from_jax(params))
    ctx = kgt_torch.prepare_graph(ei, N, add_self_loops=True, device="cpu")
    w = np.random.default_rng(7).standard_normal(
        (N, heads * f)).astype(np.float32)

    def j_loss(p, xx):
        out = j_layer.apply(p, xx, jnp.asarray(ei))
        return jnp.sum(out * w), out

    (_, j_out), (j_gp, j_gx) = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out = t_layer(xt, context=ctx)
    (out * torch.from_numpy(w)).sum().backward()
    _close(out.detach().numpy(), j_out, "forward")
    _close(xt.grad.numpy(), j_gx, "d x")
    for name, p in t_layer.named_parameters():
        _close(p.grad.numpy(), j_gp[name], f"d {name}")


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------


def _stream(seed, n=64, e_real=300, e=384):
    """Receiver-sorted stream with empty rows and padded slots in the last
    row, and its sender-sorted twin."""
    rng = np.random.default_rng(seed)
    allowed = np.array([i for i in range(n) if i % 7 != 3])
    recv = np.sort(rng.choice(allowed, e_real)).astype(np.int32)
    recv = np.concatenate([recv, np.full(e - e_real, n - 1, np.int32)])
    send = rng.integers(0, n, e).astype(np.int32)
    send[e_real:] = n - 1
    valid = np.arange(e) < e_real
    perm = np.argsort(send, kind="stable")
    return dict(
        n=n, e=e, recv=recv, send=send, valid=valid, perm=perm,
        row_ptr=np.searchsorted(recv, np.arange(n + 1)).astype(np.int32),
        row_ptr_bwd=np.searchsorted(
            send[perm], np.arange(n + 1)).astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("drop", [False, True], ids=["nodrop", "drop"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("heads,f", [(1, 320), (2, 512)])
def test_cuda_wide_kernels_match_plain_versions(heads, f, dtype, drop):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    c = _stream(f + heads)
    rng = np.random.default_rng(f)
    d = heads * f
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    ht = on(rng.standard_normal((c["n"], d)).astype(np.float32)).to(dtype)
    g = on(rng.standard_normal((c["n"], d)).astype(np.float32)).to(dtype)
    att = on(rng.standard_normal((heads, f)).astype(np.float32) / 8).to(dtype)
    send, recv, row_ptr = on(c["send"]), on(c["recv"]), on(c["row_ptr"])
    valid = on(c["valid"])
    drop_mask = drop_ss = None
    if drop:
        keep = ((rng.random((c["e"], heads)) < 0.7) / 0.7).astype(np.float32)
        drop_mask, drop_ss = on(keep).to(dtype), on(keep[c["perm"]]).to(dtype)
    graph = (send, recv, row_ptr)
    ss = (on(c["recv"][c["perm"]]), on(c["send"][c["perm"]]),
          on(c["row_ptr_bwd"]))
    tol = 1e-4 if dtype == torch.float32 else 2e-2

    def close(got, want, what):
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            a, b = a.float().cpu(), b.float().cpu()
            assert torch.equal(torch.isinf(a), torch.isinf(b)), what
            a, b = torch.nan_to_num(a, neginf=0.0), torch.nan_to_num(
                b, neginf=0.0)
            scale = max(1.0, b.abs().max().item())
            assert (a - b).abs().max().item() <= tol * scale, what

    kw = dict(edge_valid=valid, drop_mask=drop_mask)
    fwd = attend_cuda.sddmm_stats_agg_sorted(ht, *graph, att, **kw)
    close(fwd, attend_cuda.sddmm_stats_agg_sorted_plain(ht, *graph, att,
                                                        **kw), "K9")
    _, scores, m, l = fwd
    no_scores = attend_cuda.sddmm_stats_agg_sorted(ht, *graph, att,
                                                   emit_scores=False, **kw)
    assert torch.equal(no_scores[0], fwd[0])
    two = sddmm_cuda.sddmm_stats_sorted(ht, *graph, att, edge_valid=valid)
    for a, b in zip(two, (scores, m, l)):  # K8 equals K9 bit for bit
        assert torch.equal(a, b)
    agg = attend_cuda.attend_aggregate_sorted(scores, m, l, ht, *graph,
                                              drop_mask=drop_mask)
    close(agg, attend_cuda.attend_aggregate_sorted_plain(
        scores, m, l, ht, *graph, drop_mask=drop_mask), "K10a")
    rho = attend_cuda.attend_rho_sorted(g, scores, m, l, ht, *graph,
                                        drop_mask=drop_mask)
    close(rho, attend_cuda.attend_rho_sorted_plain(
        g, scores, m, l, ht, *graph, drop_mask=drop_mask), "K10b")
    rho_re = attend_cuda.attend_rho_sorted(g, None, m, l, ht, *graph,
                                           att=att, **kw)
    assert torch.equal(rho_re, rho)  # recomputed scores are the forward's
    bwd = attend_cuda.attend_recv_bwd_full_sorted(ht, g, *graph, att, scores,
                                                  m, l, rho, **kw)
    close(bwd, attend_cuda.attend_recv_bwd_full_sorted_plain(
        ht, g, *graph, att, scores, m, l, rho, **kw), "K10c")
    bwd_re = attend_cuda.attend_recv_bwd_full_sorted(ht, g, *graph, att, None,
                                                     m, l, rho, **kw)
    for a, b in zip(bwd_re, bwd):
        assert torch.equal(a, b)
    send_out = attend_cuda.attend_send_bwd_sorted(
        ht, g, *ss, att, m, l, rho, valid_ss=on(c["valid"][c["perm"]]).float(),
        drop_ss=drop_ss)
    close(send_out, attend_cuda.attend_send_bwd_sorted_plain(
        ht, g, *ss, att, m, l, rho,
        valid_ss=on(c["valid"][c["perm"]]).float(), drop_ss=drop_ss), "K10d")
    hj = ht.index_select(0, send.long()).contiguous()
    k7a = sddmm_cuda.sddmm_scores_sorted(ht, hj, att, recv, row_ptr=row_ptr)
    assert torch.equal(k7a[c["valid"]], scores[c["valid"]])
    ds = on(rng.standard_normal((c["e"], heads)).astype(np.float32))
    close(sddmm_cuda.sddmm_bwd_sorted(ht, hj, att, ds, recv,
                                      row_ptr=row_ptr),
          sddmm_cuda.sddmm_bwd_sorted_plain(ht, hj, att, ds, recv), "K7b")
    torch.cuda.synchronize()
