"""PyTorch port: the band attention over materialised windows (the
counterpart of ``make_band_attention``, v1) against the JAX package (CPU:
the port runs its plain versions, the JAX side its v1 Pallas kernel in
interpret mode on the real rows and its plain band ops on every row)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_pressure_estimation_tpu.ops import banded as jax_bops
from gnn_pressure_estimation_tpu.ops.pallas.band_attention import make_band_attention
from gnn_pressure_estimation_tpu_torch.core.graph import GraphTemplate
from gnn_pressure_estimation_tpu_torch.evaluation.infer import Inferencer
from gnn_pressure_estimation_tpu_torch.models.gatres import GATRes
from gnn_pressure_estimation_tpu_torch.ops import banded as bops
from gnn_pressure_estimation_tpu_torch.ops.band_attention import (
    band_attention, band_attention_bwd_plain, band_attention_window, band_attention_window_bwd,
    band_attention_window_bwd_plain, band_attention_window_fwd, band_attention_window_plain,
)
from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats
from helpers import random_graph
from test_torch_band_flash import attention_inputs

torch.set_num_threads(1)
FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)


def _window_inputs(rng, nB, B, BLK, W, H, C):
    """The operands of ``attention_inputs`` with the windows cut: x_win
    [nB, B, W, H, C] instead of the extended array."""
    adj, a_dst, a_src, x_ext, g = attention_inputs(rng, nB, B, BLK, W, H, C)
    x_win = bops.band_windows_ext(torch.from_numpy(x_ext), nB, BLK, W).numpy()
    return adj, a_dst, a_src, x_win, g


def _port_grads(adj, a_dst, a_src, x_win, g):
    args = [torch.from_numpy(a).requires_grad_() for a in (a_dst, a_src, x_win)]
    out = band_attention_window(*args, torch.from_numpy(adj), 0.2)
    return out.detach().numpy(), torch.autograd.grad(
        (torch.tanh(out) * torch.from_numpy(g)).sum(), args)


@pytest.mark.parametrize("nB,B,BLK,W,H,C", [(3, 2, 16, 200, 2, 64), (2, 1, 8, 520, 1, 128),
                                           (1, 2, 16, 40, 2, 64)])
def test_window_matches_pallas_v1_kernel(rng, nB, B, BLK, W, H, C):
    adj, a_dst, a_src, x_win, g = _window_inputs(rng, nB, B, BLK, W, H, C)
    valid = adj.any(-1).reshape(-1)
    gv = g * valid[None, :, None, None]          # the kernel pads W to 128: real rows only
    out, got = _port_grads(adj, a_dst, a_src, x_win, gv)
    assert np.isfinite(out).all()
    v1 = make_band_attention(nB, BLK, W, 0.2, interpret=True)
    adjj = jnp.asarray(adj)
    jargs = (jnp.asarray(a_dst), jnp.asarray(a_src), jnp.asarray(x_win))
    ref = np.asarray(v1(*jargs, adjj))
    np.testing.assert_allclose(out[:, valid], ref[:, valid], **FWD)
    ker = jax.grad(lambda a: jnp.sum(jnp.tanh(v1(*a, adjj)) * jnp.asarray(gv)))(jargs)
    for a, b, name in zip(got, ker, ("a_dst", "a_src_win", "x_win")):
        assert a.shape == b.shape, name           # the window layout on both sides
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **GRAD)


@pytest.mark.parametrize("nB,B,BLK,W,H,C", [(3, 2, 16, 200, 2, 64), (3, 2, 16, 70, 2, 8)])
def test_window_matches_plain_jax_band_attention_on_all_rows(rng, nB, B, BLK, W, H, C):
    adj, a_dst, a_src, x_win, g = _window_inputs(rng, nB, B, BLK, W, H, C)
    out, got = _port_grads(adj, a_dst, a_src, x_win, g)
    adjj = jnp.asarray(adj)
    jargs = (jnp.asarray(a_dst), jnp.asarray(a_src), jnp.asarray(x_win))
    ref = jax_bops.band_attention(*jargs, adjj, 0.2)
    np.testing.assert_allclose(out, np.asarray(ref), **FWD)
    jg = jax.grad(lambda a: jnp.sum(jnp.tanh(jax_bops.band_attention(*a, adjj, 0.2))
                                    * jnp.asarray(g)))(jargs)
    for a, b, name in zip(got, jg, ("a_dst", "a_src_win", "x_win")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **GRAD)


def test_window_backward_layout_and_fold(rng):
    """d a_src_win and d x_win come in window layout: zero in every cell no
    row of the block reads; folded, they are the extended-array route's
    cotangents; a fully masked row spreads d_out / W over its block's cells."""
    nB, B, BLK, W, H, C = 3, 2, 8, 30, 2, 5
    adj, a_dst, a_src, x_ext, g = attention_inputs(rng, nB, B, BLK, W, H, C)
    adj[-1, -4:, :] = True                       # no fully masked row in this part
    t = [torch.from_numpy(a) for a in (a_dst, a_src, x_ext)]
    mask, d_out = torch.from_numpy(adj), torch.from_numpy(g)
    x_win = bops.band_windows_ext(t[2], nB, BLK, W)
    d_ad, d_as, d_xw = band_attention_window_bwd(t[0], t[1], x_win, mask, d_out, 0.2)
    assert d_as.shape == (nB, B, W, H) and d_xw.shape == (nB, B, W, H, C)
    unread = ~adj.any(1)                                            # [nB, W]
    assert not d_as.numpy().transpose(0, 2, 1, 3)[unread].any()
    assert not d_xw.numpy().transpose(0, 2, 1, 3, 4)[unread].any()
    assert d_xw.numpy().transpose(0, 2, 1, 3, 4)[~unread].any()
    ref = band_attention_bwd_plain(*t, mask, d_out, 0.2)
    torch.testing.assert_close(d_ad, ref[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(d_as, ref[1], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(bops.fold_windows_ext(d_xw, BLK), ref[2], rtol=1e-5, atol=1e-6)
    # on the CPU the wrappers are the plain versions
    assert torch.equal(band_attention_window_fwd(t[0], t[1], x_win, mask, 0.2),
                       band_attention_window_plain(t[0], t[1], x_win, mask, 0.2))
    for a, b in zip((d_ad, d_as, d_xw),
                    band_attention_window_bwd_plain(t[0], t[1], x_win, mask, d_out, 0.2)):
        assert torch.equal(a, b)

    adj[1, 3, :] = False                          # one fully masked row of block 1
    only = torch.zeros_like(d_out)
    only[0, BLK + 3] = 1.0
    d_ad, d_as, d_xw = band_attention_window_bwd(t[0], t[1], x_win, torch.from_numpy(adj), only, 0.2)
    assert not d_ad.any() and not d_as.any()
    want = torch.zeros_like(d_xw)
    want[1, 0] = 1.0 / W
    torch.testing.assert_close(d_xw, want, rtol=1e-6, atol=0)


def test_window_gradcheck_float64(rng):
    nB, B, BLK, W, H, C = 2, 1, 4, 10, 2, 3
    adj = rng.random((nB, BLK, W)) < 0.4
    adj[0, 1] = False                                        # one fully masked row
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s)).requires_grad_()  # noqa: E731
    mask = torch.from_numpy(adj)
    assert torch.autograd.gradcheck(
        lambda ad, asr, xw: band_attention_window(ad, asr, xw, mask, 0.2),
        (mk(B, nB * BLK, H), mk(nB, B, W, H), mk(nB, B, W, H, C)), atol=1e-6)


def _cells_walk(ix, p_k, dz_k, d_out, B):
    """What the CUDA backward's last pass does with a BandIndex, in numpy:
    one window cell (block, column) at a time, the run of the entries of
    extended row blk·BLK + j that sit in the block."""
    nB, BLK, W = ix.nB, ix.BLK, ix.W
    d_as = np.zeros((nB, W) + dz_k.shape[1:])
    d_xw = np.zeros((nB, W) + d_out.shape[1:])
    for blk in range(nB):
        for j in range(W):
            e = blk * BLK + j
            for t in range(ix.t_ptr[e], ix.t_ptr[e + 1]):
                g = ix.t_row[t]
                if g // BLK == blk:
                    d_as[blk, j] += dz_k[ix.t_entry[t]]
                    d_xw[blk, j] += p_k[ix.t_entry[t]][:, None] * d_out[g]
    return d_as, d_xw


def test_cell_walk_of_the_kernel_reproduces_the_plain_backward(rng):
    nB, BLK, W, H, C = 3, 8, 40, 2, 5
    adj, a_dst, a_src, x_win, g = _window_inputs(rng, nB, 1, BLK, W, H, C)
    adj[-1, -4:, :] = True
    ix = bops.build_band_index(adj)
    f64 = lambda a: torch.from_numpy(a.astype(np.float64))  # noqa: E731
    ref = band_attention_window_bwd_plain(f64(a_dst), f64(a_src), f64(x_win), torch.from_numpy(adj),
                                          f64(g), 0.2)
    # per-entry softmax weight and logit cotangent, row by row (the kernel's first pass)
    p_k, dz_k = np.zeros((ix.nnz, H)), np.zeros((ix.nnz, H))
    for row in range(nB * BLK):
        blk, ks = row // BLK, slice(ix.row_ptr[row], ix.row_ptr[row + 1])
        cols = ix.col[ks]
        zpre = a_dst[0, row].astype(np.float64) + a_src[blk, 0, cols].astype(np.float64)   # [k, H]
        z = np.where(zpre >= 0, zpre, 0.2 * zpre)
        p = np.exp(z - z.max(0))
        p /= p.sum(0)
        dp = np.einsum("hc,khc->kh", g[0, row].astype(np.float64), x_win[blk, 0, cols])
        p_k[ks], dz_k[ks] = p, p * (dp - (p * dp).sum(0)) * np.where(zpre >= 0, 1.0, 0.2)
    d_as, d_xw = _cells_walk(ix, p_k, dz_k, g[0].astype(np.float64), 1)
    np.testing.assert_allclose(d_as, ref[1][:, 0].numpy(), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(d_xw, ref[2][:, 0].numpy(), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("route", ["flash", "window"])
def test_gatres_through_the_route_equals_the_default_route(rng, route):
    """The three routes are one function: a 2-block GATRes served through
    ``Inferencer(band_attn=route)`` gives the default route's fields, and its
    parameter gradients agree."""
    jt = random_graph(rng, n=70, extra_edges=40)
    tpl = GraphTemplate(jt.n_node, jt.senders, jt.receivers)
    model = GATRes(2, 8)
    model.reset_parameters(torch.Generator().manual_seed(3))
    snaps = rng.standard_normal((5, 70)).astype(np.float32)
    kw = dict(agg_mode="banded", band_block=16, device="cpu")
    base = Inferencer(model, NormStats(), **kw)
    obs = base.observed_indices(tpl, "random", mask_rate=0.8, seed=0)
    want = base.infer(tpl, snaps, obs, batch_size=2).pred
    got = Inferencer(model, NormStats(), band_attn=route, **kw).infer(tpl, snaps, obs, batch_size=2).pred
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    grads = []
    for r in ("dma", route):
        graph = tpl.batch(2, "banded", 16, "cpu", band_attn=r)
        x = graph.pack_nodes(torch.from_numpy(snaps[:2].reshape(-1, 1)), 70)
        grads.append(torch.autograd.grad((model(x, graph) ** 2).sum(), list(model.parameters())))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


def test_window_route_differentiates_through_band_windows(rng):
    """The layer cuts x_win with ``band_windows``; autograd folds the window
    cotangent back: the gradient on the node array equals the extended-array
    route's."""
    nB, B, BLK, W, H, C = 3, 2, 8, 24, 2, 4
    U = (W - BLK) // 2
    win_start = tuple(b * BLK - U for b in range(nB))
    adj, a_dst, a_src, _, g = attention_inputs(rng, nB, B, BLK, W, H, C)
    xp = torch.from_numpy(rng.standard_normal((B, nB * BLK, H, C)).astype(np.float32))
    mask, d_out = torch.from_numpy(adj), torch.from_numpy(g)
    ad, asr = torch.from_numpy(a_dst), torch.from_numpy(a_src)
    x1 = xp.clone().requires_grad_()
    out_w = band_attention_window(ad, asr, bops.band_windows(x1, win_start, W), mask, 0.2)
    x2 = xp.clone().requires_grad_()
    out_e = band_attention(ad, asr, bops.extend_rows(x2, U, W - U - BLK), mask, 0.2)
    torch.testing.assert_close(out_w, out_e, rtol=1e-6, atol=1e-6)
    (g1,), (g2,) = (torch.autograd.grad((o * d_out).sum(), x) for o, x in ((out_w, x1), (out_e, x2)))
    torch.testing.assert_close(g1, g2, rtol=1e-5, atol=1e-6)
