"""PyTorch port: the backward of the band attention and the band SpMM
against ``jax.grad`` of the JAX package (CPU; the port's autograd Functions
run their plain backward versions, the JAX side its plain band ops on every
row and its Pallas kernels, in interpret mode, on the real rows), and the
compressed band index that the CUDA backward kernels walk.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_pressure_estimation_tpu.ops import banded as jax_bops
from gnn_pressure_estimation_tpu.ops.pallas.band_attention import (
    make_band_attention_dma,
    make_band_spmm_flash,
)
from gnn_pressure_estimation_tpu_torch.core.graph import GraphTemplate
from gnn_pressure_estimation_tpu_torch.ops import banded as bops
from gnn_pressure_estimation_tpu_torch.ops.band_attention import (
    band_attention, band_attention_bwd, band_attention_bwd_plain, band_attention_plain,
)
from gnn_pressure_estimation_tpu_torch.ops.band_spmm import (
    band_spmm, band_spmm_bwd, band_spmm_bwd_plain, band_spmm_plain,
)
from helpers import random_graph

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 1e-5      # the tolerance of tests/test_layers.py for kernel gradients


def _attention_inputs(rng, nB, B, BLK, W, H, C):
    adj = rng.random((nB, BLK, W)) < 0.3
    adj[-1, -4:, :] = False              # padded (fully masked) rows
    n_pad, n_ext = nB * BLK, nB * BLK + W - BLK
    a_dst = rng.standard_normal((B, n_pad, H)).astype(np.float32)
    a_src = rng.standard_normal((nB, B, W, H)).astype(np.float32)
    x_ext = rng.standard_normal((B, n_ext, H, C)).astype(np.float32)
    g = rng.standard_normal((B, n_pad, H, C)).astype(np.float32)
    return adj, a_dst, a_src, x_ext, g


def _port_attention_grads(adj, a_dst, a_src, x_ext, g):
    args = [torch.from_numpy(a).requires_grad_() for a in (a_dst, a_src, x_ext)]
    out = band_attention(*args, torch.from_numpy(adj), 0.2)
    return torch.autograd.grad((torch.tanh(out) * torch.from_numpy(g)).sum(), args)


@pytest.mark.parametrize("H,C,W", [(2, 64, 40), (1, 128, 200), (2, 8, 70)])
def test_band_attention_backward_matches_jax(rng, H, C, W):
    nB, B, BLK = 3, 2, 16
    adj, a_dst, a_src, x_ext, g = _attention_inputs(rng, nB, B, BLK, W, H, C)
    got = _port_attention_grads(adj, a_dst, a_src, x_ext, g)
    adjj = jnp.asarray(adj)

    # every row (the fully masked ones too) against the plain JAX band ops
    def plain(ad, asr, xe):
        x_win = jax_bops.band_windows_ext(xe, nB, BLK, W)
        return jax_bops.band_attention(ad, asr, x_win, adjj, 0.2)

    jargs = (jnp.asarray(a_dst), jnp.asarray(a_src), jnp.asarray(x_ext))
    ref = jax.grad(lambda a: jnp.sum(jnp.tanh(plain(*a)) * jnp.asarray(g)))(jargs)
    for a, b, name in zip(got, ref, ("a_dst", "a_src_win", "x_ext")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL, err_msg=name)

    if (H * C) % 128 == 0:
        # real rows against the v2 Pallas kernel's own backward (it averages a
        # fully masked row over W_pad, not W: those rows' cotangent is zeroed)
        valid = adj.any(-1).reshape(-1)[None, :, None, None].astype(np.float32)
        att = make_band_attention_dma(nB, BLK, W, (W - BLK) // 2, 0.2, interpret=True)
        ker = jax.grad(lambda a: jnp.sum(jnp.tanh(att(*a, adjj)) * jnp.asarray(g * valid)))(jargs)
        got_v = _port_attention_grads(adj, a_dst, a_src, x_ext, g * valid)
        for a, b, name in zip(got_v, ker, ("a_dst", "a_src_win", "x_ext")):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL,
                                       err_msg=name)


def test_fully_masked_rows_spread_their_cotangent(rng):
    """A row with no set column averages its window: its cotangent reaches
    the W window rows of x_ext as d_out / W and the a's not at all."""
    nB, B, BLK, W, H, C = 2, 1, 8, 24, 1, 4
    adj = np.zeros((nB, BLK, W), bool)
    a_dst = rng.standard_normal((B, nB * BLK, H)).astype(np.float32)
    a_src = rng.standard_normal((nB, B, W, H)).astype(np.float32)
    x_ext = rng.standard_normal((B, nB * BLK + W - BLK, H, C)).astype(np.float32)
    d_out = np.zeros((B, nB * BLK, H, C), np.float32)
    d_out[0, BLK + 3] = 1.0                                  # one row of block 1
    d_ad, d_as, d_x = band_attention_bwd(*map(torch.from_numpy, (a_dst, a_src, x_ext, adj, d_out)))
    assert not d_ad.any() and not d_as.any()
    want = np.zeros_like(x_ext)
    want[0, BLK: BLK + W] = 1.0 / W
    np.testing.assert_allclose(d_x.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("C", [128, 300])
@pytest.mark.parametrize("int8", [False, True])
def test_band_spmm_backward_matches_jax(rng, C, int8):
    nB, B, BLK, W = 3, 2, 16, 200
    n_ext = nB * BLK + W - BLK
    on = rng.random((nB, BLK, W)) < 0.3
    band = (on * rng.integers(1, 4, on.shape)).astype(np.int8) if int8 else \
        (on * rng.random(on.shape)).astype(np.float32)
    x_ext = rng.standard_normal((B, n_ext, C)).astype(np.float32)
    g = rng.standard_normal((B, nB * BLK, C)).astype(np.float32)
    xe = torch.from_numpy(x_ext).requires_grad_()
    out = band_spmm(torch.from_numpy(band), xe)
    (got,) = torch.autograd.grad((torch.tanh(out) * torch.from_numpy(g)).sum(), xe)

    jband = jnp.asarray(band)

    def plain(x):
        return jax_bops.band_spmm(jband.astype(jnp.float32), jax_bops.band_windows_ext(x, nB, BLK, W))

    ref = jax.grad(lambda x: jnp.sum(jnp.tanh(plain(x)) * jnp.asarray(g)))(jnp.asarray(x_ext))
    # each value sums ~60 products in another order; the counts (up to 3) scale them
    atol = 3 * ATOL if int8 else ATOL
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=atol)
    if C % 128 == 0:         # the Pallas SpMM needs lane-aligned channels
        spmm = make_band_spmm_flash(nB, BLK, W, (W - BLK) // 2, interpret=True)
        ker = jax.grad(lambda x: jnp.sum(jnp.tanh(spmm(jband, x)) * jnp.asarray(g)))(
            jnp.asarray(x_ext))
        np.testing.assert_allclose(got.numpy(), np.asarray(ker), rtol=RTOL, atol=atol)


def test_plain_backwards_match_autograd_through_plain_forwards(rng):
    adj, a_dst, a_src, x_ext, g = _attention_inputs(rng, 3, 2, 8, 30, 2, 5)
    args = [torch.from_numpy(a).requires_grad_() for a in (a_dst, a_src, x_ext)]
    mask, d_out = torch.from_numpy(adj.astype(np.int8)), torch.from_numpy(g)
    ref = torch.autograd.grad((band_attention_plain(*args, mask, 0.2) * d_out).sum(), args)
    got = band_attention_bwd_plain(*[a.detach() for a in args], mask, d_out, 0.2)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)

    band = torch.from_numpy((adj * rng.random(adj.shape)).astype(np.float32))
    xe = torch.from_numpy(rng.standard_normal((2, 3 * 8 + 30 - 8, 7)).astype(np.float32))
    xe.requires_grad_()
    d = torch.from_numpy(rng.standard_normal((2, 24, 7)).astype(np.float32))
    (ref,) = torch.autograd.grad((band_spmm_plain(band, xe) * d).sum(), xe)
    torch.testing.assert_close(band_spmm_bwd(band, d), ref, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(band_spmm_bwd_plain(band, d), ref, rtol=1e-5, atol=1e-6)


def test_gradcheck_float64(rng):
    nB, B, BLK, W, H, C = 2, 1, 4, 10, 2, 3
    adj = rng.random((nB, BLK, W)) < 0.4
    adj[0, 1] = False                                        # one fully masked row
    n_pad, n_ext = nB * BLK, nB * BLK + W - BLK
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s)).requires_grad_()  # noqa: E731
    mask = torch.from_numpy(adj)
    assert torch.autograd.gradcheck(
        lambda ad, asr, xe: band_attention(ad, asr, xe, mask, 0.2),
        (mk(B, n_pad, H), mk(nB, B, W, H), mk(B, n_ext, H, C)), atol=1e-6)
    band = torch.from_numpy(adj * rng.random(adj.shape))
    assert torch.autograd.gradcheck(lambda xe: band_spmm(band, xe), (mk(B, n_ext, C),), atol=1e-6)


def test_band_that_requires_grad_raises(rng):
    band = torch.rand(2, 4, 10, requires_grad=True)
    with pytest.raises(ValueError, match="no gradient"):
        band_spmm(band, torch.zeros(1, 14, 3))
    # the int8 count band cannot ask for one, and gets none
    xe = torch.zeros(1, 14, 3, requires_grad=True)
    cnt = torch.ones(2, 4, 10, dtype=torch.int8)
    band_spmm(cnt, xe).sum().backward()
    assert xe.grad is not None and cnt.grad is None


def _emulate_index_walk(ix, p, dz, d_out, W):
    """What the column pass of the CUDA backward does with a BandIndex, in
    numpy: per extended row, the weighted sum over the entries that read it
    and the per-block sums of dz."""
    n_ext = len(ix.t_ptr) - 1
    d_x = np.zeros((n_ext,) + d_out.shape[1:], np.float64)
    d_as = np.zeros((ix.nB, W), np.float64)
    for e in range(n_ext):
        for t in range(ix.t_ptr[e], ix.t_ptr[e + 1]):
            k, g = ix.t_entry[t], ix.t_row[t]
            d_x[e] += p[k] * d_out[g]
            d_as[g // ix.BLK, e - (g // ix.BLK) * ix.BLK] += dz[k]
    return d_x, d_as


@pytest.mark.parametrize("source", ["random", "template"])
def test_band_index_reproduces_the_dense_band(rng, source):
    if source == "random":
        band = ((rng.random((3, 16, 70)) < 0.3) * rng.random((3, 16, 70))).astype(np.float32)
        band[-1, -5:] = 0.0
    else:
        jt = random_graph(rng, n=70, extra_edges=40)
        tpl = GraphTemplate(jt.n_node, jt.senders, jt.receivers)
        band = tpl.band_layout(16).adj_cnt
        assert tpl.band_index("adj_cnt", 16) is tpl.band_index("adj_cnt", 16)   # cached
    nB, BLK, W = band.shape
    ix = bops.build_band_index(band)
    assert ix.nnz == np.count_nonzero(band) and ix.row_ptr[-1] == ix.t_ptr[-1] == ix.nnz
    # row lists rebuild the band
    dense = np.zeros_like(band, dtype=np.float32)
    for g in range(nB * BLK):
        for k in range(ix.row_ptr[g], ix.row_ptr[g + 1]):
            dense[g // BLK, g % BLK, ix.col[k]] = ix.val[k]
    np.testing.assert_array_equal(dense, band.astype(np.float32))
    # transposed lists: sorted by row within an extended row, each entry once
    assert sorted(ix.t_entry.tolist()) == list(range(ix.nnz))
    for e in range(len(ix.t_ptr) - 1):
        rows = ix.t_row[ix.t_ptr[e]: ix.t_ptr[e + 1]]
        assert (np.diff(rows) > 0).all()
        for t in range(ix.t_ptr[e], ix.t_ptr[e + 1]):
            k, g = ix.t_entry[t], ix.t_row[t]
            assert ix.row_ptr[g] <= k < ix.row_ptr[g + 1] and (g // BLK) * BLK + ix.col[k] == e
    empty = np.nonzero(~band.reshape(nB * BLK, W).any(-1))[0]
    np.testing.assert_array_equal(ix.empty_row, empty)
    np.testing.assert_array_equal(np.diff(ix.empty_ptr), np.bincount(empty // BLK, minlength=nB))
    # walking the index gives the plain SpMM backward and the a_src fold
    d_out = rng.standard_normal((nB * BLK, 5))
    d_x, d_as = _emulate_index_walk(ix, ix.val, ix.val, d_out, W)
    want = band_spmm_bwd_plain(torch.from_numpy(np.asarray(band, np.float64)),
                               torch.from_numpy(d_out)[None])[0]
    np.testing.assert_allclose(d_x, want.numpy(), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(d_as, np.asarray(band, np.float64).sum(1), rtol=1e-6, atol=1e-9)
    # on tensors: built from the values
    on_tensor = bops.band_index_of(torch.from_numpy(np.ascontiguousarray(band)))
    assert torch.equal(on_tensor.col, torch.from_numpy(ix.col)) and on_tensor.nnz == ix.nnz
