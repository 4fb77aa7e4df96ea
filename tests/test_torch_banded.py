"""PyTorch port: band layout, dense operators, packing and the plain band
ops against the JAX package (CPU; Pallas kernels in interpret mode)."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_pressure_estimation_tpu.core.graph import GraphTemplate as JaxTemplate
from gnn_pressure_estimation_tpu.data.dataset import build_template as jax_build_template
from gnn_pressure_estimation_tpu.data.dataset import get_keep_list as jax_keep_list
from gnn_pressure_estimation_tpu.data.inp import parse_inp as jax_parse_inp
from gnn_pressure_estimation_tpu.ops import banded as jax_bops
from gnn_pressure_estimation_tpu.ops.pallas.band_attention import (
    make_band_attention_dma,
    make_band_spmm_flash,
)
from gnn_pressure_estimation_tpu_torch.core.graph import GraphTemplate
from gnn_pressure_estimation_tpu_torch.data.dataset import build_template, get_keep_list
from gnn_pressure_estimation_tpu_torch.data.inp import parse_inp
from gnn_pressure_estimation_tpu_torch.ops import banded as bops
from gnn_pressure_estimation_tpu_torch.ops.band_attention import band_attention_fwd
from gnn_pressure_estimation_tpu_torch.ops.band_spmm import band_spmm_fwd
from helpers import random_graph

torch.set_num_threads(1)
MINITOWN = Path(__file__).resolve().parents[1] / "inputs" / "minitown.inp"


def _template_pair(kind, rng):
    if kind == "random":
        jt = random_graph(rng, n=70, extra_edges=40)
        return jt, GraphTemplate(jt.n_node, jt.senders, jt.receivers)
    keep = jax_keep_list(jax_parse_inp(str(MINITOWN)), "keep_junction", None, "pressure")
    jt, _ = jax_build_template(jax_parse_inp(str(MINITOWN)), keep, None)
    wn = parse_inp(str(MINITOWN))
    pt, _ = build_template(wn, get_keep_list(wn, "keep_junction", None, "pressure"), None)
    return jt, pt


@pytest.mark.parametrize("kind,block", [("random", 16), ("minitown", 8)])
def test_layout_operators_and_packing_match_jax(rng, kind, block):
    jt, pt = _template_pair(kind, rng)
    for name in ("senders", "receivers", "in_degree", "inv_degree"):
        np.testing.assert_array_equal(getattr(pt, name), getattr(jt, name))
    jd, pd = jt.dense_operators(), pt.dense_operators()
    assert jd.keys() == pd.keys()
    for k in jd:
        np.testing.assert_array_equal(pd[k], jd[k])

    jl, pl_ = jt.band_layout(block), pt.band_layout(block)
    for f in ("n", "n_pad", "BLK", "W", "win_start"):
        assert getattr(pl_, f) == getattr(jl, f), f
    for f in ("perm", "inv_perm", "adj_mask", "mean_band", "gcn_band", "cheb_band",
              "adj_band", "adj_cnt", "adj_cnt_sl", "inv_deg_perm", "dinv_sl_perm", "dinv_perm"):
        np.testing.assert_array_equal(getattr(pl_, f), getattr(jl, f), err_msg=f)
    assert bops.halo_widths(pl_.win_start, pl_.W, pl_.n_pad) == \
        jax_bops.halo_widths(jl.win_start, jl.W, jl.n_pad)
    # the block passed last is the default, as in the JAX template
    assert pt.band_layout() is pl_

    B, n = 3, jt.n_node
    jg = jt.batch(B, mode="banded", band_block=block)
    pg = pt.batch(B, mode="banded", band_block=block, device="cpu")
    np.testing.assert_array_equal(pg.band_adj_mask.numpy(), jl.adj_mask.astype(np.int8))
    np.testing.assert_array_equal(pg.band_cnt.numpy(), np.asarray(jg.band_cnt))
    np.testing.assert_array_equal(pg.band_inv_deg.numpy(), np.asarray(jg.band_inv_deg))
    x = rng.standard_normal((B * n, 5)).astype(np.float32)
    packed = pg.pack_nodes(torch.from_numpy(x), n)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jg.pack_nodes(jnp.asarray(x), n)))
    np.testing.assert_array_equal(pg.unpack_nodes(packed, n).numpy(), x)


def _attention_inputs(rng, nB, B, BLK, W, H, C):
    adj = rng.random((nB, BLK, W)) < 0.3
    adj[-1, -4:, :] = False              # padded (fully masked) rows
    n_pad, n_ext = nB * BLK, nB * BLK + W - BLK
    a_dst = rng.standard_normal((B, n_pad, H)).astype(np.float32)
    a_src = rng.standard_normal((nB, B, W, H)).astype(np.float32)
    x_ext = rng.standard_normal((B, n_ext, H, C)).astype(np.float32)
    return adj, a_dst, a_src, x_ext


@pytest.mark.parametrize("H,C,W", [(2, 64, 40), (1, 128, 200), (2, 8, 70)])
def test_plain_band_attention_matches_jax(rng, H, C, W):
    nB, B, BLK = 3, 2, 16
    adj, a_dst, a_src, x_ext = _attention_inputs(rng, nB, B, BLK, W, H, C)
    U = (W - BLK) // 2
    got = band_attention_fwd(torch.from_numpy(a_dst), torch.from_numpy(a_src),
                             torch.from_numpy(x_ext), torch.from_numpy(adj)).numpy()
    assert np.isfinite(got).all()

    # every row (padded ones too) against the plain JAX reference
    x_win = jax_bops.band_windows_ext(jnp.asarray(x_ext), nB, BLK, W)
    ref = np.asarray(jax_bops.band_attention(jnp.asarray(a_dst), jnp.asarray(a_src),
                                             x_win, jnp.asarray(adj), 0.2))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)

    if (H * C) % 128 == 0:
        # real rows against the v2 Pallas kernel (it averages padded rows
        # over W_pad, not W)
        valid = adj.any(-1).reshape(-1)
        att = make_band_attention_dma(nB, BLK, W, U, 0.2, interpret=True)
        ker = np.asarray(att(jnp.asarray(a_dst), jnp.asarray(a_src),
                             jnp.asarray(x_ext), jnp.asarray(adj)))
        np.testing.assert_allclose(got[:, valid], ker[:, valid], rtol=1e-5, atol=1e-6)


def test_band_attention_int8_mask_matches_bool(rng):
    adj, a_dst, a_src, x_ext = _attention_inputs(rng, 2, 2, 8, 24, 2, 4)
    args = (torch.from_numpy(a_dst), torch.from_numpy(a_src), torch.from_numpy(x_ext))
    a = band_attention_fwd(*args, torch.from_numpy(adj))
    b = band_attention_fwd(*args, torch.from_numpy(adj.astype(np.int8)))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    # a fully masked row is the mean of its window's rows
    blk, r = 1, 7
    win = x_ext[:, blk * 8: blk * 8 + 24].mean(axis=1)
    np.testing.assert_allclose(a[:, blk * 8 + r].numpy(), win, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("nB,B,BLK,W,C", [(3, 2, 16, 200, 128), (1, 2, 16, 40, 128),
                                         (2, 1, 8, 300, 256)])
@pytest.mark.parametrize("int8", [False, True])
def test_plain_band_spmm_matches_pallas(rng, nB, B, BLK, W, C, int8):
    U = (W - BLK) // 2
    n_ext = nB * BLK + W - BLK
    on = rng.random((nB, BLK, W)) < 0.3
    band = (on * rng.integers(1, 4, on.shape)).astype(np.int8) if int8 else \
        (on * rng.random(on.shape)).astype(np.float32)
    x_ext = rng.standard_normal((B, n_ext, C)).astype(np.float32)
    got = band_spmm_fwd(torch.from_numpy(band), torch.from_numpy(x_ext)).numpy()
    spmm = make_band_spmm_flash(nB, BLK, W, U, interpret=True)
    ref = np.asarray(spmm(jnp.asarray(band), jnp.asarray(x_ext)))
    # up to ~0.3·W = 90 f32 products per output, summed in another order than
    # the Pallas kernel's: a row that cancels to ~0.1 differs by ~2e-6
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_int8_count_overflow_raises():
    # 128 parallel links between nodes 0 and 1 wrap an int8 count
    s = np.array([0, 1] * 128 + [1, 2], np.int32)
    r = np.array([1, 0] * 128 + [2, 1], np.int32)
    with pytest.raises(ValueError, match="int8"):
        bops.build_band_layout(GraphTemplate(3, s, r), block=8)


def test_unported_mode_raises(rng):
    jt = random_graph(rng, n=12, extra_edges=4)
    with pytest.raises(NotImplementedError, match="'segment' is not yet ported.*Queue 1"):
        GraphTemplate(jt.n_node, jt.senders, jt.receivers).batch(2, mode="segment", device="cpu")


def test_template_sorts_edges_like_jax(rng):
    """The port's template keeps JAX's receiver-sorted order (edge
    attributes included) on the same unsorted edge list."""
    s = rng.integers(0, 20, 50).astype(np.int32)
    r = rng.integers(0, 20, 50).astype(np.int32)
    ea = rng.random((50, 2)).astype(np.float32)
    jt, pt = JaxTemplate(20, s, r, edge_attr=ea), GraphTemplate(20, s, r, edge_attr=ea)
    for name in ("senders", "receivers", "edge_attr"):
        np.testing.assert_array_equal(getattr(pt, name), getattr(jt, name))
