"""PyTorch port: the two band forwards that walk ``BandIndex`` row lists
(``csrc/band_spmm.cu``, ``csrc/band_attention.cu``). A CUDA kernel cannot run
here, so each kernel's walk is replayed in numpy in the kernel's order (chunks
of 32 entries over ``row_ptr``/``col``, the streaming rescale of rows past
32 entries, the per-block window mean of the padded rows) and held against the
plain versions on every row, and against the JAX package's Pallas kernels
(``make_band_attention_dma``, ``make_band_spmm_flash``, interpret mode) on
the real rows. Also: the model's path hands the template's cached indices to
both forward wrappers on every route."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_pressure_estimation_tpu.ops.pallas.band_attention import (
    make_band_attention_dma,
    make_band_spmm_flash,
)
from gnn_pressure_estimation_tpu_torch.core.graph import GraphTemplate
from gnn_pressure_estimation_tpu_torch.data.dataset import build_template, get_keep_list
from gnn_pressure_estimation_tpu_torch.data.inp import parse_inp
from gnn_pressure_estimation_tpu_torch.models.presets import select_model
from gnn_pressure_estimation_tpu_torch.ops import band_attention as ba
from gnn_pressure_estimation_tpu_torch.ops import band_spmm as bs
from gnn_pressure_estimation_tpu_torch.ops import banded as bops
from helpers import random_graph

torch.set_num_threads(1)
MINITOWN = Path(__file__).resolve().parents[1] / "inputs" / "minitown.inp"
CHUNK = 32                              # entries a warp takes at once: one a lane
FWD = dict(rtol=1e-5, atol=1e-5)


def _template(kind):
    if kind == "minitown":
        wn = parse_inp(str(MINITOWN))
        return build_template(wn, get_keep_list(wn, "keep_junction", None, "pressure"), None)[0], 8
    jt = random_graph(np.random.default_rng(3), n=70, extra_edges=40)
    return GraphTemplate(jt.n_node, jt.senders, jt.receivers), 16


def _synthetic_mask(rng, kind):
    """``wide``: rows of ~80 entries (three chunks); ``padded``: sparse rows
    and the last five rows of the last block fully masked."""
    if kind == "wide":
        return rng.random((2, 16, 200)) < 0.4
    adj = rng.random((3, 16, 70)) < 0.3
    adj[-1, -5:] = False
    return adj


def _layout_masks(rng):
    """(label, mask [nB, BLK, W] bool, count band int8 or None)."""
    out = []
    for kind in ("minitown", "random"):
        tpl, blk = _template(kind)
        bl = tpl.band_layout(blk)
        out.append((kind, bl.adj_mask, bl.adj_cnt))
    for kind in ("wide", "padded"):
        out.append((kind, _synthetic_mask(rng, kind), None))
    return out


def _operands(rng, adj, B, H, C):
    """a_dst, a_src_win, x_ext from the seed; a third of the nodes zeroed so
    that a_dst + a_src == 0 occurs."""
    nB, BLK, W = adj.shape
    n_pad, n_ext = nB * BLK, nB * BLK + W - BLK
    a_dst = rng.standard_normal((B, n_pad, H)).astype(np.float32)
    a_src = rng.standard_normal((nB, B, W, H)).astype(np.float32)
    a_dst[:, ::3] = 0.0
    a_src[:, :, ::3] = 0.0
    return a_dst, a_src, rng.standard_normal((B, n_ext, H, C)).astype(np.float32)


def spmm_replay(ix, x_ext):
    """``csrc/band_spmm.cu`` in numpy: per row, its list in chunks of 32, each
    entry's value times its x row added in list order."""
    B, _, C = x_ext.shape
    out = np.zeros((B, ix.nB * ix.BLK, C), np.float32)
    for row in range(ix.nB * ix.BLK):
        base = row // ix.BLK * ix.BLK
        k0, k1 = int(ix.row_ptr[row]), int(ix.row_ptr[row + 1])
        acc = np.zeros((B, C), np.float32)
        for s0 in range(k0, k1, CHUNK):
            for k in range(s0, min(s0 + CHUNK, k1)):
                acc = acc + ix.val[k] * x_ext[:, base + ix.col[k]]
        out[:, row] = acc
    return out


def attention_replay(ix, a_dst, a_src, x_ext, slope, rows=None):
    """``csrc/band_attention.cu`` in numpy: the pre-pass's window mean of each
    block holding a row with no set column; then per row its list in chunks
    of 32 with a running max and sum per head, the accumulator rescaled by
    exp(m − m_new) at every chunk, out = acc / Z; a row with no entry copies
    its block's mean. ``rows(blk, js)``: the x rows [B, len(js), H, C] of
    block blk's window columns js, which the walk and the pre-pass read;
    x_ext's rows blk·BLK + js unless given (the window layout's reader:
    ``test_torch_band_window_rowwalk.py``)."""
    B, n_pad, H = a_dst.shape
    nB, BLK, W = ix.nB, ix.BLK, ix.W
    if rows is None:
        def rows(blk, js):
            return x_ext[:, blk * BLK + js]
    mean = {blk: rows(blk, np.arange(W)).sum(axis=1, dtype=np.float32) / np.float32(W)
            for blk in range(nB) if ix.empty_ptr[blk + 1] > ix.empty_ptr[blk]}
    out = np.empty((B, n_pad) + x_ext.shape[-2:], np.float32)
    for row in range(n_pad):
        blk = row // BLK
        k0, k1 = int(ix.row_ptr[row]), int(ix.row_ptr[row + 1])
        if k0 == k1:
            out[:, row] = mean[blk]
            continue
        m = np.full((B, H), -3e38, np.float32)
        Z = np.zeros((B, H), np.float32)
        acc = np.zeros((B,) + x_ext.shape[-2:], np.float32)
        for s0 in range(k0, k1, CHUNK):
            js = ix.col[s0:min(s0 + CHUNK, k1)]
            z = a_dst[:, row, None, :] + a_src[blk][:, js]                # [B, cnt, H]
            z = np.where(z >= 0, z, np.float32(slope) * z)
            m_new = np.maximum(m, z.max(axis=1))
            p = np.exp(z - m_new[:, None])
            alpha = np.exp(m - m_new)
            Z = Z * alpha + p.sum(axis=1)
            acc = acc * alpha[..., None]
            xr = rows(blk, js)
            for q in range(len(js)):
                acc = acc + p[:, q, :, None] * xr[:, q]
            m = m_new
        out[:, row] = acc / Z[..., None]
    return out


# (B, H, C): H·C 64, 256 (GATRes-large conv1), C past one 128-channel tile, C % 4 != 0,
# more heads than one pass of the kernel takes (32)
ATTN_SHAPES = [(2, 2, 32), (1, 2, 128), (2, 1, 160), (2, 3, 33), (1, 40, 4)]


@pytest.mark.parametrize("layout", ["minitown", "random", "wide", "padded"])
def test_attention_replay_matches_plain_on_every_row(rng, layout):
    label, adj, _ = next(t for t in _layout_masks(rng) if t[0] == layout)
    ix = bops.build_band_index(adj)
    if layout == "wide":
        assert int(np.diff(ix.row_ptr).max()) > 2 * CHUNK       # three chunks: two rescales
    if layout in ("random", "padded"):
        assert ix.empty_row.size > 0                            # padded rows: the pre-pass runs
    for B, H, C in ATTN_SHAPES:
        a_dst, a_src, x_ext = _operands(rng, adj, B, H, C)
        got = attention_replay(ix, a_dst, a_src, x_ext, 0.2)
        ref = ba.band_attention_plain(*(torch.from_numpy(a) for a in (a_dst, a_src, x_ext, adj)), 0.2)
        np.testing.assert_allclose(got, ref.numpy(), err_msg=f"{label} B{B} H{H} C{C}", **FWD)


@pytest.mark.parametrize("layout", ["random", "wide"])
def test_attention_replay_matches_pallas_dma_on_real_rows(rng, layout):
    """Real rows only: the Pallas kernel averages a padded row over round_up(W,
    128), the port over W (``ROADMAP.md``, divergences in force)."""
    _, adj, _ = next(t for t in _layout_masks(rng) if t[0] == layout)
    nB, BLK, W = adj.shape
    ix = bops.build_band_index(adj)
    a_dst, a_src, x_ext = _operands(rng, adj, 2, 2, 64)
    got = attention_replay(ix, a_dst, a_src, x_ext, 0.2)
    att = make_band_attention_dma(nB, BLK, W, (W - BLK) // 2, 0.2, interpret=True)
    ker = np.asarray(att(jnp.asarray(a_dst), jnp.asarray(a_src), jnp.asarray(x_ext), jnp.asarray(adj)))
    valid = adj.any(-1).reshape(-1)
    np.testing.assert_allclose(got[:, valid], ker[:, valid], **FWD)


def _spmm_bands(rng):
    """(label, band): the templates' int8 count bands, and synthetic int8 and
    f32 bands with rows of more than 32 entries and empty rows."""
    out = [(k, cnt) for k, _, cnt in _layout_masks(rng) if cnt is not None]
    for kind in ("wide", "padded"):
        on = _synthetic_mask(rng, kind)
        out.append((f"{kind} int8", (on * rng.integers(1, 4, on.shape)).astype(np.int8)))
        out.append((f"{kind} f32", (on * rng.random(on.shape)).astype(np.float32)))
    return out


@pytest.mark.parametrize("C", [64, 128, 300, 33])
def test_spmm_replay_matches_plain_on_every_row(rng, C):
    for label, band in _spmm_bands(rng):
        nB, BLK, W = band.shape
        x_ext = rng.standard_normal((2, nB * BLK + W - BLK, C)).astype(np.float32)
        got = spmm_replay(bops.build_band_index(band), x_ext)
        ref = bs.band_spmm_plain(torch.from_numpy(band), torch.from_numpy(x_ext)).numpy()
        np.testing.assert_allclose(got, ref, err_msg=f"{label} C{C}", **FWD)


@pytest.mark.parametrize("layout", ["minitown", "random"])
def test_spmm_replay_matches_pallas_spmm(rng, layout):
    tpl, blk = _template(layout)
    bl = tpl.band_layout(blk)
    U, _ = bops.halo_widths(bl.win_start, bl.W, bl.n_pad)
    nB, BLK, W = bl.adj_cnt.shape
    x_ext = rng.standard_normal((2, nB * BLK + W - BLK, 128)).astype(np.float32)
    got = spmm_replay(tpl.band_index("adj_cnt", blk), x_ext)
    spmm = make_band_spmm_flash(nB, BLK, W, U, interpret=True)
    ref = np.asarray(spmm(jnp.asarray(bl.adj_cnt), jnp.asarray(x_ext)))
    # the Pallas kernel sums every row of the window (zeros included) in its own order
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_spmm_int8_and_f32_band_share_one_index(rng):
    """The index carries the values as f32, so an int8 count band and its f32
    copy have the same index and go through one kernel."""
    on = _synthetic_mask(rng, "wide")
    cnt = (on * rng.integers(1, 4, on.shape)).astype(np.int8)
    f32 = cnt.astype(np.float32)
    i8, i32 = bops.build_band_index(cnt), bops.build_band_index(f32)
    for f in ("row_ptr", "col", "val", "empty_ptr", "empty_row"):
        np.testing.assert_array_equal(getattr(i8, f), getattr(i32, f), err_msg=f)
    nB, BLK, W = cnt.shape
    x = torch.from_numpy(rng.standard_normal((2, nB * BLK + W - BLK, 40)).astype(np.float32))
    ix = i8.to("cpu")
    a = bs.band_spmm_fwd(torch.from_numpy(cnt), x, ix)
    b = bs.band_spmm_fwd(torch.from_numpy(f32), x, ix)
    assert torch.equal(a, b)
    np.testing.assert_allclose(spmm_replay(i8, x.numpy()), a.numpy(), **FWD)


def test_vector_loads_need_aligned_rows_of_whole_float4():
    x = torch.zeros(2, 10, 128)
    assert bops.vector_loads(x, 128)
    assert not bops.vector_loads(x.view(-1)[1:1 + 2 * 10 * 127].view(2, 10, 127), 127)
    assert not bops.vector_loads(x.view(-1)[1:1 + 2 * 10 * 64].view(2, 10, 64), 64)   # 4-byte offset
    assert bops.vector_loads(x.view(-1)[4:4 + 2 * 10 * 64].view(2, 10, 64), 64)       # 16-byte offset


@pytest.mark.parametrize("route", ["dma", "acc", "flash", "window"])
def test_model_path_hands_the_cached_index_to_both_forwards(monkeypatch, route):
    """GATRes-large's banded forward passes ``graph.band_adj_index`` to the
    band-attention forward (on the routes that run it: "dma" and "acc") and
    ``graph.band_cnt_index`` to the band SpMM forward (every route)."""
    tpl, blk = _template("random")
    graph = tpl.batch(2, mode="banded", band_block=blk, device="cpu", band_attn=route)
    seen = {"attention": [], "spmm": []}

    def spy(key, fn, pos):
        def wrapped(*args, **kw):
            seen[key].append(kw["index"] if "index" in kw else args[pos])
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(ba, "band_attention_fwd", spy("attention", ba.band_attention_fwd, 5))
    monkeypatch.setattr(bs, "band_spmm_fwd", spy("spmm", bs.band_spmm_fwd, 2))
    model, _ = select_model("gatres_large", device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2 * tpl.n_node, 1)).astype(np.float32))
    with torch.no_grad():
        out = model(graph.pack_nodes(x, tpl.n_node), graph)
    assert torch.isfinite(out).all()
    assert len(seen["spmm"]) == model.num_blocks
    assert all(ix is graph.band_cnt_index for ix in seen["spmm"])
    assert len(seen["attention"]) == (2 * model.num_blocks if route in ("dma", "acc") else 0)
    assert all(ix is graph.band_adj_index for ix in seen["attention"])
