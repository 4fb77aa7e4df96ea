"""PyTorch port: the streaming-softmax band attention (the counterpart of
``make_band_attention_flash``, v4), the routing rule, and the three
band-attention routes of ``GATConv`` and of a train step, against the JAX
package (CPU: the port runs its plain versions, the JAX side its Pallas
kernels in interpret mode on the real rows and its plain band ops on every
row)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_pressure_estimation_tpu.data.dataset import build_template as jax_build_template
from gnn_pressure_estimation_tpu.data.dataset import get_keep_list as jax_keep_list
from gnn_pressure_estimation_tpu.data.inp import parse_inp as jax_parse_inp
from gnn_pressure_estimation_tpu.models.gatres import GATRes as JaxGATRes
from gnn_pressure_estimation_tpu.models.layers import GATConv as JaxGATConv
from gnn_pressure_estimation_tpu.ops import banded as jax_bops
from gnn_pressure_estimation_tpu.ops.pallas import band_attention as jax_pallas
from gnn_pressure_estimation_tpu.train.loop import TrainConfig as JaxTrainConfig
from gnn_pressure_estimation_tpu.train.loop import Trainer as JaxTrainer
from gnn_pressure_estimation_tpu.utils.scaling import NormStats as JaxNormStats
from gnn_pressure_estimation_tpu_torch.core.graph import GraphTemplate
from gnn_pressure_estimation_tpu_torch.data.dataset import build_template, get_keep_list
from gnn_pressure_estimation_tpu_torch.data.inp import parse_inp
from gnn_pressure_estimation_tpu_torch.models.gatres import GATRes
from gnn_pressure_estimation_tpu_torch.models.layers import GATConv
from gnn_pressure_estimation_tpu_torch.ops import banded as bops
from gnn_pressure_estimation_tpu_torch.ops.band_attention import (
    band_attention_bwd_plain, band_attention_flash, band_attention_flash_bwd,
    band_attention_flash_bwd_plain, band_attention_flash_fwd, band_attention_flash_plain,
    band_attention_plain,
)
from gnn_pressure_estimation_tpu_torch.simgen.netgen import make_mega
from gnn_pressure_estimation_tpu_torch.train import TrainConfig, Trainer
from gnn_pressure_estimation_tpu_torch.utils.masking import masked_count
from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats
from gnn_pressure_estimation_tpu_torch.weights import params_from_flax, params_from_parity_npz
from helpers import random_graph

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
MINITOWN = ROOT / "inputs" / "minitown.inp"
FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)       # the tolerance of tests/test_layers.py for kernel gradients
# what the JAX package reads to choose its band-attention kernel, per route of the port
ROUTE_ENV = {"dma": {}, "flash": {"GNN_TPU_BAND_FLASH": "1"}, "window": {"GNN_TPU_BAND_DMA": "0"}}


def _set_route_env(monkeypatch, route):
    for var in ("GNN_TPU_BAND_FLASH", "GNN_TPU_BAND_DMA", "GNN_TPU_BAND_ACC", "GNN_TPU_BAND_ATTN"):
        monkeypatch.delenv(var, raising=False)
    for var, value in ROUTE_ENV[route].items():
        monkeypatch.setenv(var, value)


def attention_inputs(rng, nB, B, BLK, W, H, C, density=0.25):
    """Operands from the seed. A third of the nodes is zeroed so that
    a_dst + a_src == 0 occurs; the last four band rows are fully masked
    (padded rows); row 1 has its only neighbours in the window's last
    columns (the last chunk of a streamed window); row 2's three neighbours
    make the running maximum stay, then rise, across the window."""
    adj = rng.random((nB, BLK, W)) < density
    adj[-1, -4:, :] = False
    adj[0, 1, :] = False
    adj[0, 1, W - 3:] = True
    adj[0, 2, :] = False
    adj[0, 2, [2, W // 2, W - 2]] = True
    n_pad, n_ext = nB * BLK, nB * BLK + W - BLK
    a_dst = rng.standard_normal((B, n_pad, H)).astype(np.float32)
    a_src = rng.standard_normal((nB, B, W, H)).astype(np.float32)
    a_dst[:, ::3] = 0.0
    a_src[:, :, ::3] = 0.0
    a_src[0, :, 2], a_src[0, :, W // 2], a_src[0, :, W - 2] = 1.0, -2.0, 3.0
    x_ext = rng.standard_normal((B, n_ext, H, C)).astype(np.float32)
    g = rng.standard_normal((B, n_pad, H, C)).astype(np.float32)
    return adj, a_dst, a_src, x_ext, g


def _port_grads(fn, adj, a_dst, a_src, x, g):
    args = [torch.from_numpy(a).requires_grad_() for a in (a_dst, a_src, x)]
    out = fn(*args, torch.from_numpy(adj), 0.2)
    return out.detach().numpy(), torch.autograd.grad(
        (torch.tanh(out) * torch.from_numpy(g)).sum(), args)


# (nB, B, BLK, W, H, C): two streamed chunks of 512 in both passes of the JAX
# kernel (with its forward budget lowered); two chunks of 1024 in its backward;
# a shape the v2 kernel takes too (one chunk)
SHAPES = {"chunks512": (2, 2, 8, 520, 1, 128), "chunks1024": (2, 1, 8, 1100, 2, 64),
          "v2shape": (3, 2, 16, 200, 2, 64)}


@pytest.mark.parametrize("bfold", ["0", "1"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_flash_matches_pallas_flash_kernel(rng, monkeypatch, shape, bfold):
    nB, B, BLK, W, H, C = SHAPES[shape]
    monkeypatch.setenv("GNN_TPU_BAND_BFOLD", bfold)
    monkeypatch.setenv("GNN_TPU_FLASH_FWD_BUDGET", "1")     # forward chunks as narrow as backward's
    if shape != "v2shape":
        f, b, pad = jax_pallas.flash_chunk_widths(W, BLK)
        assert pad // f >= 2 and pad // b >= 2              # the JAX side does stream
    adj, a_dst, a_src, x_ext, g = attention_inputs(rng, nB, B, BLK, W, H, C)
    valid = adj.any(-1).reshape(-1)
    gv = g * valid[None, :, None, None]                     # the kernel pads W: real rows only
    out, got = _port_grads(band_attention_flash, adj, a_dst, a_src, x_ext, gv)
    assert np.isfinite(out).all()

    v4 = jax_pallas.make_band_attention_flash(nB, BLK, W, (W - BLK) // 2, 0.2, interpret=True)
    adjj = jnp.asarray(adj)
    jargs = (jnp.asarray(a_dst), jnp.asarray(a_src), jnp.asarray(x_ext))
    ref = np.asarray(v4(*jargs, adjj))
    np.testing.assert_allclose(out[:, valid], ref[:, valid], **FWD)
    ker = jax.grad(lambda a: jnp.sum(jnp.tanh(v4(*a, adjj)) * jnp.asarray(gv)))(jargs)
    for a, b, name in zip(got, ker, ("a_dst", "a_src_win", "x_ext")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **GRAD)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_flash_matches_plain_jax_band_attention_on_all_rows(rng, shape):
    nB, B, BLK, W, H, C = SHAPES[shape]
    adj, a_dst, a_src, x_ext, g = attention_inputs(rng, nB, B, BLK, W, H, C)
    out, got = _port_grads(band_attention_flash, adj, a_dst, a_src, x_ext, g)
    adjj = jnp.asarray(adj)

    def plain(ad, asr, xe):
        return jax_bops.band_attention(ad, asr, jax_bops.band_windows_ext(xe, nB, BLK, W), adjj, 0.2)

    jargs = (jnp.asarray(a_dst), jnp.asarray(a_src), jnp.asarray(x_ext))
    np.testing.assert_allclose(out, np.asarray(plain(*jargs)), **FWD)
    ref = jax.grad(lambda a: jnp.sum(jnp.tanh(plain(*a)) * jnp.asarray(g)))(jargs)
    for a, b, name in zip(got, ref, ("a_dst", "a_src_win", "x_ext")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **GRAD)
    # a fully masked row: the mean of its window, finite
    row = nB * BLK - 1
    win = x_ext[:, (nB - 1) * BLK: (nB - 1) * BLK + W].mean(axis=1)
    np.testing.assert_allclose(out[:, row], win, rtol=1e-5, atol=1e-6)


def test_row_statistics_and_backward_from_them(rng):
    """m is the row maximum of the masked logits, Z the sum of exp(z − m);
    a fully masked row has m = −1e9, Z = W. The backward, given m, Z and
    delta, equals autograd through the plain forward and the whole-window
    (v2) plain backward."""
    nB, B, BLK, W, H, C = 3, 2, 8, 30, 2, 5
    adj, a_dst, a_src, x_ext, g = attention_inputs(rng, nB, B, BLK, W, H, C)
    t = [torch.from_numpy(a) for a in (a_dst, a_src, x_ext)]
    mask, d_out = torch.from_numpy(adj), torch.from_numpy(g)
    out, m, Z = band_attention_flash_fwd(*t, mask, 0.2)
    assert m.shape == Z.shape == (B, nB * BLK, H)
    torch.testing.assert_close(out, band_attention_plain(*t, mask, 0.2), rtol=1e-6, atol=1e-6)
    z = a_dst.reshape(B, nB, BLK, 1, H) + a_src.transpose(1, 0, 2, 3)[:, :, None]   # [B,nB,BLK,W,H]
    z = np.where(z >= 0, z, 0.2 * z)
    z = np.where(adj[None, :, :, :, None], z, -np.inf)
    real = adj.any(-1).reshape(-1)
    np.testing.assert_allclose(m.numpy()[:, real], z.max(3).reshape(B, -1, H)[:, real], rtol=1e-6)
    zsum = np.exp(z - z.max(3, keepdims=True).clip(-1e30)).sum(3).reshape(B, -1, H)
    np.testing.assert_allclose(Z.numpy()[:, real], zsum[:, real], rtol=1e-5)
    assert (m.numpy()[:, ~real] == -1e9).all() and (Z.numpy()[:, ~real] == W).all()

    delta = (d_out * out).sum(-1)
    got = band_attention_flash_bwd(*t, mask, m, Z, delta, d_out, 0.2)
    for a, b in zip(got, band_attention_flash_bwd_plain(*t, mask, m, Z, delta, d_out, 0.2)):
        assert torch.equal(a, b)                      # on the CPU the wrapper is the plain version
    req = [a.clone().requires_grad_() for a in t]
    ref = torch.autograd.grad((band_attention_plain(*req, mask, 0.2) * d_out).sum(), req)
    for a, b, c in zip(got, ref, band_attention_bwd_plain(*t, mask, d_out, 0.2)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-6)
    # a fully masked row sends no gradient to the a's, and d_out / W to its window
    only = torch.zeros_like(d_out)
    only[0, -1] = 1.0
    d_ad, d_as, d_x = band_attention_flash_bwd(*t, mask, m, Z, (only * out).sum(-1), only, 0.2)
    assert not d_ad.any() and not d_as.any()
    want = torch.zeros_like(d_x)
    want[0, (nB - 1) * BLK: (nB - 1) * BLK + W] = 1.0 / W
    torch.testing.assert_close(d_x, want, rtol=1e-6, atol=0)


def test_flash_gradcheck_float64(rng):
    nB, B, BLK, W, H, C = 2, 1, 4, 10, 2, 3
    adj = rng.random((nB, BLK, W)) < 0.4
    adj[0, 1] = False                                        # one fully masked row
    n_pad, n_ext = nB * BLK, nB * BLK + W - BLK
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s)).requires_grad_()  # noqa: E731
    mask = torch.from_numpy(adj)
    assert torch.autograd.gradcheck(
        lambda ad, asr, xe: band_attention_flash(ad, asr, xe, mask, 0.2),
        (mk(B, n_pad, H), mk(nB, B, W, H), mk(B, n_ext, H, C)), atol=1e-6)


def _stream_rows(ix, a_dst, a_src, x_ext, chunk):
    """What the CUDA forward does with a BandIndex, in numpy float64: per row
    the list of set columns in chunks, a running maximum m, the denominator Z
    and the accumulator rescaled by exp(m_old − m_new)."""
    nB, BLK, W = ix.nB, ix.BLK, ix.W
    n_pad, (H, C) = nB * BLK, x_ext.shape[1:]
    out, ms, zs = np.zeros((n_pad, H, C)), np.zeros((n_pad, H)), np.zeros((n_pad, H))
    for row in range(n_pad):
        blk, k0, k1 = row // BLK, ix.row_ptr[row], ix.row_ptr[row + 1]
        for h in range(H):
            if k0 == k1:
                out[row, h] = x_ext[blk * BLK: blk * BLK + W, h].mean(0)
                ms[row, h], zs[row, h] = -1e9, W
                continue
            m, Z, acc = -3e38, 0.0, np.zeros(C)
            for s0 in range(k0, k1, chunk):
                cols = ix.col[s0: min(s0 + chunk, k1)]
                z = a_dst[row, h] + a_src[blk, cols, h]
                z = np.where(z >= 0, z, 0.2 * z)
                m_new = max(m, z.max())
                alpha, p = np.exp(m - m_new), np.exp(z - m_new)
                Z = Z * alpha + p.sum()
                acc = acc * alpha + p @ x_ext[blk * BLK + cols, h]
                m = m_new
            out[row, h], ms[row, h], zs[row, h] = acc / Z, m, Z
    return out, ms, zs


def _column_pass(ix, a_dst, a_src, x_ext, m, Z, delta, d_out):
    """The backward's algebra over the index in numpy float64: per extended
    row e the entries that read it, each weight rebuilt from m and Z alone
    (the CUDA kernel's own passes and order are replayed in
    ``test_torch_band_colwalk.py``)."""
    nB, BLK, W = ix.nB, ix.BLK, ix.W
    n_ext, H = len(ix.t_ptr) - 1, a_dst.shape[1]
    d_x, d_as = np.zeros_like(x_ext, dtype=np.float64), np.zeros((nB, W, H))
    dz_k = np.zeros((ix.nnz, H))
    for e in range(n_ext):
        for t in range(ix.t_ptr[e], ix.t_ptr[e + 1]):
            k, g = ix.t_entry[t], ix.t_row[t]
            blk = g // BLK
            zpre = a_dst[g] + a_src[blk, e - blk * BLK]                     # [H]
            p = np.exp(np.where(zpre >= 0, zpre, 0.2 * zpre) - m[g]) / Z[g]
            dp = (d_out[g] * x_ext[e]).sum(-1)
            dz_k[k] = p * (dp - delta[g]) * np.where(zpre >= 0, 1.0, 0.2)
            d_x[e] += p[:, None] * d_out[g]
            d_as[blk, e - blk * BLK] += dz_k[k]
    for blk in range(nB):                       # rows without an entry spread d_out / W
        for g in ix.empty_row[ix.empty_ptr[blk]: ix.empty_ptr[blk + 1]]:
            d_x[blk * BLK: blk * BLK + W] += d_out[g] / W
    d_ad = np.stack([dz_k[ix.row_ptr[g]: ix.row_ptr[g + 1]].sum(0) for g in range(nB * BLK)])
    return d_ad, d_as, d_x


@pytest.mark.parametrize("chunk", [2, 32])
def test_index_walk_of_the_kernels_reproduces_the_plain_versions(rng, chunk):
    nB, BLK, W, H, C = 3, 8, 40, 2, 5
    adj, a_dst, a_src, x_ext, g = attention_inputs(rng, nB, 1, BLK, W, H, C)
    ix = bops.build_band_index(adj)
    t = [torch.from_numpy(a.astype(np.float64)) for a in (a_dst, a_src, x_ext)]
    mask, d_out = torch.from_numpy(adj), torch.from_numpy(g.astype(np.float64))
    out, m, Z = band_attention_flash_plain(*t, mask, 0.2)
    got = _stream_rows(ix, a_dst[0].astype(np.float64), a_src[:, 0].astype(np.float64),
                       x_ext[0].astype(np.float64), chunk)
    for a, b in zip(got, (out, m, Z)):
        np.testing.assert_allclose(a, b[0].numpy(), rtol=1e-12, atol=1e-12)
    delta = (d_out * out).sum(-1)
    ref = band_attention_flash_bwd_plain(*t, mask, m, Z, delta, d_out, 0.2)
    d_ad, d_as, d_x = _column_pass(ix, t[0][0].numpy(), t[1][:, 0].numpy(), t[2][0].numpy(),
                                   m[0].numpy(), Z[0].numpy(), delta[0].numpy(), d_out[0].numpy())
    np.testing.assert_allclose(d_ad, ref[0][0].numpy(), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(d_as, ref[1][:, 0].numpy(), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(d_x, ref[2][0].numpy(), rtol=1e-10, atol=1e-12)


# ---- routing -----------------------------------------------------------------

# (network, BLK) → (nB, W) of its band layout, as `build_band_layout` gives them
LAYOUTS = {("bigtown", 256): (23, 896), ("meganet", 256): (90, 1920), ("meganet", 512): (45, 2048),
           ("bigtown", 512): (12, 1152), ("meganet", 128): (180, 1792)}


@pytest.mark.parametrize("net,BLK", list(LAYOUTS))
def test_route_follows_the_jax_template(net, BLK):
    """``band_attention_route`` sends a layout to "flash" exactly where the
    JAX package's v2 factory refuses it and ``template.batch`` falls back to
    the streaming kernel."""
    nB, W = LAYOUTS[(net, BLK)]
    v2 = jax_pallas.make_band_attention_dma(nB, BLK, W, (W - BLK) // 2, 0.2, interpret=True)
    assert bops.band_attention_route(BLK, W) == ("flash" if v2 is None else "dma")
    if (net, BLK) in (("bigtown", 256), ("meganet", 256)):
        assert bops.band_attention_route(BLK, W) == {"bigtown": "dma", "meganet": "flash"}[net]


def test_batch_carries_and_checks_the_route(rng):
    jt = random_graph(rng, n=40, extra_edges=20)
    tpl = GraphTemplate(jt.n_node, jt.senders, jt.receivers)
    default = tpl.batch(2, "banded", 8, "cpu")
    assert default.band_attn == "dma"
    assert tpl.batch(2, "banded", 8, "cpu", band_attn="dma") is default        # one cache entry
    for route in ("flash", "window"):
        g = tpl.batch(2, "banded", 8, "cpu", band_attn=route)
        assert g.band_attn == route and g is not default
        assert g is tpl.batch(2, "banded", 8, "cpu", band_attn=route)
    acc = tpl.batch(2, "banded", 8, "cpu", band_attn="acc")
    assert acc.band_attn == "acc" and acc is not default
    with pytest.raises(ValueError, match="band_attn"):
        tpl.batch(2, "banded", 8, "cpu", band_attn="v5")
    with pytest.raises(ValueError, match="banded graphs only"):
        tpl.batch(2, "dense", None, "cpu", band_attn="flash")
    assert tpl.batch(2, "dense", None, "cpu").band_attn is None


# ---- the layer and the train step, per route ------------------------------------

def _jax_graph_for(route, monkeypatch, rng_seed, B, block):
    """A fresh JAX template (its batch cache ignores the environment) built
    under the environment that selects the route's kernel."""
    _set_route_env(monkeypatch, route)
    jt = random_graph(np.random.default_rng(rng_seed), n=70, extra_edges=40)
    jg = jt.batch(B, mode="banded", band_block=block)
    if route == "window":
        assert jg.band_attn is not None and jg.band_attn_dma is None
    else:
        assert jg.band_attn_dma is not None
    return jt, jg


@pytest.mark.parametrize("route", ["dma", "flash", "window"])
@pytest.mark.parametrize("H,C", [(2, 64), (1, 128)])
def test_gatconv_banded_matches_jax_layer(rng, monkeypatch, route, H, C):
    """H·C 128: the JAX layer reaches the Pallas kernel the environment
    names (v2, v4 or v1, in interpret mode)."""
    B, block, cin = 2, 16, 12
    jt, jg = _jax_graph_for(route, monkeypatch, 5, B, block)
    n = jt.n_node
    pg = GraphTemplate(n, jt.senders, jt.receivers).batch(B, "banded", block, "cpu", band_attn=route)
    assert pg.band_attn == route
    x = rng.standard_normal((B * n, cin)).astype(np.float32)
    w = rng.standard_normal((B * n, H * C if H == 2 else C)).astype(np.float32)
    concat = H == 2
    jl = JaxGATConv(out_channels=C, heads=H, concat=concat)
    jx = jg.pack_nodes(jnp.asarray(x), n)
    jw = jg.pack_nodes(jnp.asarray(w), n)
    params = jl.init(jax.random.PRNGKey(0), jx, jg)
    params = jax.tree.map(lambda a: a + 0.1, params)            # a bias that is not zero
    ref = jl.apply(params, jx, jg)
    jgrads, jdx = jax.grad(lambda p, xx: jnp.sum(jl.apply(p, xx, jg) * jw), argnums=(0, 1))(params, jx)

    layer = GATConv(cin, C, heads=H, concat=concat)
    p = jax.tree.map(np.asarray, params)["params"]
    with torch.no_grad():
        layer.lin.weight.copy_(torch.from_numpy(p["w"].T.copy()))
        for f in ("att_src", "att_dst", "bias"):
            getattr(layer, f).copy_(torch.from_numpy(p[f].copy()))
    px = pg.pack_nodes(torch.from_numpy(x), n).requires_grad_()
    pw = pg.pack_nodes(torch.from_numpy(w), n)
    out = layer(px, pg)
    real = np.asarray(jg.unpack_nodes(ref, n))
    np.testing.assert_allclose(pg.unpack_nodes(out, n).detach().numpy(), real, rtol=1e-5, atol=2e-6)
    grads = torch.autograd.grad((out * pw).sum(), [px, *layer.parameters()])
    np.testing.assert_allclose(pg.unpack_nodes(grads[0], n).numpy(),
                               np.asarray(jg.unpack_nodes(jdx, n)), rtol=1e-4, atol=2e-5)
    jg_p = jax.tree.map(np.asarray, jgrads)["params"]
    want = {"lin.weight": jg_p["w"].T, "att_src": jg_p["att_src"], "att_dst": jg_p["att_dst"],
            "bias": jg_p["bias"]}
    for (name, _), g in zip(layer.named_parameters(), grads[1:]):
        np.testing.assert_allclose(g.numpy(), want[name], rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("route", ["dma", "flash", "window"])
def test_train_step_on_banded_minitown_matches_jax_trainer(rng, monkeypatch, route):
    """2 blocks, nc 64 on minitown (BLK 8): conv1 (H·C 128) goes through the
    route's Pallas kernel on the JAX side, forward and backward; the
    tolerances of tests/test_torch_train.py."""
    _set_route_env(monkeypatch, route)
    jwn = jax_parse_inp(str(MINITOWN))
    jt, _ = jax_build_template(jwn, jax_keep_list(jwn, "keep_junction", None, "pressure"), None)
    wn = parse_inp(str(MINITOWN))
    pt, _ = build_template(wn, get_keep_list(wn, "keep_junction", None, "pressure"), None)
    n, bs, nc = jt.n_node, 2, 64
    kw = dict(batch_size=bs, mask_rate=0.5, criterion="mse", agg_mode="banded", band_block=8,
              donate_state=False, seed=0)
    stats = dict(norm_type="znorm", mean=1.0, std=3.0)
    jtr = JaxTrainer(JaxGATRes(num_blocks=2, channels=nc), JaxTrainConfig(**kw),
                     JaxNormStats(**stats), jt)
    ptr = Trainer(GATRes(2, nc), TrainConfig(band_attn=route, **kw), NormStats(**stats), pt,
                  device="cpu")
    ptr.model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, jtr.params), ptr.model))
    xb = rng.standard_normal((bs, n)).astype(np.float32)
    k = masked_count(n, 0.5)
    mask = np.zeros((bs, n), bool)
    for b in range(bs):
        mask[b, rng.permutation(n)[:k]] = True
    mask = mask.reshape(-1)

    jg = jtr._batched_graph(jt, bs)
    if route == "window":
        assert jg.band_attn is not None and jg.band_attn_dma is None
    else:
        assert jg.band_attn_dma is not None
    jx = jg.pack_nodes(jnp.asarray(xb.reshape(-1, 1)), n)
    jmask = jg.pack_nodes(jnp.asarray(mask).astype(jnp.float32)[:, None], n)[:, 0] > 0.5

    def loss_fn(p_):
        loss, mets, _ = jtr._masked_loss_and_metrics(p_, jg, jx, jx, jmask, bs * k, "train")
        return loss, mets

    (jloss, jmets), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jtr.params)

    graph, x, pmask, pn = ptr._prepare(pt, xb, mask, None, None)
    assert graph.band_attn == route and pn == bs * k
    ptr.model.train()
    loss, mets, _ = ptr._masked_loss_and_metrics(graph, x, x, pmask, pn, "train")
    grads = torch.autograd.grad(loss, list(ptr.model.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for name in mets:
        np.testing.assert_allclose(float(mets[name]), float(jmets[name]), rtol=1e-4, atol=2e-5,
                                   err_msg=name)
    ref = params_from_flax(jax.tree.map(np.asarray, jgrads), ptr.model)
    for (name, _), g in zip(ptr.model.named_parameters(), grads):
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), rtol=1e-3, atol=1e-5, err_msg=name)


def test_remat_on_the_flash_route_gives_the_same_gradients(rng):
    jt = random_graph(rng, n=40, extra_edges=20)
    tpl = GraphTemplate(jt.n_node, jt.senders, jt.receivers)
    xb = rng.standard_normal((2, 40)).astype(np.float32)
    mask = rng.random(80) < 0.5
    grads = []
    for remat in (False, True):
        model = GATRes(2, 8, remat=remat)
        model.reset_parameters(torch.Generator().manual_seed(1))
        tr = Trainer(model, TrainConfig(batch_size=2, mask_rate=0.5, agg_mode="banded",
                                        band_block=8, band_attn="flash"), NormStats(), tpl,
                     device="cpu")
        graph, x, m, _ = tr._prepare(tpl, xb, mask, None, None)
        assert graph.band_attn == "flash"
        loss, _, _ = tr._masked_loss_and_metrics(graph, x, x, m, None, "train")
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---- the meganet fixture ----------------------------------------------------------

def test_meganet_fixture_is_self_consistent():
    fx = np.load(ROOT / "artifacts" / "parity_train_meganet.npz")
    n, depth = 23000, int(fx["num_blocks"])
    assert int(fx["nc"]) == 128 and 2 <= depth <= 4 and bytes(fx["path"]) == b"pallas"
    assert fx["mask"].shape == (n,) and int(fx["mask"].sum()) == int(fx["n_masked"]) == int(n * 0.95)
    assert fx["x"].shape == fx["x_in"].shape == fx["ours_out"].shape == (n, 1)
    np.testing.assert_array_equal(fx["x_in"][:, 0], np.where(fx["mask"], 0.0, fx["x"][:, 0]))
    assert fx["block_absmax"].shape == fx["block_mean"].shape == (depth,)
    model = GATRes(depth, 128)
    assert {k[5:] for k in fx.files if k.startswith("grad_")} == set(model.state_dict())
    loaded = params_from_parity_npz(ROOT / "artifacts" / "parity_train_meganet.npz")
    assert loaded.keys() == model.state_dict().keys()
    assert fx["step_losses"].shape == (3,) and fx["step_losses"][0] == fx["loss"]
    assert (ROOT / "artifacts" / "parity_train_meganet.npz").stat().st_size < 8e6


@pytest.mark.slow
def test_train_step_matches_meganet_fixture():
    """The fixture's B 1 step at its depth on the CPU (plain versions; the
    JAX side ran its v4 Pallas kernel in interpret mode): forward 1e-3, loss
    rtol 1e-4, each gradient max|Δ| ≤ 1e-3·max|g_ref| + 1e-6, parameters after
    3 Adam steps atol 3e-4 where the first gradient is above that bound (a
    step moves a component whose gradient is rounding noise by up to 2·lr).
    Several minutes and a few GB on one core."""
    path = ROOT / "artifacts" / "parity_train_meganet.npz"
    fx = np.load(path)
    wn = make_mega()
    tpl, _ = build_template(wn, get_keep_list(wn, "keep_junction", None, "pressure"), None)
    n = tpl.n_node
    model = GATRes(int(fx["num_blocks"]), int(fx["nc"]), attn_impl="factored")
    model.load_state_dict(params_from_parity_npz(path))
    stats = NormStats("znorm", float(fx["stats_mean"]), float(fx["stats_std"]))
    tr = Trainer(model, TrainConfig(batch_size=1), stats, tpl, device="cpu")
    graph = tpl.batch(1, device="cpu")
    assert graph.band_attn == "flash"
    with torch.no_grad():
        out = graph.unpack_nodes(model(graph.pack_nodes(torch.from_numpy(fx["x_in"]), n), graph), n)
    np.testing.assert_allclose(out.numpy(), fx["ours_out"], rtol=0, atol=1e-3)
    xb = fx["x"][:, 0][None, :]
    g1, x, mask, k = tr._prepare(tpl, xb, fx["mask"], None, None)
    assert g1 is graph
    loss, mets, _ = tr._masked_loss_and_metrics(graph, x, x, mask, k, "train")
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(fx["loss"]), rtol=1e-4)
    for (name, _), g in zip(model.named_parameters(), grads):
        ref = fx[f"grad_{name}"]
        assert float(np.abs(g.numpy() - ref).max()) <= 1e-3 * float(np.abs(ref).max()) + 1e-6, name
    losses = [float(tr.train_step(tpl, xb, mask=fx["mask"])[0]) for _ in range(3)]
    np.testing.assert_allclose(losses, fx["step_losses"], rtol=1e-3)
    for name, p in model.named_parameters():
        if f"p3_{name}" in fx.files:
            g_ref = np.abs(fx[f"grad_{name}"])
            real = g_ref > 1e-3 * g_ref.max() + 1e-6
            err = np.abs(p.detach().numpy() - fx[f"p3_{name}"])
            assert err[real].max(initial=0.0) <= 3e-4 and err[~real].max(initial=0.0) <= 3e-3, name
