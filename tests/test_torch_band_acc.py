"""PyTorch port: the sliding-accumulator band attention (the counterpart of
``make_band_attention_acc``, v3) against the JAX package (CPU: the port runs
its plain versions, the JAX side its Pallas kernel in interpret mode on the
real rows and its plain band ops on every row). Its CUDA backward runs v2's
passes; their numpy replay is held against the v3 Pallas kernel in
``test_torch_band_window_colwalk.py``."""

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
    band_attention_acc, band_attention_acc_bwd, band_attention_bwd_plain, band_attention_fwd,
)
from gnn_pressure_estimation_tpu_torch.train import TrainConfig, Trainer
from gnn_pressure_estimation_tpu_torch.utils.masking import masked_count
from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats
from gnn_pressure_estimation_tpu_torch.weights import params_from_flax
from helpers import random_graph

torch.set_num_threads(1)
MINITOWN = Path(__file__).resolve().parents[1] / "inputs" / "minitown.inp"
FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)       # the tolerance of tests/test_layers.py for kernel gradients
ACC_ENV = ("GNN_TPU_BAND_FLASH", "GNN_TPU_BAND_DMA", "GNN_TPU_BAND_ACC", "GNN_TPU_BAND_ATTN")

# (nB, B, BLK, W, H, C): the shapes of tests/test_layers.py's v3 test, and one
# with fully masked (padded) rows, several blocks covering each tile and W not
# a multiple of BLK
SHAPES = {"three_blocks": (3, 2, 16, 40, 2, 64), "one_block": (1, 2, 16, 40, 1, 128),
          "padded_rows": (4, 2, 8, 30, 2, 64)}


def attention_inputs(rng, nB, B, BLK, W, H, C, padded):
    """Operands from the seed; a third of the nodes zeroed so that
    a_dst + a_src == 0 occurs; with ``padded`` the last three band rows are
    fully masked."""
    adj = rng.random((nB, BLK, W)) < 0.3
    if padded:
        adj[-1, -3:, :] = False
    n_pad, n_ext = nB * BLK, nB * BLK + W - BLK
    a_dst = rng.standard_normal((B, n_pad, H)).astype(np.float32)
    a_src = rng.standard_normal((nB, B, W, H)).astype(np.float32)
    a_dst[:, ::3] = 0.0
    a_src[:, :, ::3] = 0.0
    x_ext = rng.standard_normal((B, n_ext, H, C)).astype(np.float32)
    g = rng.standard_normal((B, n_pad, H, C)).astype(np.float32)
    return adj, a_dst, a_src, x_ext, g


def _port_grads(adj, a_dst, a_src, x, g):
    args = [torch.from_numpy(a).requires_grad_() for a in (a_dst, a_src, x)]
    out = band_attention_acc(*args, torch.from_numpy(adj), 0.2)
    return out.detach().numpy(), torch.autograd.grad((torch.tanh(out) * torch.from_numpy(g)).sum(),
                                                     args)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_acc_matches_pallas_v3_kernel_on_real_rows(rng, shape):
    nB, B, BLK, W, H, C = SHAPES[shape]
    adj, a_dst, a_src, x_ext, g = attention_inputs(rng, nB, B, BLK, W, H, C, shape == "padded_rows")
    valid = adj.any(-1).reshape(-1)
    assert valid.all() != (shape == "padded_rows")
    gv = g * valid[None, :, None, None]          # the Pallas kernel averages padded rows over W_pad
    out, got = _port_grads(adj, a_dst, a_src, x_ext, gv)
    assert np.isfinite(out).all()

    v3 = jax_pallas.make_band_attention_acc(nB, BLK, W, (W - BLK) // 2, 0.2, interpret=True)
    assert v3 is not None
    adjj = jnp.asarray(adj)
    jargs = (jnp.asarray(a_dst), jnp.asarray(a_src), jnp.asarray(x_ext))
    ref = np.asarray(v3(*jargs, adjj))
    np.testing.assert_allclose(out[:, valid], ref[:, valid], **FWD)
    ker = jax.grad(lambda a: jnp.sum(jnp.tanh(v3(*a, adjj)) * jnp.asarray(gv)))(jargs)
    for a, b, name in zip(got, ker, ("a_dst", "a_src_win", "x_ext")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **GRAD)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_acc_matches_plain_jax_band_attention_on_all_rows(rng, shape):
    nB, B, BLK, W, H, C = SHAPES[shape]
    adj, a_dst, a_src, x_ext, g = attention_inputs(rng, nB, B, BLK, W, H, C, shape == "padded_rows")
    out, got = _port_grads(adj, a_dst, a_src, x_ext, g)
    adjj = jnp.asarray(adj)

    def plain(ad, asr, xe):
        return jax_bops.band_attention(ad, asr, jax_bops.band_windows_ext(xe, nB, BLK, W), adjj, 0.2)

    jargs = (jnp.asarray(a_dst), jnp.asarray(a_src), jnp.asarray(x_ext))
    np.testing.assert_allclose(out, np.asarray(plain(*jargs)), **FWD)
    ref = jax.grad(lambda a: jnp.sum(jnp.tanh(plain(*a)) * jnp.asarray(g)))(jargs)
    for a, b, name in zip(got, ref, ("a_dst", "a_src_win", "x_ext")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **GRAD)
    # on the CPU the backward is the v2 backward's plain version, to the bit
    t = [torch.from_numpy(a) for a in (a_dst, a_src, x_ext, adj, g)]
    for a, b in zip(band_attention_acc_bwd(*t, 0.2), band_attention_bwd_plain(*t, 0.2)):
        assert torch.equal(a, b)


def test_acc_forward_is_the_v2_forward(rng):
    nB, B, BLK, W, H, C = SHAPES["padded_rows"]
    adj, a_dst, a_src, x_ext, _ = attention_inputs(rng, nB, B, BLK, W, H, C, True)
    t = [torch.from_numpy(a) for a in (a_dst, a_src, x_ext, adj)]
    assert torch.equal(band_attention_acc(*t, 0.2), band_attention_fwd(*t, 0.2))


# ---- the layer and the train step -------------------------------------------------

def _acc_env(monkeypatch):
    for var in ACC_ENV:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("GNN_TPU_BAND_ACC", "1")


def _is_v3(attend) -> bool:
    return attend is not None and attend.__qualname__.startswith("make_band_attention_acc.")


@pytest.mark.parametrize("H,C", [(2, 64), (1, 128)])
def test_gatconv_acc_matches_jax_layer(rng, monkeypatch, H, C):
    """H·C 128 and a layout under the 1 MiB guard: the JAX layer reaches the
    v3 Pallas kernel (interpret mode) on a fresh template built under
    ``GNN_TPU_BAND_ACC=1``."""
    _acc_env(monkeypatch)
    B, block, cin = 2, 16, 12
    jt = random_graph(np.random.default_rng(5), n=70, extra_edges=40)
    jg = jt.batch(B, mode="banded", band_block=block)
    assert _is_v3(jg.band_attn_dma)
    n = jt.n_node
    pg = GraphTemplate(n, jt.senders, jt.receivers).batch(B, "banded", block, "cpu", band_attn="acc")
    assert pg.band_attn == "acc"
    x = rng.standard_normal((B * n, cin)).astype(np.float32)
    w = rng.standard_normal((B * n, H * C if H == 2 else C)).astype(np.float32)
    concat = H == 2
    jl = JaxGATConv(out_channels=C, heads=H, concat=concat)
    jx, jw = jg.pack_nodes(jnp.asarray(x), n), jg.pack_nodes(jnp.asarray(w), n)
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
    np.testing.assert_allclose(pg.unpack_nodes(out, n).detach().numpy(),
                               np.asarray(jg.unpack_nodes(ref, n)), rtol=1e-5, atol=2e-6)
    grads = torch.autograd.grad((out * pw).sum(), [px, *layer.parameters()])
    np.testing.assert_allclose(pg.unpack_nodes(grads[0], n).numpy(),
                               np.asarray(jg.unpack_nodes(jdx, n)), rtol=1e-4, atol=2e-5)
    jg_p = jax.tree.map(np.asarray, jgrads)["params"]
    want = {"lin.weight": jg_p["w"].T, "att_src": jg_p["att_src"], "att_dst": jg_p["att_dst"],
            "bias": jg_p["bias"]}
    for (name, _), g in zip(layer.named_parameters(), grads[1:]):
        np.testing.assert_allclose(g.numpy(), want[name], rtol=1e-4, atol=1e-4, err_msg=name)


def test_train_step_through_acc_matches_jax_trainer(rng, monkeypatch):
    """2 blocks, nc 64 on minitown (BLK 8): conv1 (H·C 128) goes through the
    v3 Pallas kernel on the JAX side, forward and backward; the tolerances of
    tests/test_torch_train.py."""
    _acc_env(monkeypatch)
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
    ptr = Trainer(GATRes(2, nc), TrainConfig(band_attn="acc", **kw), NormStats(**stats), pt,
                  device="cpu")
    ptr.model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, jtr.params), ptr.model))
    xb = rng.standard_normal((bs, n)).astype(np.float32)
    k = masked_count(n, 0.5)
    mask = np.zeros((bs, n), bool)
    for b in range(bs):
        mask[b, rng.permutation(n)[:k]] = True
    mask = mask.reshape(-1)

    jg = jtr._batched_graph(jt, bs)
    assert _is_v3(jg.band_attn_dma)
    jx = jg.pack_nodes(jnp.asarray(xb.reshape(-1, 1)), n)
    jmask = jg.pack_nodes(jnp.asarray(mask).astype(jnp.float32)[:, None], n)[:, 0] > 0.5

    def loss_fn(p_):
        loss, mets, _ = jtr._masked_loss_and_metrics(p_, jg, jx, jx, jmask, bs * k, "train")
        return loss, mets

    (jloss, jmets), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jtr.params)

    graph, x, pmask, pn = ptr._prepare(pt, xb, mask, None, None)
    assert graph.band_attn == "acc" and pn == bs * k
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


def test_acc_is_never_the_default_route():
    for BLK, W in ((256, 896), (256, 1920), (8, 40), (16, 128)):
        assert bops.band_attention_route(BLK, W) in ("dma", "flash")
    assert "acc" in bops.BAND_ATTN_ROUTES
