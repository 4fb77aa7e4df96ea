"""PyTorch port: ``attn_impl="band_factored"`` against the JAX package.

``ops.banded.band_attention_factored`` is a plain-torch copy of the JAX
function (plain XLA there, no Pallas kernel): the op is held on every row,
the padded rows (no set column: the row maximum clamped at −60, Z taken as
1, an output of 0) included, with the f32 store to rtol 1e-5 / atol 1e-6 and
the bf16 store within one bf16 step (2^-8·|ref|) plus 1e-5·max|ref| on at
least 99% of the values; the gradients by ``jax.vjp`` within 1e-4·max|g| +
1e-6 (f32) and 2^-6·max|g| + 1e-6 (bf16: the JAX VJP sums bf16 cotangents in
bf16). ``GATConv`` and a GATRes train step on the banded path: narrow layers
(GATRes-small's H·C 64 / 32) run the factored band and match the JAX model
at the fixtures' training gate (1e-3·max|g| + 1e-6; under bf16 stores
2^-6·max|g| + 1e-6, the op's bf16 gate); layers the JAX layer
hands to a Pallas kernel keep the graph's band kernel, so GATRes-large's
output and launches equal the preset's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_pressure_estimation_tpu.models.gatres import GATRes as JaxGATRes
from gnn_pressure_estimation_tpu.models.presets import apply_model_knobs as jax_apply_model_knobs
from gnn_pressure_estimation_tpu.ops.banded import band_attention_factored as jax_factored
from gnn_pressure_estimation_tpu.train.loop import TrainConfig as JaxTrainConfig
from gnn_pressure_estimation_tpu.train.loop import Trainer as JaxTrainer
from gnn_pressure_estimation_tpu.utils.scaling import NormStats as JaxNormStats
from gnn_pressure_estimation_tpu_torch.core.graph import GraphTemplate
from gnn_pressure_estimation_tpu_torch.models import layers
from gnn_pressure_estimation_tpu_torch.models.gatres import GATRes
from gnn_pressure_estimation_tpu_torch.models.presets import apply_model_knobs
from gnn_pressure_estimation_tpu_torch.ops import band_attention as pba
from gnn_pressure_estimation_tpu_torch.ops.banded import band_attention_factored
from gnn_pressure_estimation_tpu_torch.train import TrainConfig, Trainer
from gnn_pressure_estimation_tpu_torch.utils.masking import masked_count
from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats
from gnn_pressure_estimation_tpu_torch.weights import params_from_flax
from helpers import random_graph

torch.set_num_threads(1)
BF16_STEP = 2.0 ** -8


def _layout():
    jt = random_graph(np.random.default_rng(5), n=60, extra_edges=30)
    bl = jt.band_layout(16)
    assert not bl.adj_mask.any(axis=2).all(), "the layout must hold padded rows"
    return jt, bl


@pytest.mark.parametrize("store", [None, "bfloat16"])
@pytest.mark.parametrize("H,C", [(2, 16), (1, 32), (3, 5)])
def test_op_matches_jax_on_every_row(rng, store, H, C):
    jt, bl = _layout()
    nB, BLK, W = bl.adj_mask.shape
    B = 2
    a_dst = rng.standard_normal((B, nB * BLK, H)).astype(np.float32)
    a_src = rng.standard_normal((nB, B, W, H)).astype(np.float32)
    x_win = rng.standard_normal((nB, B, W, H, C)).astype(np.float32)
    g = rng.standard_normal((B, nB * BLK, H, C)).astype(np.float32)
    jstore = jnp.bfloat16 if store else None
    ref, vjp = jax.vjp(lambda a, s, x: jax_factored(a, s, x, jnp.asarray(bl.adj_mask), 0.2,
                                                    store_dtype=jstore),
                       jnp.asarray(a_dst), jnp.asarray(a_src), jnp.asarray(x_win))
    jgr = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_() for a in (a_dst, a_src, x_win)]
    out = band_attention_factored(*ts, torch.from_numpy(bl.adj_mask), 0.2,
                                  store_dtype=torch.bfloat16 if store else None)
    got, ref = out.detach().numpy(), np.asarray(ref)
    padded = ~bl.adj_mask.any(axis=2).reshape(-1)
    assert (got[:, padded] == 0).all() and (ref[:, padded] == 0).all()
    if store:
        err, fine = np.abs(got - ref), 1e-5 * float(np.abs(ref).max())
        assert (err <= BF16_STEP * np.abs(ref) + fine).all(), f"{err.max():.3e}"
        assert (err > fine).mean() <= 0.01
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(), ts)
    tol = 2.0 ** -6 if store else 1e-4
    for name, a, b in zip(("a_dst", "a_src_win", "x_win"), grads, jgr):
        b = np.asarray(b)
        err, top = float(np.abs(a.numpy() - b).max()), float(np.abs(b).max())
        assert err <= tol * top + 1e-6, f"{name}: {err:.3e} (max |g| {top:.3e})"


def test_op_equals_the_softmax_band_up_to_rounding(rng):
    """The factored identity: the same attention as the windowed softmax on
    every real row, within 1e-5 (f32)."""
    jt, bl = _layout()
    nB, BLK, W = bl.adj_mask.shape
    a_dst = torch.from_numpy(rng.standard_normal((1, nB * BLK, 2)).astype(np.float32))
    a_src = torch.from_numpy(rng.standard_normal((nB, 1, W, 2)).astype(np.float32))
    x_win = torch.from_numpy(rng.standard_normal((nB, 1, W, 2, 4)).astype(np.float32))
    mask = torch.from_numpy(bl.adj_mask)
    real = bl.adj_mask.any(axis=2).reshape(-1)
    fac = band_attention_factored(a_dst, a_src, x_win, mask, 0.2)[:, real]
    soft = pba.band_attention_window_plain(a_dst, a_src, x_win, mask, 0.2)[:, real]
    torch.testing.assert_close(fac, soft, rtol=1e-5, atol=1e-5)


def _trainers(nc, attn_dtype, route="dma", blocks=2):
    jt = random_graph(np.random.default_rng(9), n=50, extra_edges=25)
    pt = GraphTemplate(jt.n_node, jt.senders, jt.receivers)
    kw = dict(batch_size=2, mask_rate=0.6, criterion="mse", agg_mode="banded", band_block=16,
              donate_state=False, seed=0)
    stats = dict(norm_type="znorm", mean=1.0, std=3.0)
    jm = jax_apply_model_knobs(JaxGATRes(num_blocks=blocks, channels=nc),
                               attn_impl="band_factored", attn_dtype=attn_dtype)
    jtr = JaxTrainer(jm, JaxTrainConfig(**kw), JaxNormStats(**stats), jt)
    model = apply_model_knobs(GATRes(blocks, nc), attn_impl="band_factored",
                              attn_dtype=attn_dtype)
    ptr = Trainer(model, TrainConfig(band_attn=route, **kw), NormStats(**stats), pt, device="cpu")
    ptr.model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, jtr.params), ptr.model))
    return jt, pt, jtr, ptr


@pytest.mark.parametrize("attn_dtype", [None, "bfloat16"])
def test_gatres_small_width_banded_step_matches_jax(rng, monkeypatch, attn_dtype):
    """Two blocks at GATRes-small's width (conv1 H·C 64, conv2 32) on a
    banded graph: every GATConv runs the factored band in both packages.
    The forward within 1e-5 (f32) or the fixtures' 1e-3 (bf16 stores); the
    loss to rtol 1e-5; every gradient within 1e-3·max|g| + 1e-6, or under
    bf16 stores 2^-6·max|g| + 1e-6 (the JAX VJP rounds the stores'
    cotangents to bf16 and sums them in bf16; seen: 2.0e-3·max|g|)."""
    for var in ("GNN_TPU_BAND_FLASH", "GNN_TPU_BAND_DMA", "GNN_TPU_BAND_ACC"):
        monkeypatch.delenv(var, raising=False)
    seen = []
    monkeypatch.setattr(layers.bops, "band_attention_factored",
                        lambda *a, **k: seen.append(k) or band_attention_factored(*a, **k))
    jt, pt, jtr, ptr = _trainers(32, attn_dtype)
    n, bs = jt.n_node, 2
    xb = rng.standard_normal((bs, n)).astype(np.float32)
    k = masked_count(n, 0.6)
    mask = np.zeros((bs, n), bool)
    for b in range(bs):
        mask[b, rng.permutation(n)[:k]] = True
    mask = mask.reshape(-1)
    jg = jtr._batched_graph(jt, bs)
    jx = jg.pack_nodes(jnp.asarray(xb.reshape(-1, 1)), n)
    jm = jg.pack_nodes(jnp.asarray(mask, jnp.float32)[:, None], n)[:, 0] > 0.5

    def loss_fn(p_):
        return jtr._masked_loss_and_metrics(p_, jg, jx, jx, jm, bs * k, "train")[0]

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jtr.params)
    graph, x, pm, pn = ptr._prepare(pt, xb, mask, None, None)
    loss, _, out = ptr._masked_loss_and_metrics(graph, x, x, pm, pn, "train")
    assert len(seen) == 4 and all(s["store_dtype"] == (torch.bfloat16 if attn_dtype else None)
                                  for s in seen)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    grads = torch.autograd.grad(loss, list(ptr.model.parameters()))
    ref = params_from_flax(jax.tree.map(np.asarray, jgrads), ptr.model)
    for (name, _), g in zip(ptr.model.named_parameters(), grads):
        r = ref[name].numpy()
        err, top = float(np.abs(g.numpy() - r).max()), float(np.abs(r).max())
        assert err <= (2.0 ** -6 if attn_dtype else 1e-3) * top + 1e-6, \
            f"{name}: {err:.3e} (max |g| {top:.3e})"
    x_in = torch.where(pm[:, None], 0.0, x)
    with torch.no_grad():
        got = graph.unpack_nodes(ptr.model(x_in, graph), n).numpy()
    jx_in = jnp.where(jm[:, None], 0.0, jx)
    want = np.asarray(jg.unpack_nodes(jtr.model.apply(jtr.params, jx_in, jg), n))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 if attn_dtype else 1e-5)


def test_gatres_large_width_keeps_the_band_kernel(rng, monkeypatch):
    """At GATRes-large's width (H·C 256 / 128) the JAX layer hands every
    GATConv to its Pallas kernel, and the port keeps the graph's route: the
    band_factored model's output equals the factored preset's bit for bit,
    with the same band-attention calls and no factored band."""
    calls = {"factored": 0, "attend": 0}
    monkeypatch.setattr(layers.bops, "band_attention_factored",
                        lambda *a, **k: calls.__setitem__("factored", calls["factored"] + 1))

    def attend(*a, **k):
        calls["attend"] += 1
        return pba.band_attention(*a, **k)

    monkeypatch.setitem(layers.BAND_ATTEND, "dma", attend)
    jt = random_graph(np.random.default_rng(9), n=50, extra_edges=25)
    graph = GraphTemplate(jt.n_node, jt.senders, jt.receivers).batch(2, "banded", 16, "cpu")
    x = graph.pack_nodes(torch.from_numpy(rng.standard_normal((100, 1)).astype(np.float32)), 50)
    model = GATRes(2, 128, attn_impl="factored")
    model.reset_parameters(torch.Generator().manual_seed(2))
    with torch.no_grad():
        preset = model(x, graph)
        apply_model_knobs(model, attn_impl="band_factored")
        assert calls == {"factored": 0, "attend": 4}
        knob = model(x, graph)
    assert calls == {"factored": 0, "attend": 8}
    assert torch.equal(preset, knob)
