"""PyTorch port: the attention precision knobs (``attn_dtype``, ``gate_dtype``)
and ``apply_model_knobs`` against the JAX package.

GATRes with ``attn_dtype=bfloat16`` takes the bf16-operand band kernels
where the JAX layer does ("dma", "flash", "acc" at H·C a multiple of 128; the
JAX side runs its Pallas kernels in interpret mode on a fresh template built
under the route's environment), stores the factored and onepass operands in
bf16 on the dense path, and computes f32 bit for bit where the JAX layer
ignores the knob (narrow banded layers, the window route, the padded mode).
Outside the band kernels the two packages' values differ by f32 rounding:
the attention logit halves a_s, a_d sum 128 channels in another order and
differ in half their elements by up to ~20 ulps. A weight or an x element
that lands on the other side of a bf16 rounding boundary (a flip) moves the
products that read it by up to 2^-8 of their size: about one layer in five
flips one, which moved a layer's att_dst gradient by 1.8e-3·max|g| here. So
the layer test feeds inputs and weights on a dyadic grid, on which the
projection and the logit halves are exact in f32 in any order: the two
layers then hand their band attention the same operands, and the output, d x
and every parameter gradient are held within ``1e-5 + 1e-5·max|ref|`` of
the JAX bf16 layer, and the output at least ``5e-4·max|ref|`` from the JAX
f32 layer's (x on the grid loses fewer bits to bf16). Past the first layer of a model no grid survives, so a model's
forward is held to the fixtures' 1e-3 and its train-step gradients to
``1e-3·max|g| + 1e-6`` (the training gate of the port's fixtures). The ops
with identical random inputs are ``tests/test_torch_band_bf16.py``."""

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
from gnn_pressure_estimation_tpu.models.layers import SimpleMeanConv as JaxSimpleMeanConv
from gnn_pressure_estimation_tpu.models.presets import apply_model_knobs as jax_apply_model_knobs
from gnn_pressure_estimation_tpu.train.loop import TrainConfig as JaxTrainConfig
from gnn_pressure_estimation_tpu.train.loop import Trainer as JaxTrainer
from gnn_pressure_estimation_tpu.utils.scaling import NormStats as JaxNormStats
from gnn_pressure_estimation_tpu_torch.core.graph import GraphTemplate
from gnn_pressure_estimation_tpu_torch.data.dataset import build_template, get_keep_list
from gnn_pressure_estimation_tpu_torch.data.inp import parse_inp
from gnn_pressure_estimation_tpu_torch.models import layers
from gnn_pressure_estimation_tpu_torch.models.gatres import GATRes
from gnn_pressure_estimation_tpu_torch.models.layers import GATConv, SimpleMeanConv
from gnn_pressure_estimation_tpu_torch.models.presets import apply_model_knobs, select_model
from gnn_pressure_estimation_tpu_torch.ops import band_attention as pba
from gnn_pressure_estimation_tpu_torch.ops import graph_attention as ga
from gnn_pressure_estimation_tpu_torch.train import TrainConfig, Trainer
from gnn_pressure_estimation_tpu_torch.utils.masking import masked_count
from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats
from gnn_pressure_estimation_tpu_torch.weights import params_from_flax
from helpers import random_graph

torch.set_num_threads(1)
MINITOWN = Path(__file__).resolve().parents[1] / "inputs" / "minitown.inp"
ROUTE_ENV = {"dma": {}, "flash": {"GNN_TPU_BAND_FLASH": "1"}, "acc": {"GNN_TPU_BAND_ACC": "1"}}
BF16_ROUTES = list(ROUTE_ENV)


def _set_route_env(monkeypatch, route):
    for var in ("GNN_TPU_BAND_FLASH", "GNN_TPU_BAND_DMA", "GNN_TPU_BAND_ACC", "GNN_TPU_BAND_ATTN",
                "GNN_TPU_FUSED_FACTORED", "GNN_TPU_FUSED_ATTN"):
        monkeypatch.delenv(var, raising=False)
    for var, value in ROUTE_ENV.get(route, {}).items():
        monkeypatch.setenv(var, value)


def _close(got, ref, what):
    """Within 1e-5 + 1e-5·max|ref|."""
    got, ref = np.asarray(got), np.asarray(ref)
    err, top = float(np.abs(got - ref).max()), float(np.abs(ref).max())
    assert err <= 1e-5 + 1e-5 * top, f"{what}: {err:.3e} (max |ref| {top:.3e})"


def _dyadic(rng, shape, step, bound):
    """Values on the grid ``step·k`` in [−bound, bound]: few mantissa bits,
    so sums of their products are exact in f32 in any order."""
    return (np.round(rng.uniform(-bound, bound, shape) / step) * step).astype(np.float32)


def _grads_close(names, grads, ref, what):
    """Each gradient within 1e-3·max|g_ref| + 1e-6."""
    for name, g in zip(names, grads):
        r = ref[name].numpy()
        err, top = float(np.abs(g.numpy() - r).max()), float(np.abs(r).max())
        assert err <= 1e-3 * top + 1e-6, f"{what} {name}: {err:.3e} (max |g| {top:.3e})"


# ---- apply_model_knobs ------------------------------------------------------------

def test_apply_model_knobs_accepts_what_the_jax_function_accepts():
    model, _ = select_model("gatres_small", device="cpu")
    assert apply_model_knobs(model) is model
    assert all(c.attn_dtype is None for c in model.modules() if isinstance(c, GATConv))
    for value, want in (("bfloat16", torch.bfloat16), ("float32", torch.float32),
                        (torch.bfloat16, torch.bfloat16)):
        apply_model_knobs(model, attn_dtype=value, gate_dtype=value)
        convs = [c for c in model.modules() if isinstance(c, GATConv)]
        assert len(convs) == 30 and model.attn_dtype is want
        assert all(c.attn_dtype is want and c.gate_dtype is want for c in convs)
    apply_model_knobs(model, attn_impl="onepass")
    assert all(c.attn_impl == "onepass" for c in model.modules() if isinstance(c, GATConv))
    apply_model_knobs(model, attn_dtype=None)                 # None leaves the value set
    assert model.blocks[0].conv1.attn_dtype is torch.bfloat16
    # the JAX function on the same arguments
    jm = jax_apply_model_knobs(JaxGATRes(), attn_dtype="bfloat16", gate_dtype="float32")
    assert jm.attn_dtype == jnp.bfloat16 and jm.gate_dtype == jnp.float32


@pytest.mark.parametrize("kwargs", [dict(attn_dtype="float16"), dict(gate_dtype="bf16"),
                                    dict(attn_dtype="")])
def test_apply_model_knobs_bad_dtype_string_raises_as_in_jax(kwargs):
    with pytest.raises(ValueError) as jax_err:
        jax_apply_model_knobs(JaxGATRes(), **kwargs)
    model, _ = select_model("gatres_small", device="cpu")
    with pytest.raises(ValueError) as port_err:
        apply_model_knobs(model, **kwargs)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("knob", ["attn_dtype", "gate_dtype", "attn_impl"])
def test_apply_model_knobs_on_a_model_without_the_knob_raises_as_in_jax(knob):
    value = "factored" if knob == "attn_impl" else "bfloat16"
    with pytest.raises(ValueError) as jax_err:
        jax_apply_model_knobs(JaxSimpleMeanConv(), **{knob: value})
    with pytest.raises(ValueError) as port_err:
        apply_model_knobs(SimpleMeanConv(), **{knob: value})
    assert str(port_err.value) == str(jax_err.value)


def test_dtype_knobs_the_port_does_not_compute_raise():
    with pytest.raises(NotImplementedError, match="attn_dtype"):
        GATConv(4, 4, attn_dtype=torch.float16)
    model, _ = select_model("gatres_small", device="cpu")
    with pytest.raises(NotImplementedError, match="gate_dtype"):
        apply_model_knobs(model, gate_dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="band_factored"):
        apply_model_knobs(model, attn_impl="band_factored")


def test_params_from_flax_carries_a_bf16_model_unchanged():
    """The knob changes no parameter: a JAX GATRes(attn_dtype=bf16) has the
    f32 tree of the default model, and the port loads it as it is."""
    jt = random_graph(np.random.default_rng(1), n=20, extra_edges=10)
    jg = jt.batch(1, mode="dense")
    x = jnp.zeros((jt.n_node, 1), jnp.float32)
    p16 = JaxGATRes(2, 8, attn_dtype=jnp.bfloat16).init(jax.random.PRNGKey(3), x, jg)
    p32 = JaxGATRes(2, 8).init(jax.random.PRNGKey(3), x, jg)
    model = GATRes(2, 8, attn_dtype=torch.bfloat16)
    sd16, sd32 = (params_from_flax(jax.tree.map(np.asarray, p), model) for p in (p16, p32))
    assert sd16.keys() == sd32.keys()
    assert all(v.dtype == torch.float32 and torch.equal(v, sd32[k]) for k, v in sd16.items())
    model.load_state_dict(sd16)


# ---- banded: the bf16 instances on dma, flash, acc ------------------------------------

@pytest.mark.parametrize("route", BF16_ROUTES)
@pytest.mark.parametrize("H,C", [(2, 64), (1, 128)])
def test_gatconv_bf16_matches_jax_layer(rng, monkeypatch, route, H, C):
    """H·C 128 under the 1 MiB guard: the JAX layer reaches the route's
    Pallas kernel with mxu_bf16 (interpret mode); the port launches nothing
    on the CPU and runs the bf16 plain versions. x, w and the attention
    vectors on dyadic grids (2^-3 up to 1, 2^-4 up to 1/2): xp is a multiple
    of 2^-7 below 6 and a_s, a_d of 2^-11 below 384, exact in f32 whatever
    the order of the sums."""
    _set_route_env(monkeypatch, route)
    B, block, cin = 2, 16, 12
    jt = random_graph(np.random.default_rng(5), n=70, extra_edges=40)
    jg = jt.batch(B, mode="banded", band_block=block)
    assert jg.band_attn_dma is not None
    n = jt.n_node
    pg = GraphTemplate(n, jt.senders, jt.receivers).batch(B, "banded", block, "cpu", band_attn=route)
    x = _dyadic(rng, (B * n, cin), 2.0 ** -3, 1.0)
    w = rng.standard_normal((B * n, H * C if H == 2 else C)).astype(np.float32)
    concat = H == 2
    jl = JaxGATConv(out_channels=C, heads=H, concat=concat, attn_dtype=jnp.bfloat16)
    jx, jw = jg.pack_nodes(jnp.asarray(x), n), jg.pack_nodes(jnp.asarray(w), n)
    params = jl.init(jax.random.PRNGKey(0), jx, jg)
    params = {"params": {k: jnp.asarray(_dyadic(rng, v.shape, 2.0 ** -4, 0.5)) if k != "bias"
                         else v + 0.1 for k, v in params["params"].items()}}
    ref = jl.apply(params, jx, jg)
    jl32 = jl.clone(attn_dtype=None)
    ref32 = jl32.apply(params, jx, jg)
    jgrads, jdx = jax.grad(lambda p, xx: jnp.sum(jl.apply(p, xx, jg) * jw), argnums=(0, 1))(params, jx)

    layer = GATConv(cin, C, heads=H, concat=concat, attn_dtype=torch.bfloat16)
    p = jax.tree.map(np.asarray, params)["params"]
    with torch.no_grad():
        layer.lin.weight.copy_(torch.from_numpy(p["w"].T.copy()))
        for f in ("att_src", "att_dst", "bias"):
            getattr(layer, f).copy_(torch.from_numpy(p[f].copy()))
    px = pg.pack_nodes(torch.from_numpy(x), n).requires_grad_()
    pw = pg.pack_nodes(torch.from_numpy(w), n)
    out = layer(px, pg)
    got = pg.unpack_nodes(out, n).detach().numpy()
    _close(got, jg.unpack_nodes(ref, n), f"{route} forward")
    gap = float(np.abs(got - np.asarray(jg.unpack_nodes(ref32, n))).max())
    # on the grid x loses fewer bits to bf16 than at random (the ops' 1e-3 test)
    assert gap >= 5e-4 * float(np.abs(ref).max()), f"{route}: only {gap:.3e} from the f32 layer"
    grads = torch.autograd.grad((out * pw).sum(), [px, *layer.parameters()])
    _close(pg.unpack_nodes(grads[0], n).numpy(), jg.unpack_nodes(jdx, n), f"{route} d x")
    jg_p = jax.tree.map(np.asarray, jgrads)["params"]
    want = {"lin.weight": jg_p["w"].T, "att_src": jg_p["att_src"], "att_dst": jg_p["att_dst"],
            "bias": jg_p["bias"]}
    for (name, _), g in zip(layer.named_parameters(), grads[1:]):
        _close(g.numpy(), want[name], f"{route} {name}")


def _step(jtr, ptr, jt, pt, rng, bs, mask_rate):
    """Loss and gradients of one train step on the same batch and mask in
    both packages; returns ``(loss, jax loss, names, grads, jax grads)``."""
    n = jt.n_node
    xb = rng.standard_normal((bs, n)).astype(np.float32)
    k = masked_count(n, mask_rate)
    mask = np.zeros((bs, n), bool)
    for b in range(bs):
        mask[b, rng.permutation(n)[:k]] = True
    mask = mask.reshape(-1)
    jg = jtr._batched_graph(jt, bs)
    if jg.banded:
        jx = jg.pack_nodes(jnp.asarray(xb.reshape(-1, 1)), n)
        jmask = jg.pack_nodes(jnp.asarray(mask).astype(jnp.float32)[:, None], n)[:, 0] > 0.5
    else:
        jx, jmask = jnp.asarray(xb.reshape(-1, 1)), jnp.asarray(mask)

    def loss_fn(p_):
        return jtr._masked_loss_and_metrics(p_, jg, jx, jx, jmask, bs * k, "train")[0]

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jtr.params)
    graph, x, pmask, pn = ptr._prepare(pt, xb, mask, None, None)
    ptr.model.train()
    loss, _, _ = ptr._masked_loss_and_metrics(graph, x, x, pmask, pn, "train")
    names = [k for k, _ in ptr.model.named_parameters()]
    grads = torch.autograd.grad(loss, list(ptr.model.parameters()))
    return float(loss.detach()), float(jloss), names, grads, \
        params_from_flax(jax.tree.map(np.asarray, jgrads), ptr.model), graph, x, jg, jx


@pytest.mark.parametrize("route", BF16_ROUTES)
def test_gatres_large_width_bf16_matches_jax_model_and_step(rng, monkeypatch, route):
    """3 blocks at GATRes-large width (nc 128: conv1 H·C 256, conv2 128) on
    minitown (BLK 8): every GATConv takes the bf16 instance on both sides;
    the forward, the loss and every gradient of one train step, and a
    forward that is not the f32 model's."""
    _set_route_env(monkeypatch, route)
    jwn = jax_parse_inp(str(MINITOWN))
    jt, _ = jax_build_template(jwn, jax_keep_list(jwn, "keep_junction", None, "pressure"), None)
    wn = parse_inp(str(MINITOWN))
    pt, _ = build_template(wn, get_keep_list(wn, "keep_junction", None, "pressure"), None)
    bs, nc = 2, 128
    kw = dict(batch_size=bs, mask_rate=0.5, criterion="mse", agg_mode="banded", band_block=8,
              donate_state=False, seed=0)
    stats = dict(norm_type="znorm", mean=1.0, std=3.0)
    jtr = JaxTrainer(jax_apply_model_knobs(JaxGATRes(num_blocks=3, channels=nc),
                                           attn_dtype="bfloat16"),
                     JaxTrainConfig(**kw), JaxNormStats(**stats), jt)
    model = apply_model_knobs(GATRes(3, nc), attn_dtype="bfloat16")
    ptr = Trainer(model, TrainConfig(band_attn=route, **kw), NormStats(**stats), pt, device="cpu")
    ptr.model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, jtr.params), ptr.model))
    loss, jloss, names, grads, ref, graph, x, jg, jx = _step(jtr, ptr, jt, pt, rng, bs, 0.5)
    assert jg.band_attn_dma is not None and graph.band_attn == route
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    _grads_close(names, grads, ref, route)

    n = jt.n_node
    with torch.no_grad():
        out = graph.unpack_nodes(ptr.model(x, graph), n).numpy()
        apply_model_knobs(ptr.model, attn_dtype="float32")
        out32 = graph.unpack_nodes(ptr.model(x, graph), n).numpy()
    jout = np.asarray(jg.unpack_nodes(jtr.model.apply(jtr.params, jx, jg), n))
    np.testing.assert_allclose(out, jout, rtol=0, atol=1e-3, err_msg=f"{route} model forward")
    assert np.abs(out - out32).max() > 1e-5 * np.abs(jout).max(), f"{route}: the knob did nothing"


# ---- where the knob changes nothing -------------------------------------------------------

@pytest.mark.parametrize("case", ["small_banded", "window", "padded"])
def test_bf16_is_f32_bit_for_bit_where_jax_ignores_it(rng, case):
    """GATRes-small's banded layers (H·C 64 / 32: the JAX layer takes its
    plain band ops), the window route (v1 has no bf16 instance) and the
    padded mode: the bf16 model computes the f32 model's values to the bit,
    forward and gradients, and launches no bf16 instance."""
    jt = random_graph(np.random.default_rng(2), n=60, extra_edges=30)
    tpl = GraphTemplate(jt.n_node, jt.senders, jt.receivers)
    nc = 32 if case == "small_banded" else 128
    graph = (tpl.batch(2, "padded", None, "cpu") if case == "padded" else
             tpl.batch(2, "banded", 16, "cpu", band_attn="window" if case == "window" else "dma"))
    n = jt.n_node
    x = torch.from_numpy(rng.standard_normal((2 * n, 1)).astype(np.float32))
    x = x if case == "padded" else graph.pack_nodes(x, n)
    model = GATRes(2, nc)
    model.reset_parameters(torch.Generator().manual_seed(4))
    runs = []
    for dtype in ("float32", "bfloat16"):
        apply_model_knobs(model, attn_dtype=dtype)
        out = model(x, graph)
        runs.append((out.detach(), torch.autograd.grad(out.square().sum(), list(model.parameters()))))
    (o32, g32), (o16, g16) = runs
    assert torch.equal(o32, o16)
    assert all(torch.equal(a, b) for a, b in zip(g32, g16))


def test_bf16_routes_the_band_wrappers_by_width(monkeypatch):
    """GATRes-large width sends every banded GATConv to the bf16 instance
    (conv1 H·C 256, conv2 128); GATRes-small width none."""
    seen = []

    def spy(*args, mxu_bf16=False, **kw):
        seen.append(mxu_bf16)
        return pba.band_attention(*args, mxu_bf16=mxu_bf16, **kw)

    monkeypatch.setitem(layers.BAND_ATTEND, "dma", spy)
    jt = random_graph(np.random.default_rng(2), n=40, extra_edges=20)
    graph = GraphTemplate(jt.n_node, jt.senders, jt.receivers).batch(1, "banded", 16, "cpu")
    x = graph.pack_nodes(torch.ones(jt.n_node, 1), jt.n_node)
    for nc, want in ((128, [True] * 4), (32, [False] * 4)):
        seen.clear()
        apply_model_knobs(GATRes(2, nc), attn_dtype="bfloat16")(x, graph)
        assert seen == want


# ---- dense ---------------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["factored", "onepass"])
def test_dense_bf16_step_matches_jax_default_branch(rng, monkeypatch, impl):
    """The JAX layer's default (XLA) branch stores v·[x, 1], q·[x, 1]
    (factored) or the numerator and x (onepass) in bf16; the port rounds the
    same operands in glue. The tolerances of tests/test_torch_dense_train.py."""
    _set_route_env(monkeypatch, None)
    n, bs, blocks, nc = 30, 3, 2, 8
    jt = random_graph(rng, n=n, extra_edges=14)
    pt = GraphTemplate(jt.n_node, jt.senders, jt.receivers)
    kw = dict(batch_size=bs, mask_rate=0.8, criterion="mse", donate_state=False, seed=0)
    stats = dict(norm_type="znorm", mean=1.0, std=3.0)
    jtr = JaxTrainer(JaxGATRes(num_blocks=blocks, channels=nc, attn_impl=impl,
                               attn_dtype=jnp.bfloat16),
                     JaxTrainConfig(**kw), JaxNormStats(**stats), jt)
    ptr = Trainer(GATRes(blocks, nc, attn_impl=impl, attn_dtype=torch.bfloat16), TrainConfig(**kw),
                  NormStats(**stats), pt, device="cpu")
    jtr.params = jax.tree.map(
        lambda a: a + 0.1 * jnp.asarray(rng.standard_normal(a.shape), jnp.float32), jtr.params)
    ptr.model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, jtr.params), ptr.model))
    loss, jloss, names, grads, ref, graph, x, jg, jx = _step(jtr, ptr, jt, pt, rng, bs, 0.8)
    assert jg.dense and jg.fused_factored is None and jg.fused_attn is None
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), rtol=1e-3, atol=1e-5, err_msg=name)
    with torch.no_grad():
        out = ptr.model(x, graph).numpy()
        apply_model_knobs(ptr.model, attn_dtype="float32")
        out32 = ptr.model(x, graph).numpy()
    jout = np.asarray(jtr.model.apply(jtr.params, jx, jg))
    np.testing.assert_allclose(out, jout, rtol=1e-5, atol=2e-6)
    assert not np.array_equal(out, out32)


# ---- dense softmax: the bf16 instances of fused_attention ----------------------------------

BF16_STEP = 2.0 ** -8      # one bf16 step: a rounding that lands on the other side


def _within_a_bf16_step(got, ref, what, share=0.01):
    """Each value within one bf16 step (2^-8·|ref|) plus 1e-5 + 1e-5·max|ref|,
    and at most ``share`` of them beyond the second term: a sum rounded to
    bf16 may land a step away where the two packages' f32 sums differ in
    their last bit."""
    got, ref = np.asarray(got), np.asarray(ref)
    err, fine = np.abs(got - ref), 1e-5 + 1e-5 * float(np.abs(ref).max())
    assert (err <= BF16_STEP * np.abs(ref) + fine).all(), f"{what}: {err.max():.3e}"
    assert (err > fine).mean() <= share, f"{what}: {(err > fine).sum()} of {err.size} a step off"


def _dense_pair(n, B):
    """A JAX and a port dense graph of one random template, B graphs."""
    jt = random_graph(np.random.default_rng(7), n=n, extra_edges=n // 2)
    jg = jt.batch(B, mode="dense")
    assert jg.dense and jg.fused_attn is None
    return jt, jg, GraphTemplate(jt.n_node, jt.senders, jt.receivers).batch(B, "dense", None, "cpu")


@pytest.mark.parametrize("H,C,concat", [(2, 8, True), (1, 16, False)])
def test_gatconv_dense_softmax_bf16_matches_jax_layer(rng, monkeypatch, H, C, concat):
    """The JAX layer's XLA branch (GNN_TPU_FUSED_ATTN unset) against the
    port's bf16 plain versions. x, the weights and the cotangent on dyadic
    grids (2^-3, 2^-4, 2^-6): xp and the logit halves are exact in f32 in any
    order and so is each dp, so the two packages round the same dp. The
    output and d x hold the product's bf16 rounding, whose f32 sum runs in
    another order in each package: each value within one bf16 step, at most
    1% a step off; the parameter gradients within 1e-3·max|g| + 1e-6 (the
    fixtures' training gate); the output at least 5e-4·max|ref| from the JAX
    f32 layer's."""
    _set_route_env(monkeypatch, None)
    B, n, cin = 2, 30, 12
    jt, jg, pg = _dense_pair(n, B)
    x = _dyadic(rng, (B * n, cin), 2.0 ** -3, 1.0)
    g = _dyadic(rng, (B * n, H * C if concat else C), 2.0 ** -6, 1.0)
    jl = JaxGATConv(out_channels=C, heads=H, concat=concat, attn_impl="softmax",
                    attn_dtype=jnp.bfloat16)
    params = jl.init(jax.random.PRNGKey(0), jnp.asarray(x), jg)
    params = {"params": {k: jnp.asarray(_dyadic(rng, v.shape, 2.0 ** -4, 0.5)) if k != "bias"
                         else v + 0.125 for k, v in params["params"].items()}}
    ref, vjp = jax.vjp(lambda p, xx: jl.apply(p, xx, jg), params, jnp.asarray(x))
    jgrads, jdx = vjp(jnp.asarray(g))
    ref32 = jl.clone(attn_dtype=None).apply(params, jnp.asarray(x), jg)

    layer = GATConv(cin, C, heads=H, concat=concat, attn_dtype=torch.bfloat16)
    p = jax.tree.map(np.asarray, params)["params"]
    with torch.no_grad():
        layer.lin.weight.copy_(torch.from_numpy(p["w"].T.copy()))
        for f in ("att_src", "att_dst", "bias"):
            getattr(layer, f).copy_(torch.from_numpy(p[f].copy()))
    px = torch.from_numpy(x).requires_grad_()
    out = layer(px, pg)
    _within_a_bf16_step(out.detach().numpy(), ref, "forward")
    gap = float(np.abs(out.detach().numpy() - np.asarray(ref32)).max())
    assert gap >= 5e-4 * float(np.abs(ref).max()), f"only {gap:.3e} from the f32 layer"
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(), [px, *layer.parameters()])
    _within_a_bf16_step(grads[0].numpy(), jdx, "d x")
    jg_p = jax.tree.map(np.asarray, jgrads)["params"]
    want = {"lin.weight": jg_p["w"].T, "att_src": jg_p["att_src"], "att_dst": jg_p["att_dst"],
            "bias": jg_p["bias"]}
    names = [k for k, _ in layer.named_parameters()]
    _grads_close(names, grads[1:], {k: torch.from_numpy(np.array(v)) for k, v in want.items()},
                 "dense softmax bf16")


def test_gatres_dense_softmax_bf16_matches_jax_model(rng, monkeypatch):
    """Two blocks on a dense graph: the forward within the fixtures' 1e-3 of
    the JAX bf16 model (past the first layer no grid survives), and not the
    f32 model's."""
    _set_route_env(monkeypatch, None)
    B, n = 2, 30
    jt, jg, pg = _dense_pair(n, B)
    x = rng.standard_normal((B * n, 1)).astype(np.float32)
    jm = JaxGATRes(num_blocks=2, channels=16, attn_impl="softmax", attn_dtype=jnp.bfloat16)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), jg)
    params = jax.tree.map(lambda a: a + 0.1 * jnp.asarray(rng.standard_normal(a.shape), a.dtype),
                          params)
    ref = np.asarray(jm.apply(params, jnp.asarray(x), jg))
    model = GATRes(2, 16, attn_impl="softmax", attn_dtype=torch.bfloat16)
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params), model))
    with torch.no_grad():
        out = model(torch.from_numpy(x), pg).numpy()
        apply_model_knobs(model, attn_dtype="float32")
        out32 = model(torch.from_numpy(x), pg).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3)
    assert np.abs(out - out32).max() > 1e-5 * np.abs(ref).max(), "the knob did nothing"


def test_dense_softmax_bf16_step_matches_jax_trainer(rng, monkeypatch):
    """One train step of a 2-block GATRes with attn_impl="softmax" and
    attn_dtype=bfloat16 against the JAX Trainer (its XLA branch): the loss
    within 1e-5 relative, every gradient within the fixtures' training gate
    1e-3·max|g| + 1e-6."""
    _set_route_env(monkeypatch, None)
    n, bs, blocks, nc = 30, 3, 2, 8
    jt = random_graph(rng, n=n, extra_edges=14)
    pt = GraphTemplate(jt.n_node, jt.senders, jt.receivers)
    kw = dict(batch_size=bs, mask_rate=0.8, criterion="mse", donate_state=False, seed=0)
    stats = dict(norm_type="znorm", mean=1.0, std=3.0)
    jtr = JaxTrainer(JaxGATRes(num_blocks=blocks, channels=nc, attn_impl="softmax",
                               attn_dtype=jnp.bfloat16),
                     JaxTrainConfig(**kw), JaxNormStats(**stats), jt)
    ptr = Trainer(GATRes(blocks, nc, attn_impl="softmax", attn_dtype=torch.bfloat16),
                  TrainConfig(**kw), NormStats(**stats), pt, device="cpu")
    jtr.params = jax.tree.map(
        lambda a: a + 0.1 * jnp.asarray(rng.standard_normal(a.shape), jnp.float32), jtr.params)
    ptr.model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, jtr.params), ptr.model))
    loss, jloss, names, grads, ref, graph, x, jg, jx = _step(jtr, ptr, jt, pt, rng, bs, 0.8)
    assert jg.dense and jg.fused_attn is None
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    _grads_close(names, grads, ref, "dense softmax bf16 step")


def test_dense_softmax_bf16_takes_the_bf16_instances_and_saves_bf16_v(monkeypatch):
    """Every dense GATConv of a bf16 softmax model hands both wrappers its
    bf16 copy of v with bf16=True (the Function saves that copy, no f32 v);
    the f32 model hands f32 v with bf16=False."""
    seen = []

    def spy(wrapper):
        def run(*args):                  # the Function passes v third and bf16 last
            seen.append((wrapper.__name__, args[2].dtype, args[-1]))
            return wrapper(*args)
        return run

    for name in ("fused_attention_fwd", "fused_attention_bwd"):
        monkeypatch.setattr(ga, name, spy(getattr(ga, name)))
    jt = random_graph(np.random.default_rng(0), n=12, extra_edges=6)
    graph = GraphTemplate(jt.n_node, jt.senders, jt.receivers).batch(1, "dense", None, "cpu")
    for dtype, want in ((torch.bfloat16, (torch.bfloat16, True)),
                        (None, (torch.float32, False))):
        seen.clear()
        model = GATRes(2, 8, attn_impl="softmax", attn_dtype=dtype)
        model(torch.ones(jt.n_node, 1), graph).square().sum().backward()
        assert [s[0] for s in seen] == ["fused_attention_fwd"] * 4 + ["fused_attention_bwd"] * 4
        assert all(s[1:] == want for s in seen)
