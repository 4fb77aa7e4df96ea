"""PyTorch port: GATConv's activation dtype (``dtype=bfloat16``, the JAX
command's ``--activation_dtype``) against the JAX package.

The JAX layer under bf16 runs its attention in bf16 ops. Its compiled (jit)
program rounds each elementwise op's output, keeps the products of a sum in
f32 where ``jnp.sum`` upcasts, and drops the rounding of an op whose result
goes straight to f32 (the bias add before ``astype(float32)``). The port
rounds at those points, so on every mode and route the forward equals the
jitted JAX layer's: each value within one bf16 step (2^-8 of its size) plus
``1e-5 + 1e-5·max|ref|``, at most 1% of them past the second term (a sum the
two packages order differently may round a step apart; none did in these
draws), and at least ``5e-4·max|ref|`` from the JAX f32 layer's.

The JAX backward accumulates its bf16 cotangents in bf16, in the order of
XLA's reduction splitting (windows of 32 added with a rounding after each
add); the port's autograd rounds the cotangents at the bf16 tensors'
boundaries and sums in f32. Their gradients therefore sit a few bf16 steps
apart, about as far as the JAX f32 layer's sit from the JAX bf16 layer's: a
layer's gradients are held within ``2^-5·max|g| + 1e-6`` (seen: at most
1.4e-2). A model's, whose sums cancel to noise in the attention vectors of
the one-head layers, are held to no farther from the JAX bf16 gradient than
twice the port's f32 gradient is, or ``2^-6·max|g|``, plus 1e-6.

Where the JAX layer hands a banded layer to a Pallas kernel (slope 0.2, H·C
at least 128), the JAX package raises (its kernels' f32 VMEM scratch meets
bf16 rows) on its v2 family and the port raises before any launch; on its
v1 kernel (the window route, or an H·C not a multiple of 128) the JAX
forward runs and its gradient raises, and so do the port's."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_pressure_estimation_tpu.models.gatres import GATRes as JaxGATRes
from gnn_pressure_estimation_tpu.models.layers import GATConv as JaxGATConv
from gnn_pressure_estimation_tpu.models.presets import MODEL_REGISTRY as JAX_REGISTRY
from gnn_pressure_estimation_tpu.models.presets import select_model as jax_select_model
from gnn_pressure_estimation_tpu.train.loop import TrainConfig as JaxTrainConfig
from gnn_pressure_estimation_tpu.train.loop import Trainer as JaxTrainer
from gnn_pressure_estimation_tpu.utils.scaling import NormStats as JaxNormStats
from gnn_pressure_estimation_tpu_torch.core.graph import GraphTemplate
from gnn_pressure_estimation_tpu_torch.data.dataset import build_template, get_keep_list
from gnn_pressure_estimation_tpu_torch.data.inp import parse_inp
from gnn_pressure_estimation_tpu_torch.models import layers
from gnn_pressure_estimation_tpu_torch.models.gatres import GATRes
from gnn_pressure_estimation_tpu_torch.models.layers import GATConv
from gnn_pressure_estimation_tpu_torch.models.presets import MODEL_REGISTRY, select_model
from gnn_pressure_estimation_tpu_torch.ops import band_attention as pba
from gnn_pressure_estimation_tpu_torch.ops import graph_attention as ga
from gnn_pressure_estimation_tpu_torch.train import TrainConfig, Trainer
from gnn_pressure_estimation_tpu_torch.utils.masking import masked_count
from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats
from gnn_pressure_estimation_tpu_torch.weights import params_from_flax, params_from_parity_npz
from helpers import random_graph

torch.set_num_threads(1)
BF16_STEP = 2.0 ** -8
ROUTE_ENV = {"dma": {}, "flash": {"GNN_TPU_BAND_FLASH": "1"}, "acc": {"GNN_TPU_BAND_ACC": "1"},
             "window": {"GNN_TPU_BAND_DMA": "0"}}
B, N, CIN = 2, 40, 12
SYNTHCTOWN = Path(__file__).resolve().parents[1] / "inputs" / "synthctown.inp"


def _set_route_env(monkeypatch, route=None):
    for var in ("GNN_TPU_BAND_FLASH", "GNN_TPU_BAND_DMA", "GNN_TPU_BAND_ACC", "GNN_TPU_BAND_ATTN",
                "GNN_TPU_FUSED_FACTORED", "GNN_TPU_FUSED_ATTN"):
        monkeypatch.delenv(var, raising=False)
    for var, value in ROUTE_ENV.get(route, {}).items():
        monkeypatch.setenv(var, value)


def _within_a_bf16_step(got, ref, what, share=0.01):
    got, ref = np.asarray(got), np.asarray(ref)
    err, fine = np.abs(got - ref), 1e-5 + 1e-5 * float(np.abs(ref).max())
    assert (err <= BF16_STEP * np.abs(ref) + fine).all(), f"{what}: {err.max():.3e}"
    assert (err > fine).mean() <= share, f"{what}: {(err > fine).sum()} of {err.size} a step off"


def _grad_close(got, ref, what, tol=2.0 ** -5):
    got, ref = np.asarray(got), np.asarray(ref)
    err, top = float(np.abs(got - ref).max()), float(np.abs(ref).max())
    assert err <= tol * top + 1e-6, f"{what}: {err:.3e} (max |g| {top:.3e})"


def _graphs(mode, route=None):
    jt = random_graph(np.random.default_rng(7), n=N, extra_edges=20)
    kw = {"band_block": 16} if mode == "banded" else {}
    jg = jt.batch(B, mode=mode, **kw)
    pg = GraphTemplate(jt.n_node, jt.senders, jt.receivers).batch(
        B, mode, kw.get("band_block"), "cpu", **({"band_attn": route} if route else {}))
    return jt, jg, pg


def _load(layer, params):
    p = jax.tree.map(np.asarray, params)["params"]
    with torch.no_grad():
        layer.lin.weight.copy_(torch.from_numpy(p["w"].T.copy()))
        for f in ("att_src", "att_dst", "bias"):
            getattr(layer, f).copy_(torch.from_numpy(p[f].copy()))


LAYER_CASES = [
    ("dense", None, "softmax", 2, 8), ("dense", None, "factored", 2, 8),
    ("dense", None, "onepass", 1, 8), ("dense", None, "band_factored", 2, 8),
    ("padded", None, "softmax", 2, 8), ("padded", None, "factored", 1, 16),
    *[("banded", r, "softmax", 2, 16) for r in ROUTE_ENV],
    ("banded", "dma", "factored", 1, 32), ("banded", "dma", "band_factored", 2, 16),
    ("banded", "acc", "band_factored", 1, 32),
]


@pytest.mark.parametrize("mode,route,impl,H,C", LAYER_CASES,
                         ids=["-".join(map(str, c)) for c in LAYER_CASES])
def test_gatconv_bf16_matches_jit_jax_layer(rng, monkeypatch, mode, route, impl, H, C):
    """Every mode and route: the forward within a bf16 step of the jitted
    JAX layer's, away from the f32 layer's; d x and the parameter gradients
    within 2^-5·max|g| + 1e-6."""
    _set_route_env(monkeypatch, route)
    jt, jg, pg = _graphs(mode, route)
    concat = H == 2
    x = rng.standard_normal((B * N, CIN)).astype(np.float32)
    g = rng.standard_normal((B * N, H * C if concat else C)).astype(np.float32)
    if mode == "banded":
        jx, jgo = jg.pack_nodes(jnp.asarray(x), N), jg.pack_nodes(jnp.asarray(g), N)
    else:
        jx, jgo = jnp.asarray(x), jnp.asarray(g)
    jl = JaxGATConv(out_channels=C, heads=H, concat=concat, attn_impl=impl, dtype=jnp.bfloat16)
    params = jl.init(jax.random.PRNGKey(0), jx, jg)
    params = {"params": {k: v + 0.1 if k == "bias" else v for k, v in params["params"].items()}}
    ref, vjp = jax.vjp(jax.jit(lambda p, xx: jl.apply(p, xx, jg)), params, jx)
    jgrads, jdx = vjp(jgo)
    ref32 = jax.jit(lambda p, xx: jl.clone(dtype=jnp.float32).apply(p, xx, jg))(params, jx)

    layer = GATConv(CIN, C, heads=H, concat=concat, attn_impl=impl, dtype=torch.bfloat16)
    _load(layer, params)
    px = torch.from_numpy(np.asarray(jx)).requires_grad_()
    out = layer(px, pg)
    assert out.dtype == torch.float32
    _within_a_bf16_step(out.detach().numpy(), ref, f"{mode} {route} {impl} forward")
    gap = float(np.abs(out.detach().numpy() - np.asarray(ref32)).max())
    assert gap >= 5e-4 * float(np.abs(ref).max()), f"only {gap:.3e} from the f32 layer"
    grads = torch.autograd.grad((out * torch.from_numpy(np.asarray(jgo))).sum(),
                                [px, *layer.parameters()])
    _grad_close(grads[0].numpy(), jdx, "d x")
    jp = jax.tree.map(np.asarray, jgrads)["params"]
    want = {"lin.weight": jp["w"].T, "att_src": jp["att_src"], "att_dst": jp["att_dst"],
            "bias": jp["bias"]}
    for (name, _), gr in zip(layer.named_parameters(), grads[1:]):
        _grad_close(gr.numpy(), want[name], name)


def test_narrow_bf16_layers_take_v2_with_the_logits_rounded(monkeypatch):
    """Under bf16 activations a narrow banded layer runs v2's bf16 instance
    with the logits rounded on every route (the JAX layer's XLA band ops
    whatever the route), the slope rounded to bf16; a dense softmax layer
    the fused attention's."""
    seen = []

    def spy(fn):
        def wrapped(*args, **kw):
            seen.append((fn.__name__, args[4], kw.get("mxu_bf16"), kw.get("logit_bf16")))
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(layers, "band_attention", spy(pba.band_attention))
    for route in ROUTE_ENV:
        _, _, pg = _graphs("banded", route)
        x = torch.ones(pg.n_graph * pg.band_n_pad, 4)
        GATConv(4, 16, heads=2, dtype=torch.bfloat16)(x, pg)
    assert seen == [("band_attention", layers.bf16_scalar(0.2), True, True)] * 4
    assert layers.bf16_scalar(0.2) == 0.2001953125
    calls = []
    monkeypatch.setattr(layers, "fused_attention",
                        lambda *a, **kw: calls.append((a[4], a[6], kw)) or ga.fused_attention(*a, **kw))
    _, _, pg = _graphs("dense")
    GATConv(4, 8, heads=2, dtype=torch.bfloat16)(torch.ones(B * N, 4), pg)
    assert calls == [(0.2001953125, True, {"logit_bf16": True})]


V2_FAMILY = ("dma", "flash", "acc")


@pytest.mark.parametrize("route", V2_FAMILY)
@pytest.mark.parametrize("H,C", [(2, 64), (1, 128)])
def test_bf16_raises_where_jax_raises(monkeypatch, route, H, C):
    """H·C a multiple of 128 on the v2 family's routes: the JAX layer hands
    it to its v2-family Pallas kernel and raises (interpret mode); the port
    raises before any launch, naming why. The dense and padded modes run the
    same layer."""
    _set_route_env(monkeypatch, route)
    jt, jg, pg = _graphs("banded", route)
    jx = jg.pack_nodes(jnp.ones((B * N, CIN), jnp.float32), N)
    jl = JaxGATConv(out_channels=C, heads=H, concat=H == 2, dtype=jnp.bfloat16)
    params = jl.clone(dtype=jnp.float32).init(jax.random.PRNGKey(0), jx, jg)
    with pytest.raises(TypeError, match="dynamic_update_slice"):
        jl.apply(params, jx, jg)
    layer = GATConv(CIN, C, heads=H, concat=H == 2, dtype=torch.bfloat16)
    called = []
    for name in ("band_attention", "band_attention_window"):
        monkeypatch.setattr(layers, name, lambda *a, **k: called.append(a))
    monkeypatch.setattr(layers, "BAND_ATTEND", {k: (lambda *a, **k_: called.append(a))
                                                for k in layers.BAND_ATTEND})
    with pytest.raises(NotImplementedError, match="v2-family Pallas band kernel"):
        layer(torch.ones(B * pg.band_n_pad, CIN), pg)
    assert called == []
    for mode in ("dense", "padded"):
        _, _, g2 = _graphs(mode)
        assert torch.isfinite(layer(torch.ones(B * N, CIN), g2)).all()


@pytest.mark.parametrize("route,H,C", [("window", 2, 64), ("window", 1, 128), ("dma", 3, 64)])
def test_bf16_on_the_v1_kernel_serves_and_refuses_its_backward(rng, monkeypatch, route, H, C):
    """Where the JAX layer takes its v1 kernel (the window route; H·C 192 on
    any route), its forward runs and its gradient raises. The port's forward
    (the window kernel's plain version here, the logits rounded, the rest
    f32) holds the JAX layer's real rows to 1e-5 + 1e-5·max|ref| and the f32
    layer's by at least 1e-4·max|ref|; its backward raises too."""
    _set_route_env(monkeypatch, route)
    jt, jg, pg = _graphs("banded", route)
    x = rng.standard_normal((B * N, CIN)).astype(np.float32)
    jx = jg.pack_nodes(jnp.asarray(x), N)
    jl = JaxGATConv(out_channels=C, heads=H, concat=True, dtype=jnp.bfloat16)
    params = jl.clone(dtype=jnp.float32).init(jax.random.PRNGKey(0), jx, jg)
    ref = np.asarray(jg.unpack_nodes(jax.jit(lambda p, xx: jl.apply(p, xx, jg))(params, jx), N))
    ref32 = np.asarray(jg.unpack_nodes(jl.clone(dtype=jnp.float32).apply(params, jx, jg), N))
    with pytest.raises((AssertionError, TypeError)):     # jitted: AssertionError
        jax.grad(lambda p: jnp.sum(jl.apply(p, jx, jg)))(params)
    layer = GATConv(CIN, C, heads=H, concat=True, dtype=torch.bfloat16)
    _load(layer, params)
    out = layer(pg.pack_nodes(torch.from_numpy(x), N).requires_grad_(), pg)
    got = pg.unpack_nodes(out, N).detach().numpy()
    err, top = float(np.abs(got - ref).max()), float(np.abs(ref).max())
    assert err <= 1e-5 + 1e-5 * top, f"{err:.3e}"
    assert float(np.abs(got - ref32).max()) >= 1e-4 * top
    with pytest.raises(NotImplementedError, match="v1 band attention"):
        out.sum().backward()


def test_gatres_large_banded_raises_before_any_launch(monkeypatch):
    """GATRes-large's first GATConv (H·C 256) raises, so no band kernel of
    the model runs: not its attention, not its means."""
    _, _, pg = _graphs("banded", "dma")
    model, _ = select_model("gatres_large", device="cpu", dtype=torch.bfloat16)
    launched = []
    monkeypatch.setattr(layers, "band_spmm", lambda *a, **k: launched.append(a))
    monkeypatch.setattr(layers, "BAND_ATTEND", {k: (lambda *a, **k_: launched.append(a))
                                                for k in layers.BAND_ATTEND})
    with pytest.raises(NotImplementedError, match="H·C 256"):
        model(torch.ones(B * pg.band_n_pad, 1), pg)
    assert launched == []


@pytest.mark.parametrize("impl", ["factored", "softmax"])
def test_gatres_dense_bf16_step_matches_jax_trainer(rng, monkeypatch, impl):
    """A GATRes (3 blocks, nc 8) B 1 dense step against the JAX ``Trainer``'s
    jitted step on one mask: the loss to rtol 1e-5 and every gradient no
    farther from the JAX bf16 gradient than twice the port's f32 gradient
    is, or 2^-6·max|g|, plus 1e-6; the forward within the fixtures' 1e-3
    (past the first layer a rounding flip may move a value a bf16 step)."""
    _set_route_env(monkeypatch)
    jt = random_graph(np.random.default_rng(11), n=30, extra_edges=14)
    pt = GraphTemplate(jt.n_node, jt.senders, jt.receivers)
    n, bs = jt.n_node, 1
    kw = dict(batch_size=bs, mask_rate=0.8, criterion="mse", donate_state=False, seed=0)
    stats = dict(norm_type="znorm", mean=1.0, std=3.0)
    jtr = JaxTrainer(JaxGATRes(num_blocks=3, channels=8, attn_impl=impl, dtype=jnp.bfloat16),
                     JaxTrainConfig(**kw), JaxNormStats(**stats), jt)
    sd = params_from_flax(jax.tree.map(np.asarray, jtr.params), GATRes(3, 8))
    runs = {}
    for dt in (torch.bfloat16, None):
        tr = Trainer(GATRes(3, 8, attn_impl=impl, dtype=dt), TrainConfig(**kw),
                     NormStats(**stats), pt, device="cpu")
        tr.model.load_state_dict(sd)
        runs[dt] = tr
    xb = rng.standard_normal((bs, n)).astype(np.float32)
    k = masked_count(n, 0.8)
    mask = np.zeros(n, bool)
    mask[rng.permutation(n)[:k]] = True
    jg = jtr._batched_graph(jt, bs)
    jx, jm = jnp.asarray(xb.reshape(-1, 1)), jnp.asarray(mask)

    def loss_fn(p_):
        return jtr._masked_loss_and_metrics(p_, jg, jx, jx, jm, k, "train")[0]

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jtr.params)
    ref = params_from_flax(jax.tree.map(np.asarray, jgrads), GATRes(3, 8))
    got = {}
    for dt, tr in runs.items():
        graph, x, pm, pn = tr._prepare(pt, xb, mask, None, None)
        loss, _, _ = tr._masked_loss_and_metrics(graph, x, x, pm, pn, "train")
        got[dt] = (float(loss), dict(zip([k_ for k_, _ in tr.model.named_parameters()],
                                         torch.autograd.grad(loss, list(tr.model.parameters())))))
    np.testing.assert_allclose(got[torch.bfloat16][0], float(jloss), rtol=1e-5)
    for name, r in ref.items():
        r = r.numpy()
        err16 = float(np.abs(got[torch.bfloat16][1][name].numpy() - r).max())
        err32 = float(np.abs(got[None][1][name].numpy() - r).max())
        assert err16 <= max(2 * err32, 2.0 ** -6 * float(np.abs(r).max())) + 1e-6, \
            f"{name}: {err16:.3e} against the f32 step's {err32:.3e}"
    with torch.no_grad():
        graph, x, _, _ = runs[torch.bfloat16]._prepare(pt, xb, mask, None, None)
        out = runs[torch.bfloat16].model(x, graph).numpy()
    jout = np.asarray(jax.jit(lambda p: jtr.model.apply(p, jx, jg))(jtr.params))
    np.testing.assert_allclose(out, jout, rtol=0, atol=1e-3, err_msg="model forward")


def test_select_model_dtype_knob_as_in_jax():
    """GATRes takes the knob (every GATConv, nothing else; the parameters
    stay f32); every zoo model raises the JAX function's ValueError."""
    model, _ = select_model("gatres_small", device="cpu", dtype=torch.bfloat16)
    convs = [m for m in model.modules() if isinstance(m, GATConv)]
    assert len(convs) == 30 and all(c.dtype is torch.bfloat16 for c in convs)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert select_model("gatres_large", device="cpu", dtype=None)[0].dtype is None
    assert set(MODEL_REGISTRY) == set(JAX_REGISTRY)
    for name in sorted(MODEL_REGISTRY):
        if name.startswith("gatres"):
            jax_select_model(name, dtype=jnp.bfloat16)
            continue
        with pytest.raises(ValueError) as jax_err:
            jax_select_model(name, dtype=jnp.bfloat16)
        with pytest.raises(ValueError) as port_err:
            select_model(name, device="cpu", dtype=torch.bfloat16)
        assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(NotImplementedError, match="dtype"):
        select_model("gatres_small", device="cpu", dtype=torch.float16)


FIXTURE = Path(__file__).resolve().parents[1] / "artifacts" / "parity_train_synthctown_act_bf16.npz"


@pytest.mark.parametrize("case", ["small_factored", "small_softmax", "large_factored",
                                  "large_softmax"])
def test_synthctown_fixture_step(case):
    """``artifacts/parity_train_synthctown_act_bf16.npz`` (the JAX
    ``Trainer``'s B 1 step, ``tools/parity_precision_export.py``): GATRes-small
    (15 blocks) and GATRes-large's width (2 blocks) on synthctown, dense.
    The blocks before the first rounding flip (blocks 0-1; the JAX and port
    f32 sums of the means differ in their last bit) within 1e-5; every block
    the loss nearer the fixture's than the f32 model's is, and each gradient
    no farther from the fixture's than twice the port's f32 gradient is, or
    2^-6·max|g|, plus 1e-4 of the model's largest gradient: through 15
    blocks the one-head layers' attention-vector gradients are cancellation
    noise, which the JAX bf16 sums leave a few bf16 steps of the summed terms
    apart (seen: 2.2e-5 where the largest gradient is 0.9)."""
    fx = np.load(FIXTURE)
    size, impl = case.split("_")
    blocks, nc = (15, 32) if size == "small" else (2, 128)
    wn = parse_inp(str(SYNTHCTOWN))
    tpl, _ = build_template(wn, get_keep_list(wn, "keep_junction", None, "pressure"), None)
    runs = {}
    for dt in (torch.bfloat16, None):
        model = GATRes(blocks, nc, attn_impl=impl, dtype=dt)
        model.load_state_dict(params_from_parity_npz(FIXTURE, prefix=f"{size}_"))
        tr = Trainer(model, TrainConfig(batch_size=1), NormStats("znorm", 50.0, 10.0), tpl,
                     device="cpu")
        graph, x, m, k = tr._prepare(tpl, fx["x"].reshape(1, -1), fx["mask"], None, None)
        acts = []
        hooks = [b.register_forward_hook(lambda mod, a, o: acts.append(o.detach().numpy()))
                 for b in model.blocks]
        loss, _, _ = tr._masked_loss_and_metrics(graph, x, x, m, k, "train")
        for h in hooks:
            h.remove()
        names = [n for n, _ in model.named_parameters()]
        runs[dt] = (float(loss), acts, dict(zip(names, torch.autograd.grad(loss, list(
            model.parameters())))))
    loss, acts, grads = runs[torch.bfloat16]
    for i in range(min(2, blocks)):
        np.testing.assert_allclose(acts[i], fx[f"{case}_act_block_{i}"], rtol=0, atol=1e-5,
                                   err_msg=f"block {i}")
    ref = float(fx[f"{case}_loss"])
    assert abs(loss - ref) < abs(float(fx[f"{case}_f32_loss"]) - ref), (loss, ref)
    top = max(float(np.abs(fx[f"{case}_grad_{name}"]).max()) for name in grads)
    for name, g in grads.items():
        r = fx[f"{case}_grad_{name}"]
        err16 = float(np.abs(g.numpy() - r).max())
        err32 = float(np.abs(runs[None][2][name].numpy() - r).max())
        assert err16 <= max(2 * err32, 2.0 ** -6 * float(np.abs(r).max())) + 1e-4 * top, \
            f"{name}: {err16:.3e} against the f32 step's {err32:.3e}"
