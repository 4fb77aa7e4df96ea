"""PyTorch port: the dense path as a whole against the JAX ``Trainer``.

GATRes on a dense graph (at most ``DENSE_THRESHOLD`` nodes), each dense
``attn_impl``: same weights, same explicit mask, same batch. The JAX side
runs its Pallas kernels in interpret mode where the case says so
(``GNN_TPU_FUSED_FACTORED=1`` / ``GNN_TPU_FUSED_ATTN=1``, set by
``monkeypatch``); the port runs on the CPU through the plain versions of
``ops/graph_attention.py``. Then the synthctown fixture
(``artifacts/parity_train_synthctown.npz``, written by
``tools/parity_train_export.py --network synthctown``): GATRes-small at full
depth on the 388-node network, forward per block and one train step.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gnn_pressure_estimation_tpu.models.gatres import GATRes as JaxGATRes
from gnn_pressure_estimation_tpu.train.loop import TrainConfig as JaxTrainConfig
from gnn_pressure_estimation_tpu.train.loop import Trainer as JaxTrainer
from gnn_pressure_estimation_tpu.utils.scaling import NormStats as JaxNormStats
from gnn_pressure_estimation_tpu_torch.core.graph import GraphTemplate
from gnn_pressure_estimation_tpu_torch.data.dataset import (
    WDNDataset, _Member, build_template, get_keep_list,
)
from gnn_pressure_estimation_tpu_torch.data.inp import parse_inp
from gnn_pressure_estimation_tpu_torch.evaluation.infer import Inferencer
from gnn_pressure_estimation_tpu_torch.models.gatres import GATRes
from gnn_pressure_estimation_tpu_torch.models.presets import select_model
from gnn_pressure_estimation_tpu_torch.ops import graph_attention as ga
from gnn_pressure_estimation_tpu_torch.train import TrainConfig, Trainer
from gnn_pressure_estimation_tpu_torch.utils.masking import masked_count
from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats
from gnn_pressure_estimation_tpu_torch.weights import params_from_flax, params_from_parity_npz
from helpers import random_graph

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "artifacts" / "parity_train_synthctown.npz"


def _explicit_mask(rng, bs, n, mask_rate):
    k = masked_count(n, mask_rate)
    mask = np.zeros((bs, n), bool)
    for b in range(bs):
        mask[b, rng.permutation(n)[:k]] = True
    return mask.reshape(-1)


@pytest.mark.parametrize("impl,env,criterion", [
    ("factored", "GNN_TPU_FUSED_FACTORED", "mse"),
    ("factored", "GNN_TPU_FUSED_FACTORED", "mae"),
    ("factored", None, "mse"),
    ("softmax", "GNN_TPU_FUSED_ATTN", "mse"),
    ("onepass", None, "mse"),
])
def test_dense_train_step_matches_jax_trainer(rng, monkeypatch, impl, env, criterion):
    for name in ("GNN_TPU_FUSED_FACTORED", "GNN_TPU_FUSED_ATTN"):
        monkeypatch.delenv(name, raising=False)
    if env:
        monkeypatch.setenv(env, "1")
    n, bs, blocks, nc = 30, 3, 2, 8
    jt = random_graph(rng, n=n, extra_edges=14)
    pt = GraphTemplate(jt.n_node, jt.senders, jt.receivers)
    kw = dict(batch_size=bs, mask_rate=0.8, criterion=criterion, donate_state=False, seed=0)
    stats = dict(norm_type="znorm", mean=1.0, std=3.0)
    jtr = JaxTrainer(JaxGATRes(num_blocks=blocks, channels=nc, attn_impl=impl),
                     JaxTrainConfig(**kw), JaxNormStats(**stats), jt)
    ptr = Trainer(GATRes(blocks, nc, attn_impl=impl), TrainConfig(**kw), NormStats(**stats), pt,
                  device="cpu")
    # biases off zero, so that the masked (zeroed) nodes do not all share one logit
    jparams = jax.tree.map(
        lambda a: a + 0.1 * jnp.asarray(rng.standard_normal(a.shape), jnp.float32), jtr.params)
    ptr.model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, jparams), ptr.model))

    jg = jtr._batched_graph(jt, bs)
    assert jg.dense
    assert (jg.fused_factored is not None) == (env == "GNN_TPU_FUSED_FACTORED")
    assert (jg.fused_attn is not None) == (env == "GNN_TPU_FUSED_ATTN")
    xb = rng.standard_normal((bs, n)).astype(np.float32)
    mask = _explicit_mask(rng, bs, n, 0.8)
    n_masked = bs * masked_count(n, 0.8)
    jx, jmask = jnp.asarray(xb.reshape(-1, 1)), jnp.asarray(mask)

    @jax.jit
    def jax_value_and_grad(p):
        def loss_fn(p_):
            loss, mets, _ = jtr._masked_loss_and_metrics(p_, jg, jx, jx, jmask, n_masked, "train")
            return loss, mets
        return jax.value_and_grad(loss_fn, has_aux=True)(p)

    (jloss, jmets), jgrads = jax_value_and_grad(jparams)
    graph, x, pmask, pn = ptr._prepare(pt, xb, mask, None, None)
    assert graph.dense and graph.adj_sl_index is not None and pn == n_masked
    ptr.model.train()
    loss, mets, _ = ptr._masked_loss_and_metrics(graph, x, x, pmask, pn, "train")
    grads = torch.autograd.grad(loss, list(ptr.model.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for k in mets:
        np.testing.assert_allclose(float(mets[k]), float(jmets[k]), rtol=1e-4, atol=2e-5, err_msg=k)
    ref = params_from_flax(jax.tree.map(np.asarray, jgrads), ptr.model)
    for (name, _), g in zip(ptr.model.named_parameters(), grads):
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), rtol=1e-3, atol=1e-5, err_msg=name)

    if criterion != "mse":
        return      # mae's sign gradients part under Adam (tests/test_torch_train.py says why)
    jp, jopt = jparams, jtr.tx.init(jparams)
    for _ in range(3):
        (_, _), g = jax_value_and_grad(jp)
        updates, jopt = jtr.tx.update(g, jopt, jp)
        jp = optax.apply_updates(jp, updates)
        ptr.train_step(pt, xb, mask=mask)
    ref = params_from_flax(jax.tree.map(np.asarray, jp), ptr.model)
    for name, p in ptr.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=0, atol=2e-5,
                                   err_msg=name)


def _fit_setup(tmp_path, epochs):
    jt = random_graph(np.random.default_rng(3), n=16, extra_edges=8)
    tpl = GraphTemplate(jt.n_node, jt.senders, jt.receivers)
    arr = np.random.default_rng(4).standard_normal((14, 16)).astype(np.float32)
    cfg = TrainConfig(epochs=epochs, batch_size=4, mask_rate=0.5, seed=0, save_path=str(tmp_path))
    model = GATRes(2, 4, attn_impl="factored")
    model.reset_parameters(torch.Generator().manual_seed(7))
    tr = Trainer(model, cfg, NormStats(), tpl, device="cpu")
    ds = lambda a: WDNDataset.from_members([_Member(tpl, a, [], None)], NormStats())  # noqa: E731
    return tr, ds(arr), ds(arr[:8])


def test_dense_factored_fit_resumes_bit_identically(tmp_path):
    full, tr_ds, va_ds = _fit_setup(tmp_path / "full", 3)
    full.fit(tr_ds, va_ds, log_fn=lambda *_: None)
    first, tr_ds, va_ds = _fit_setup(tmp_path / "cut", 2)
    first.fit(tr_ds, va_ds, log_fn=lambda *_: None)
    second, tr_ds, va_ds = _fit_setup(tmp_path / "cut", 3)
    assert second.restore(str(tmp_path / "cut" / "last_model.ckpt"))["epoch"] == 2
    second.fit(tr_ds, va_ds, log_fn=lambda *_: None)
    for (name, a), b in zip(full.model.state_dict().items(), second.model.state_dict().values()):
        assert torch.equal(a, b), name


# ---- synthctown: the 388-node network of the dense path -----------------------

@pytest.fixture(scope="module")
def synthctown():
    wn = parse_inp(str(ROOT / "inputs" / "synthctown.inp"))
    tpl, _ = build_template(wn, get_keep_list(wn, "keep_junction", None, "pressure"), None,
                            name="synthctown")
    return tpl


def test_synthctown_is_dense_and_carries_its_index(synthctown):
    tpl = synthctown
    assert tpl.n_node == 388 and tpl.n_node <= GraphTemplate.DENSE_THRESHOLD
    graph = tpl.batch(2, device="cpu")
    ix = graph.adj_sl_index
    assert graph.dense and ix is tpl.batch(2, device="cpu").adj_sl_index      # cached
    mask = tpl.dense_operators()["adj_sl_mask"]
    assert ix.nnz == int(mask.sum()) and ix.nnz <= 388 + tpl.n_edge
    assert np.array_equal(tpl.dense_index().col, np.nonzero(mask)[1])
    assert tpl.dense_index() is tpl.dense_index()


@pytest.mark.parametrize("preset,blocks,nc", [("gatres_small", 15, 32), ("gatres_large", 25, 128)])
def test_presets_serve_synthctown_on_the_dense_path(rng, synthctown, preset, blocks, nc):
    model, _ = select_model(preset, device="cpu")
    assert (model.num_blocks, model.channels) == (blocks, nc)
    assert all(b.conv1.attn_impl == b.conv2.attn_impl == "factored" for b in model.blocks)
    stats = NormStats(norm_type="znorm", mean=50.0, std=10.0)
    inf = Inferencer(model, stats, device="cpu")
    snaps = rng.standard_normal((3, 388)).astype(np.float32)
    obs = inf.observed_indices(synthctown, "random", mask_rate=0.95, seed=0)
    before = ga.fused_factored_fwd.launches
    res = inf.infer(synthctown, snaps, obs, scaled=True, batch_size=2)
    assert res.pred.shape == (3, 388) and np.isfinite(res.pred).all()
    assert ga.fused_factored_fwd.launches == before           # the CPU runs the plain versions
    # the graphs that serving built and cached (batches of 2 and 1) serve a train step too
    assert not synthctown.batch(1, device="cpu").adj_sl_mask.is_inference()


def test_synthctown_fixture_is_self_consistent():
    fx = np.load(FIXTURE)
    n = 388
    assert fx["mask"].shape == (n,) and int(fx["mask"].sum()) == int(fx["n_masked"]) == int(n * 0.95)
    assert bytes(fx["path"]) == b"pallas" and bytes(fx["preset"]) == b"gatres_small"
    assert (int(fx["num_blocks"]), int(fx["nc"])) == (15, 32)
    model = GATRes(15, 32, attn_impl="factored")
    model.load_state_dict(params_from_parity_npz(FIXTURE))
    assert {k[5:] for k in fx.files if k.startswith("grad_")} == set(model.state_dict())
    kept = {k[3:] for k in fx.files if k.startswith("p3_")}
    assert kept == {k for k in model.state_dict()
                    if k.startswith(("lin0.", "lin1.", "blocks.0.", "blocks.14."))}
    assert np.array_equal(fx["x_in"], np.where(fx["mask"][:, None], 0.0, fx["x"]))
    assert all(fx[f"ours_act_block_{i}"].shape == (n, 32) for i in range(15))
    assert fx["step_losses"].shape == (3,) and fx["step_losses"][0] == fx["loss"]


def test_synthctown_fixture_forward_and_train_step(synthctown):
    """GATRes-small at full depth on the CPU (plain versions) against the JAX
    values (the Pallas fused factored kernel in interpret mode): forward
    within 1e-3 per block and at the output; loss rtol 1e-4; each gradient
    max|Δ| ≤ 1e-3·max|g_ref| + 1e-6; after 3 Adam steps atol 3e-4 (a step
    moves a parameter by up to lr = 5e-4 whatever its gradient's size)."""
    fx = np.load(FIXTURE)
    tpl = synthctown
    model = GATRes(15, 32, attn_impl="factored")
    model.load_state_dict(params_from_parity_npz(FIXTURE))
    acts = {}
    hooks = [blk.register_forward_hook(lambda m, i, o, k=k: acts.__setitem__(k, o))
             for k, blk in enumerate(model.blocks)]
    with torch.no_grad():
        out = model(torch.from_numpy(fx["x_in"]), tpl.batch(1, device="cpu"))
    for h in hooks:
        h.remove()
    for k, a in acts.items():
        np.testing.assert_allclose(a.numpy(), fx[f"ours_act_block_{k}"], rtol=0, atol=1e-3,
                                   err_msg=f"block {k}")
    np.testing.assert_allclose(out.numpy(), fx["ours_out"], rtol=0, atol=1e-3)

    stats = NormStats("znorm", float(fx["stats_mean"]), float(fx["stats_std"]))
    tr = Trainer(model, TrainConfig(batch_size=1), stats, tpl, device="cpu")
    xb = fx["x"][:, 0][None, :]
    graph, x, mask, k = tr._prepare(tpl, xb, fx["mask"], None, None)
    loss, mets, _ = tr._masked_loss_and_metrics(graph, x, x, mask, k, "train")
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(fx["loss"]), rtol=1e-4)
    for name, v in mets.items():
        # the untrained model's output is nearly constant over the nodes (std 0.02
        # scaled), so corr and r2 = corr² are small differences of f32 moment sums:
        # the output agrees to 4e-7 and corr still differs by 3.3e-4
        atol = 1e-3 if name in ("train_corr", "train_r2") else 1e-4
        np.testing.assert_allclose(float(v), float(fx[f"metric_{name}"]), rtol=1e-3, atol=atol,
                                   err_msg=name)
    for (name, _), g in zip(model.named_parameters(), grads):
        ref = fx[f"grad_{name}"]
        assert float(np.abs(g.numpy() - ref).max()) <= 1e-3 * float(np.abs(ref).max()) + 1e-6, name
    losses = [float(tr.train_step(tpl, xb, mask=fx["mask"])[0]) for _ in range(3)]
    np.testing.assert_allclose(losses, fx["step_losses"], rtol=1e-3)
    for name, p in model.named_parameters():
        if f"p3_{name}" in fx.files:
            np.testing.assert_allclose(p.detach().numpy(), fx[f"p3_{name}"], rtol=0, atol=3e-4,
                                       err_msg=name)
