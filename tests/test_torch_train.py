"""PyTorch port: the training slice as a whole against the JAX ``Trainer``.

Same initial weights (``params_from_flax``), same explicit node mask, same
batch; the JAX side is its own ``Trainer._masked_loss_and_metrics`` under
``jax.value_and_grad`` and its own optimizer chain (``trainer.tx``), on the
CPU with the Pallas band kernels in interpret mode (the nc 128 case runs the
v2 band attention and the band SpMM, forward and backward). The port runs on
the CPU too, through its autograd Functions' plain versions.
"""

import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gnn_pressure_estimation_tpu.data.dataset import build_template as jax_build_template
from gnn_pressure_estimation_tpu.data.dataset import get_keep_list as jax_keep_list
from gnn_pressure_estimation_tpu.data.inp import parse_inp as jax_parse_inp
from gnn_pressure_estimation_tpu.models.gatres import GATRes as JaxGATRes
from gnn_pressure_estimation_tpu.train.loop import TrainConfig as JaxTrainConfig
from gnn_pressure_estimation_tpu.train.loop import Trainer as JaxTrainer
from gnn_pressure_estimation_tpu.utils.scaling import NormStats as JaxNormStats
from gnn_pressure_estimation_tpu_torch.core.graph import GraphTemplate
from gnn_pressure_estimation_tpu_torch.data.dataset import (
    WDNDataset, _Member, build_template, get_keep_list,
)
from gnn_pressure_estimation_tpu_torch.data.inp import parse_inp
from gnn_pressure_estimation_tpu_torch.models.gatres import GATRes
from gnn_pressure_estimation_tpu_torch.models.presets import MODEL_REGISTRY
from gnn_pressure_estimation_tpu_torch.train import TrainConfig, Trainer, load_checkpoint
from gnn_pressure_estimation_tpu_torch.utils.masking import masked_count
from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats
from gnn_pressure_estimation_tpu_torch.weights import (
    adam_state_from_optax, params_from_flax, params_to_flax,
)
from helpers import random_graph

torch.set_num_threads(1)
MINITOWN = Path(__file__).resolve().parents[1] / "inputs" / "minitown.inp"

# name → (agg_mode, band_block, channels, batch)
GRAPHS = {
    "dense14": ("dense", None, 4, 3),
    "minitown": ("banded", 8, 8, 2),
    "banded70_nc128": ("banded", 16, 128, 2),
}


def _templates(kind, rng):
    if kind == "minitown":
        jwn = jax_parse_inp(str(MINITOWN))
        jt, _ = jax_build_template(jwn, jax_keep_list(jwn, "keep_junction", None, "pressure"), None)
        wn = parse_inp(str(MINITOWN))
        pt, _ = build_template(wn, get_keep_list(wn, "keep_junction", None, "pressure"), None)
        return jt, pt
    n, extra = (14, 7) if kind == "dense14" else (70, 40)
    jt = random_graph(rng, n=n, extra_edges=extra)
    return jt, GraphTemplate(jt.n_node, jt.senders, jt.receivers)


def _explicit_mask(rng, bs, n, mask_rate):
    k = masked_count(n, mask_rate)
    mask = np.zeros((bs, n), bool)
    for b in range(bs):
        mask[b, rng.permutation(n)[:k]] = True
    return mask.reshape(-1)


@pytest.mark.parametrize("kind,criterion,clip", [
    ("dense14", "mse", False), ("dense14", "mae", False), ("dense14", "sce", False),
    ("dense14", "mse", True),
    ("minitown", "mse", False), ("minitown", "mae", False), ("minitown", "sce", False),
    ("minitown", "mae", True),
    ("banded70_nc128", "mse", False), ("banded70_nc128", "mae", False),
    ("banded70_nc128", "sce", False), ("banded70_nc128", "mse", True),
])
def test_train_step_matches_jax_trainer(rng, kind, criterion, clip):
    mode, block, nc, bs = GRAPHS[kind]
    jt, pt = _templates(kind, rng)
    n = jt.n_node
    kw = dict(batch_size=bs, mask_rate=0.5, criterion=criterion, agg_mode=mode, band_block=block,
              use_gradient_clipping=clip, clip_percentile=10.0, donate_state=False, seed=0)
    stats = dict(norm_type="znorm", mean=1.0, std=3.0)
    jtr = JaxTrainer(JaxGATRes(num_blocks=1, channels=nc), JaxTrainConfig(**kw),
                     JaxNormStats(**stats), jt)
    ptr = Trainer(GATRes(1, nc), TrainConfig(**kw), NormStats(**stats), pt, device="cpu")
    ptr.model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, jtr.params), ptr.model))

    xb = rng.standard_normal((bs, n)).astype(np.float32)
    mask = _explicit_mask(rng, bs, n, 0.5)
    n_masked = bs * masked_count(n, 0.5)

    jg = jtr._batched_graph(jt, bs)
    jx, jmask = jnp.asarray(xb.reshape(-1, 1)), jnp.asarray(mask)
    if jg.banded:
        if nc == 128:       # H·C 256 / 128: the Pallas kernels are on the path
            assert jg.band_attn_dma is not None and jg.band_spmm_dma is not None
        jx = jg.pack_nodes(jx, n)
        jmask = jg.pack_nodes(jmask.astype(jnp.float32)[:, None], n)[:, 0] > 0.5

    @jax.jit
    def jax_value_and_grad(p):
        def loss_fn(p_):
            loss, mets, _ = jtr._masked_loss_and_metrics(p_, jg, jx, jx, jmask, n_masked, "train")
            return loss, mets
        return jax.value_and_grad(loss_fn, has_aux=True)(p)

    (jloss, jmets), jgrads = jax_value_and_grad(jtr.params)

    # loss, metrics and raw gradients of one batch
    graph, x, pmask, pn = ptr._prepare(pt, xb, mask, None, None)
    assert pn == n_masked
    ptr.model.train()
    loss, mets, _ = ptr._masked_loss_and_metrics(graph, x, x, pmask, pn, "train")
    names = [k for k, _ in ptr.model.named_parameters()]
    grads = torch.autograd.grad(loss, list(ptr.model.parameters()), allow_unused=True)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert mets.keys() == jmets.keys() and len(mets) == 7
    for k in mets:
        # atol: an untrained model's corr is near 0, a small difference of f32 sums
        np.testing.assert_allclose(float(mets[k]), float(jmets[k]), rtol=1e-4, atol=2e-5,
                                   err_msg=k)
    ref = params_from_flax(jax.tree.map(np.asarray, jgrads), ptr.model)
    # sce normalises over the feature axis, which is one wide here: its exact
    # gradient is 0 and both frameworks return rounding noise (~1e-5)
    g_rtol, g_atol = (0.0, 1e-4) if criterion == "sce" else (1e-3, 1e-5)
    for name, g in zip(names, grads):
        g = torch.zeros_like(ref[name]) if g is None else g
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), rtol=g_rtol, atol=g_atol,
                                   err_msg=name)

    # five optimizer steps on that batch and mask. mse runs both trajectories
    # freely. mae's gradient is a sum of signs and sce's (a one-wide feature
    # axis) is rounding noise that Adam normalises to full steps, so their
    # trajectories part at the first residual that changes sign a step earlier
    # in one framework: there the port restarts every step from the JAX
    # parameters and optimizer state (adam_state_from_optax) and is held one
    # step at a time. Even so a component whose gradient is 0 up to rounding
    # (0 here, -1e-10 there) moves by any fraction of lr under Adam's
    # g / (|g| + eps): mae is held to one step's size lr (seen: 2.0e-4), and for
    # sce only the step's bound 2·lr holds.
    free = criterion == "mse"
    p_atol = {"mse": 2e-5, "mae": 5e-4, "sce": 2 * 5e-4 + 2e-5}[criterion]
    start = params_from_flax(jax.tree.map(np.asarray, jtr.params), ptr.model)
    jp, jopt = jtr.params, jtr.opt_state
    moved = 0.0
    for step in range(5):
        if not free and step:
            _load_optax_state(ptr, jp, jopt, names)
        (_, _), g = jax_value_and_grad(jp)
        updates, jopt = jtr.tx.update(g, jopt, jp)
        jp = optax.apply_updates(jp, updates)
        ptr.train_step(pt, xb, mask=mask)
        if free and step < 4:
            continue
        ref = params_from_flax(jax.tree.map(np.asarray, jp), ptr.model)
        for name, p in ptr.model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=0, atol=p_atol,
                                       err_msg=f"{name} after step {step + 1}")
            moved = max(moved, float((p.detach() - start[name]).abs().max()))
    assert moved > 1e-4          # the steps did move the weights


def _load_optax_state(ptr, jparams, jopt, names):
    """Put the JAX trainer's parameters, Adam moments and AutoClip ring
    buffer into the port's trainer."""
    from gnn_pressure_estimation_tpu.train.autoclip import AutoClipState

    is_state = lambda s: isinstance(s, (optax.ScaleByAdamState, AutoClipState))  # noqa: E731
    states = [s for s in jax.tree.leaves(jopt, is_leaf=is_state) if is_state(s)]
    adam = next(s for s in states if isinstance(s, optax.ScaleByAdamState))
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    ptr.model.load_state_dict(params_from_flax(to_np(jparams), ptr.model))
    ptr.optimizer.load_state_dict({
        "state": adam_state_from_optax(to_np(adam.mu), to_np(adam.nu), int(adam.count), ptr.model),
        "param_groups": ptr.optimizer.state_dict()["param_groups"]})
    for s in states:
        if isinstance(s, AutoClipState):
            ptr.autoclip.load_state_dict({"history": torch.from_numpy(np.array(s.history)),
                                          "count": torch.tensor(int(s.count))})


def _dataset(tpl, arr):
    return WDNDataset.from_members([_Member(tpl, arr, [], None)], NormStats())


def _fit_setup(rng, tmp_path, epochs, **kw):
    jt = random_graph(np.random.default_rng(3), n=14, extra_edges=7)
    tpl = GraphTemplate(jt.n_node, jt.senders, jt.receivers)
    arr = np.random.default_rng(4).standard_normal((22, 14)).astype(np.float32)  # 22 % 4: a tail
    cfg = TrainConfig(epochs=epochs, batch_size=4, mask_rate=0.5, patience=100, seed=0,
                      save_path=str(tmp_path), scheduler="ReduceLROnPlateau",
                      use_gradient_clipping=True, **kw)
    model = GATRes(1, 4)
    model.reset_parameters(torch.Generator().manual_seed(7))
    tr = Trainer(model, cfg, NormStats(), tpl, device="cpu")
    return tr, _dataset(tpl, arr), _dataset(tpl, arr[:10])


def test_fit_writes_checkpoints_and_resume_is_bit_identical(rng, tmp_path):
    log = []
    full, train_ds, val_ds = _fit_setup(rng, tmp_path / "full", 3, log_gradient=True)
    best = full.fit(train_ds, val_ds, log_fn=lambda *_: None,
                    on_epoch_end=lambda ep, m: log.append((ep, m)))
    assert [ep for ep, _ in log] == [1, 2, 3]
    assert all(math.isfinite(m["val_loss"]) and math.isfinite(m["train_loss"]) for _, m in log)
    assert {"grad_norm", "grad_norm_block_0", "model_update", "val_mae", "train_mae"} <= log[-1][1].keys()
    assert log[0][1]["model_update"] == 0.0 and log[-1][1]["model_update"] > 0.0
    assert math.isfinite(best["loss"]) and best["epoch"] in (1, 2, 3) and "train_time_s" in best
    for kind in ("best", "last"):
        assert (tmp_path / "full" / f"{kind}_model.ckpt").exists()
    params, opt_state, meta = load_checkpoint(str(tmp_path / "full" / "last_model.ckpt"),
                                              full.model.state_dict(), full.opt_state_dict())
    assert meta["epoch"] == 3 and meta["stats"] == NormStats()
    assert meta["extra"]["resume"]["best"]["epoch"] == best["epoch"]
    assert int(opt_state["autoclip.count"]) == 3 * 6      # 6 batches an epoch

    # two epochs, then a new trainer restores 'last' and runs the third
    first, train_ds, val_ds = _fit_setup(rng, tmp_path / "cut", 2, log_gradient=True)
    first.fit(train_ds, val_ds, log_fn=lambda *_: None)
    second, train_ds, val_ds = _fit_setup(rng, tmp_path / "cut", 3, log_gradient=True)
    meta = second.restore(str(tmp_path / "cut" / "last_model.ckpt"))
    assert meta["epoch"] == 2
    seen = []
    second.fit(train_ds, val_ds, log_fn=lambda *_: None, on_epoch_end=lambda ep, m: seen.append(ep))
    assert seen == [3]
    for (name, a), b in zip(full.model.state_dict().items(), second.model.state_dict().values()):
        assert torch.equal(a, b), name
    sa, sb = full.opt_state_dict(), second.opt_state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_remat_gives_the_same_gradients(rng):
    jt = random_graph(rng, n=40, extra_edges=20)
    tpl = GraphTemplate(jt.n_node, jt.senders, jt.receivers)
    xb = rng.standard_normal((2, 40)).astype(np.float32)
    mask = _explicit_mask(rng, 2, 40, 0.5)
    grads = []
    for remat in (False, True):
        model = GATRes(2, 8, remat=remat)
        model.reset_parameters(torch.Generator().manual_seed(1))
        tr = Trainer(model, TrainConfig(batch_size=2, mask_rate=0.5, agg_mode="banded",
                                        band_block=8), NormStats(), tpl, device="cpu")
        graph, x, m, k = tr._prepare(tpl, xb, mask, None, None)
        loss, _, _ = tr._masked_loss_and_metrics(graph, x, x, m, k, "train")
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_unported_options_raise(rng):
    jt = random_graph(rng, n=12, extra_edges=4)
    tpl = GraphTemplate(jt.n_node, jt.senders, jt.receivers)
    # several epochs a block and the matmul precisions are ported; a precision the
    # JAX package does not name raises
    Trainer(GATRes(1, 4), TrainConfig(epochs_per_dispatch=2, matmul_precision="bfloat16"),
            NormStats(), tpl, device="cpu")
    with pytest.raises(ValueError, match="matmul_precision"):
        Trainer(GATRes(1, 4), TrainConfig(matmul_precision="float16"), NormStats(), tpl,
                device="cpu")
    # the zarr-zip store is ported: a dataset of files that do not exist raises
    with pytest.raises(FileNotFoundError):
        WDNDataset(["a.zip"], ["a.inp"])
    with pytest.raises(ValueError, match="masks 0"):
        Trainer(GATRes(1, 4), TrainConfig(mask_rate=0.01, batch_size=2), NormStats(), tpl,
                device="cpu").train_step(tpl, np.zeros((2, 12), np.float32),
                                         generator=torch.Generator().manual_seed(0))
    # donate_state is accepted and changes nothing
    Trainer(GATRes(1, 4), TrainConfig(donate_state=False), NormStats(), tpl, device="cpu")


def test_drawn_masks_train_and_eval(rng):
    """No explicit mask: the step draws one from the generator; eval keeps
    the required indices masked and changes no weight."""
    jt = random_graph(rng, n=14, extra_edges=7)
    tpl = GraphTemplate(jt.n_node, jt.senders, jt.receivers)
    tr = Trainer(GATRes(1, 4), TrainConfig(batch_size=3, mask_rate=0.5), NormStats(), tpl,
                 required_mask_idx=(0, 5), device="cpu")
    xb = rng.standard_normal((3, 14)).astype(np.float32)
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    loss, mets, out, mask = tr.eval_step(tpl, xb, generator=torch.Generator().manual_seed(1))
    assert out.shape == (42, 1) and set(mets) == {f"val_{m}" for m in
                                                   ("error", "0.1", "corr", "r2", "mae", "rmse", "mynse")}
    m = mask.reshape(3, 14)
    assert (m.sum(1) == 7).all() and m[:, [0, 5]].all()
    assert all(torch.equal(before[k], v) for k, v in tr.model.state_dict().items())
    l1, _ = tr.train_step(tpl, xb, generator=torch.Generator().manual_seed(1))
    assert math.isfinite(float(l1))
    assert any(not torch.equal(before[k], v) for k, v in tr.model.state_dict().items())


def test_preset_feeds_train_config():
    cfg = MODEL_REGISTRY["gatres_large"].train_config(epochs=3)
    assert (cfg.criterion, cfg.norm_type, cfg.epochs, cfg.lr) == ("mse", "znorm", 3, 5e-4)


def test_params_to_flax_round_trip(rng):
    model = GATRes(2, 4)
    sd = model.state_dict()
    tree = params_to_flax(sd, model)
    assert set(tree["params"]) == {"lin0", "lin1", "block_0", "block_1"}
    back = params_from_flax(tree, model)
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
