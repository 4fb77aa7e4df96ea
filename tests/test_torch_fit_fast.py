"""PyTorch port: ``epochs_per_dispatch > 1``, the multi-epoch block of
``Trainer.fit`` (``Trainer._fit_fast``), against the JAX package's
``_fit_fast``.

Both packages take each epoch's order from ``default_rng([seed,
epoch]).permutation``, pad the tail batch with graph 0 under a zeroed mask,
divide each step's loss by its mask's count and weigh the epoch's steps by
their valid graphs, and decide early stop, the scheduler and the checkpoints
per block. Their mask streams differ (the JAX PRNG is not reproduced), so a
run against the JAX one replays the JAX masks (``fit(masks=...)``). Held: per
epoch the train and validation losses and metrics to rtol 1e-4; the
parameters after the run (12 Adam steps on a 2-block GATRes) within 3e-3 of
the largest magnitude of their tensor (the fixtures' gate for parameters
after Adam steps, whose updates scale noise gradients up). Within the port:
a run at E 2 equals one at E 4 and a resumed one bit for bit, and the host
reads back once a block."""

import math
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from gnn_pressure_estimation_tpu.data.dataset import WDNDataset as JaxWDNDataset
from gnn_pressure_estimation_tpu.data.dataset import _Member as JaxMember
from gnn_pressure_estimation_tpu.models.gatres import GATRes as JaxGATRes
from gnn_pressure_estimation_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from gnn_pressure_estimation_tpu.train.loop import TrainConfig as JaxTrainConfig
from gnn_pressure_estimation_tpu.train.loop import Trainer as JaxTrainer
from gnn_pressure_estimation_tpu.train.loop import get_lr as jax_get_lr
from gnn_pressure_estimation_tpu.utils.masking import batch_node_mask as jax_batch_node_mask
from gnn_pressure_estimation_tpu.utils.scaling import NormStats as JaxNormStats
from gnn_pressure_estimation_tpu_torch.core.graph import GraphTemplate
from gnn_pressure_estimation_tpu_torch.data.dataset import WDNDataset, _Member
from gnn_pressure_estimation_tpu_torch.models.gatres import GATRes
from gnn_pressure_estimation_tpu_torch.parallel.trainer import MeshTrainer
from gnn_pressure_estimation_tpu_torch.train import TrainConfig, Trainer
from gnn_pressure_estimation_tpu_torch.train.checkpoint import load_checkpoint
from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats
from gnn_pressure_estimation_tpu_torch.weights import params_from_flax
from helpers import random_graph

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import flax_ckpt_to_torch  # noqa: E402

torch.set_num_threads(1)
N, BS, S_TR, S_VAL = 20, 4, 10, 6            # tails of 2 in both splits
STATS = dict(norm_type="znorm", mean=0.0, std=1.0)


def _data():
    rng = np.random.default_rng(0)
    jt = random_graph(np.random.default_rng(4), n=N, extra_edges=10)
    return jt, rng.standard_normal((S_TR, N)).astype(np.float32), \
        rng.standard_normal((S_VAL, N)).astype(np.float32)


def _jax_ds(tpl, a):
    ds = object.__new__(JaxWDNDataset)
    ds.feature, ds.from_set, ds.norm_type, ds.edge_attrs = "pressure", "train", "znorm", None
    ds.stats = JaxNormStats(**STATS)
    ds.members = [JaxMember(tpl, a, [], None)]
    ds._lengths = [len(a)]
    ds.length = len(a)
    return ds


def _port_ds(tpl, *arrays):
    return WDNDataset.from_members([_Member(tpl, a, [], None) for a in arrays], NormStats(**STATS))


def _cfg_kw(**kw):
    return {**dict(epochs=4, batch_size=BS, mask_rate=0.5, criterion="mse", seed=0,
                   epochs_per_dispatch=2), **kw}


def jax_masks(seed, epoch, n=N):
    """The masks the JAX block draws for one epoch: ``fold_in(PRNGKey(seed),
    epoch)`` split into the train and validation keys, one key a step."""
    out = []
    ktr, kval = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), epoch))
    for key, S in ((ktr, S_TR), (kval, S_VAL)):
        steps, valid = JaxTrainer._block_layout(S, BS)
        keys = jax.random.split(key, steps)
        out.append(np.stack([np.asarray(jax_batch_node_mask(keys[s], BS, n, 0.5))
                             & np.repeat(valid[s] > 0.5, n) for s in range(steps)]))
    return tuple(out)


def _pair(jkw=None, **kw):
    """A JAX and a port trainer of one 2-block GATRes with the same initial
    weights; the JAX trainer's config without the port's save path."""
    jt, tr, va = _data()
    pt = GraphTemplate(jt.n_node, jt.senders, jt.receivers)
    jtr = JaxTrainer(JaxGATRes(num_blocks=2, channels=8, attn_impl="factored"),
                     JaxTrainConfig(donate_state=False, **_cfg_kw(**(jkw or kw))),
                     JaxNormStats(**STATS), jt)
    model = GATRes(2, 8, attn_impl="factored")
    ptr = Trainer(model, TrainConfig(**_cfg_kw(**kw)), NormStats(**STATS), pt, device="cpu")
    ptr.model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, jtr.params), model))
    return (jt, jtr, _jax_ds(jt, tr), _jax_ds(jt, va)), (pt, ptr, _port_ds(pt, tr),
                                                         _port_ds(pt, va))


def _fit(trainer, tr, va, **kw):
    hist = []
    best = trainer.fit(tr, va, log_fn=lambda *_: None,
                       on_epoch_end=lambda ep, m: hist.append((ep, m)), **kw)
    return best, hist


@pytest.mark.parametrize("S,bs", [(10, 4), (8, 4), (3, 4), (1, 1), (33, 8)])
def test_block_layout_matches_jax(S, bs):
    steps, valid = Trainer._block_layout(S, bs)
    jsteps, jvalid = JaxTrainer._block_layout(S, bs)
    assert steps == jsteps and np.array_equal(valid, jvalid)


def test_e2_matches_jax_fit_fast_with_replayed_masks():
    (jt, jtr, jtr_ds, jva_ds), (pt, ptr, tr_ds, va_ds) = _pair()
    jbest, jhist = _fit(jtr, jtr_ds, jva_ds)
    best, hist = _fit(ptr, tr_ds, va_ds, masks=lambda ep: jax_masks(0, ep))
    assert [e for e, _ in hist] == [e for e, _ in jhist] == [1, 2, 3, 4]
    for (_, m), (_, jm) in zip(hist, jhist):
        assert set(m) == set(jm)
        for key in jm:
            np.testing.assert_allclose(m[key], jm[key], rtol=1e-4, atol=1e-6, err_msg=key)
    assert best["epoch"] == jbest["epoch"]
    ref = params_from_flax(jax.tree.map(np.asarray, jtr.params), ptr.model)
    for name, p in ptr.model.named_parameters():
        r = ref[name].numpy()
        assert np.abs(p.detach().numpy() - r).max() <= 3e-3 * np.abs(r).max() + 1e-6, name
    assert ptr.fast_io == {"blocks": 2, "readbacks": 2, "uploads": 4 + 3 * 2}


def test_e2_equals_e4_and_the_host_reads_once_a_block():
    runs = {}
    for E in (2, 4):
        _, (pt, ptr, tr_ds, va_ds) = _pair(epochs_per_dispatch=E)
        best, hist = _fit(ptr, tr_ds, va_ds)
        runs[E] = (hist, [p.detach().clone() for p in ptr.model.parameters()], ptr.fast_io)
    assert runs[2][0] == runs[4][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[2][1], runs[4][1]))
    assert runs[2][2]["readbacks"] == 2 and runs[4][2]["readbacks"] == 1
    assert all(math.isfinite(h["val_loss"]) for _, h in runs[2][0])


def test_resume_across_a_block_boundary_is_bit_identical(tmp_path):
    _, (pt, whole, tr_ds, va_ds) = _pair()
    _, hist = _fit(whole, tr_ds, va_ds)
    _, (_, first, _, _) = _pair(epochs=2, save_path=str(tmp_path), model_name="m")
    first.cfg.epochs = 2
    _, h1 = _fit(first, tr_ds, va_ds)
    _, (_, resumed, _, _) = _pair(save_path=str(tmp_path), model_name="m")
    resumed.restore(str(tmp_path / "last_m.ckpt"), log_fn=lambda *_: None)
    _, h2 = _fit(resumed, tr_ds, va_ds)
    assert h1 + h2 == hist
    assert all(torch.equal(a, b) for a, b in zip(whole.model.parameters(),
                                                 resumed.model.parameters()))


def test_early_stop_mid_block_and_params_epoch_match_jax(tmp_path):
    """patience 1 and an unreachable min_delta stop at epoch 2, inside the
    first block of 3: both packages report epochs 1-2, keep the block-end
    parameters and write ``params_epoch`` 3 in 'best' and 'last'; the JAX
    'best', converted by ``tools/flax_ckpt_to_torch.py``, resumes in the
    port at the JAX package's epoch."""
    kw = dict(epochs=6, epochs_per_dispatch=3, patience=1, min_delta=1e3, model_name="m")
    (jt, jtr, jtr_ds, jva_ds), (pt, ptr, tr_ds, va_ds) = _pair(
        jkw={**kw, "save_path": str(tmp_path / "jax")}, save_path=str(tmp_path / "port"), **kw)
    _, jhist = _fit(jtr, jtr_ds, jva_ds)
    _, hist = _fit(ptr, tr_ds, va_ds, masks=lambda ep: jax_masks(0, ep))
    assert [e for e, _ in hist] == [e for e, _ in jhist] == [1, 2]
    for kind in ("best", "last"):
        _, _, jmeta = jax_load_checkpoint(str(tmp_path / "jax" / f"{kind}_m.ckpt"))
        _, _, meta = load_checkpoint(str(tmp_path / "port" / f"{kind}_m.ckpt"))
        assert meta["epoch"] == jmeta["epoch"], kind
        assert meta["extra"]["resume"]["params_epoch"] == \
            jmeta["extra"]["resume"]["params_epoch"] == 3, kind
    src, dst = str(tmp_path / "jax" / "best_m.ckpt"), str(tmp_path / "best_conv.ckpt")
    flax_ckpt_to_torch.convert(src, dst, GATRes(2, 8, attn_impl="factored"))
    jres = JaxTrainer(JaxGATRes(num_blocks=2, channels=8, attn_impl="factored"),
                      JaxTrainConfig(donate_state=False, **_cfg_kw(**kw)), JaxNormStats(**STATS), jt)
    jres.restore(src, log_fn=lambda *_: None)
    pres = Trainer(GATRes(2, 8, attn_impl="factored"), TrainConfig(**_cfg_kw(**kw)),
                   NormStats(**STATS), pt, device="cpu")
    pres.restore(dst, log_fn=lambda *_: None)
    assert jres._resume["epoch"] == pres._resume["epoch"] == 3
    _, _, best_meta = jax_load_checkpoint(src)
    assert best_meta["epoch"] == 1                 # the reporting epoch; the parameters are 3's


def test_scheduler_decides_per_block_as_in_jax():
    """ReduceLROnPlateau with patience 0 and an unreachable threshold cuts
    the rate after each epoch but the first; the cuts take effect at the
    next block in both packages: the same per-epoch losses and final rate."""
    kw = dict(scheduler="ReduceLROnPlateau", scheduler_patience=0, scheduler_factor=0.5)
    (jt, jtr, jtr_ds, jva_ds), (pt, ptr, tr_ds, va_ds) = _pair(**kw)
    _, jhist = _fit(jtr, jtr_ds, jva_ds)
    _, hist = _fit(ptr, tr_ds, va_ds, masks=lambda ep: jax_masks(0, ep))
    np.testing.assert_allclose([m["train_loss"] for _, m in hist],
                               [m["train_loss"] for _, m in jhist], rtol=1e-4)
    assert ptr.lr == pytest.approx(jax_get_lr(jtr.opt_state), rel=1e-6)
    assert ptr.lr < ptr.cfg.lr


@pytest.mark.parametrize("case", ["two_members", "two_templates", "sce", "log_gradient", "mesh"])
def test_falls_back_to_the_epoch_path_where_jax_does(case, monkeypatch):
    """More than one member, two template objects (as the command line's
    train and valid datasets hold, in both packages), a criterion other than
    mse and mae, the gradient probe, or the mesh trainer: the per-epoch path
    runs (no block), as in the JAX package's gate; ``masks=`` there raises."""
    jt, tr, va = _data()
    pt = GraphTemplate(jt.n_node, jt.senders, jt.receivers)
    kw = _cfg_kw(epochs=1)
    if case == "sce":
        kw["criterion"] = "sce"
    if case == "log_gradient":
        kw["log_gradient"] = True
    if case == "mesh":
        assert MeshTrainer.supports_fast_fit is False
        monkeypatch.setattr(Trainer, "supports_fast_fit", False)
    ptr = Trainer(GATRes(1, 4), TrainConfig(**kw), NormStats(**STATS), pt, device="cpu")
    trs = _port_ds(pt, tr, tr) if case == "two_members" else _port_ds(pt, tr)
    vas = _port_ds(GraphTemplate(jt.n_node, jt.senders, jt.receivers) if case == "two_templates"
                   else pt, va)
    _fit(ptr, trs, vas)
    assert ptr.fast_io["blocks"] == 0
    with pytest.raises(ValueError, match="masks="):
        _fit(ptr, trs, vas, masks=lambda ep: None)
