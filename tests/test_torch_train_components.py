"""PyTorch port: the parts of the training loop against the JAX package's own
(CPU): AutoClip, early stopping, the plateau scheduler, checkpoints, the
snapshot loader and the criteria."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_pressure_estimation_tpu.data.dataset import SnapshotLoader as JaxSnapshotLoader
from gnn_pressure_estimation_tpu.data.dataset import WDNDataset as JaxWDNDataset
from gnn_pressure_estimation_tpu.data.dataset import _Member as JaxMember
from gnn_pressure_estimation_tpu.train.autoclip import autoclip as jax_autoclip
from gnn_pressure_estimation_tpu.train.early_stopping import EarlyStopping as JaxEarlyStopping
from gnn_pressure_estimation_tpu.train.loop import ReduceLROnPlateau as JaxReduceLROnPlateau
from gnn_pressure_estimation_tpu.train.loop import make_criterion as jax_make_criterion
from gnn_pressure_estimation_tpu.utils.scaling import NormStats as JaxNormStats
from gnn_pressure_estimation_tpu_torch.core.graph import GraphTemplate
from gnn_pressure_estimation_tpu_torch.data.dataset import SnapshotLoader, WDNDataset, _Member
from gnn_pressure_estimation_tpu_torch.models.gatres import GATRes
from gnn_pressure_estimation_tpu_torch.train import (
    AutoClip, EarlyStopping, TrainConfig, Trainer, load_checkpoint, save_checkpoint,
)
from gnn_pressure_estimation_tpu_torch.train.loop import ReduceLROnPlateau, make_criterion
from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats
from helpers import random_graph

torch.set_num_threads(1)


@pytest.mark.parametrize("pct,history_len", [(10.0, 1024), (50.0, 1024), (10.0, 8)])
def test_autoclip_matches_jax_over_30_steps(rng, pct, history_len):
    """The same gradients through both: the clip value (percentile of the
    filled part of the ring buffer, this step included) and the scaled
    gradients agree; history_len 8 wraps the ring."""
    tx = jax_autoclip(pct, history_len)
    g0 = {"a": np.zeros((3, 4), np.float32), "b": np.zeros(5, np.float32)}
    state = tx.init(g0)
    clip = AutoClip(pct, history_len)
    params = [torch.nn.Parameter(torch.zeros(3, 4)), torch.nn.Parameter(torch.zeros(5))]
    for step in range(30):
        scale = float(rng.lognormal(0.0, 1.0))
        ga = (rng.standard_normal((3, 4)) * scale).astype(np.float32)
        gb = (rng.standard_normal(5) * scale).astype(np.float32)
        upd, state = tx.update({"a": jnp.asarray(ga), "b": jnp.asarray(gb)}, state)
        params[0].grad, params[1].grad = torch.from_numpy(ga.copy()), torch.from_numpy(gb.copy())
        norm = clip.clip_(params)
        np.testing.assert_allclose(float(norm), math.sqrt((ga ** 2).sum() + (gb ** 2).sum()),
                                   rtol=1e-6)
        filled = np.asarray(state.history)[: min(step + 1, history_len)]
        np.testing.assert_allclose(float(clip.last_clip_value), np.percentile(filled, pct),
                                   rtol=1e-6, err_msg=f"step {step}")
        np.testing.assert_allclose(params[0].grad.numpy(), np.asarray(upd["a"]), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(params[1].grad.numpy(), np.asarray(upd["b"]), rtol=1e-5, atol=1e-7)
    assert int(clip.count) == int(state.count) == 30
    np.testing.assert_allclose(clip.history.numpy(), np.asarray(state.history), rtol=1e-6)
    # the state round-trips
    other = AutoClip(pct, history_len)
    other.load_state_dict(clip.state_dict())
    assert torch.equal(other.history, clip.history) and int(other.count) == 30


LOSSES = {
    "improving": [1.0, 0.9, 0.8, 0.7, 0.6, 0.5],
    "plateau": [1.0, 0.9, 0.9, 0.9, 0.9, 0.9, 0.9, 0.9, 0.85, 0.9, 0.9, 0.9, 0.9],
    "nan": [1.0, 0.9, float("nan"), 0.8],
    "noisy": [1.0, 1.2, 0.99995, 1.1, 0.7, 0.70001, 0.9, 0.9, 0.9, 0.9],
}


@pytest.mark.parametrize("seq", sorted(LOSSES))
@pytest.mark.parametrize("kw", [dict(patience=3, min_delta=1e-4), dict(patience=0),
                                dict(patience=2, min_delta=5.0, percentage=True),
                                dict(patience=2, mode="max")])
def test_early_stopping_matches_jax(seq, kw):
    a, b = EarlyStopping(**kw), JaxEarlyStopping(**kw)
    for v in LOSSES[seq]:
        assert a.step(v) == b.step(v)
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys() and sa["num_bad_epochs"] == sb["num_bad_epochs"]
        assert sa["best"] == sb["best"] or (math.isnan(sa["best"]) and math.isnan(sb["best"]))
    c = EarlyStopping(**kw)
    c.load_state_dict(a.state_dict())
    assert c.state_dict() == a.state_dict() or seq == "nan"
    with pytest.raises(ValueError):
        EarlyStopping(mode="sideways")


@pytest.mark.parametrize("seq", sorted(LOSSES))
@pytest.mark.parametrize("patience,factor", [(2, 0.1), (0, 0.5)])
def test_reduce_lr_on_plateau_matches_jax(seq, patience, factor):
    a, b = ReduceLROnPlateau(patience, factor), JaxReduceLROnPlateau(patience, factor)
    lr_a = lr_b = 5e-4
    for v in LOSSES[seq]:
        lr_a, lr_b = a.step(v, lr_a), b.step(v, lr_b)
        assert lr_a == lr_b
        sa, sb = a.state_dict(), b.state_dict()
        assert sa["num_bad"] == sb["num_bad"]
        assert sa["best"] == sb["best"] or (math.isnan(sa["best"]) and math.isnan(sb["best"]))
    c = ReduceLROnPlateau(patience, factor)
    c.load_state_dict(a.state_dict())
    assert c.num_bad == a.num_bad
    if seq == "plateau" and patience == 2:
        assert lr_a < 5e-4            # it did anneal


@pytest.mark.parametrize("name", ["mse", "mae", "sce"])
def test_criteria_match_jax(rng, name):
    p = rng.standard_normal((40, 3)).astype(np.float32)
    t = rng.standard_normal((40, 3)).astype(np.float32)
    got = make_criterion(name)(torch.from_numpy(p), torch.from_numpy(t))
    ref = jax_make_criterion(name)(jnp.asarray(p), jnp.asarray(t))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    with pytest.raises(KeyError):
        make_criterion("huber")


def _trainer(rng, **kw):
    jt = random_graph(rng, n=14, extra_edges=7)
    tpl = GraphTemplate(jt.n_node, jt.senders, jt.receivers)
    cfg = TrainConfig(batch_size=3, mask_rate=0.5, use_gradient_clipping=True, **kw)
    return Trainer(GATRes(1, 4), cfg, NormStats(mean=3.0, std=2.0), tpl, device="cpu"), tpl


def test_checkpoint_round_trip(rng, tmp_path):
    tr, tpl = _trainer(rng)
    xb = rng.standard_normal((3, 14)).astype(np.float32)
    for seed in (0, 1):
        tr.train_step(tpl, xb, generator=torch.Generator().manual_seed(seed))
    tr.lr = 1e-4
    extra = {"resume": {"early": {"best": 0.5, "num_bad_epochs": 2}, "sched": None,
                        "best": {"loss": 0.5, "epoch": 4, "metrics": {"val_mae": 1.5}}},
             "layout": {"agg_mode": None, "band_block": None}}
    path = save_checkpoint(str(tmp_path / "sub" / "m.ckpt"), tr.model.state_dict(),
                           tr.opt_state_dict(), epoch=4, loss=0.5,
                           metrics={"val_mae": torch.tensor(1.5)}, stats=tr.stats, extra=extra)
    # tensors and one JSON string only: loads without unpickling code
    raw = torch.load(path, weights_only=True)
    assert set(raw) == {"params", "opt_state", "meta_json"} and isinstance(raw["meta_json"], str)

    params, opt_state, meta = load_checkpoint(path, tr.model.state_dict(), tr.opt_state_dict())
    assert meta["epoch"] == 4 and meta["loss"] == 0.5 and meta["metrics"] == {"val_mae": 1.5}
    assert meta["stats"] == NormStats(mean=3.0, std=2.0) and meta["extra"] == extra
    for k, v in tr.model.state_dict().items():
        assert torch.equal(params[k], v), k
    want = tr.opt_state_dict()
    assert opt_state.keys() == want.keys() and float(opt_state["lr"]) == 1e-4
    assert {"autoclip.history", "autoclip.count", "adam.step.lin0.weight",
            "adam.exp_avg.blocks.0.conv1.att_src", "adam.exp_avg_sq.lin1.bias"} <= opt_state.keys()
    for k in want:
        assert torch.equal(opt_state[k], want[k]), k
    assert float(opt_state["adam.step.lin0.weight"]) == 2.0

    # a second trainer restored from it takes the same next step
    tr2, _ = _trainer(np.random.default_rng(0))
    meta2 = tr2.restore(path, log_fn=lambda *_: None)
    assert meta2["epoch"] == 4 and tr2._resume["epoch"] == 4 and tr2.lr == 1e-4
    for t in (tr, tr2):
        t.train_step(tpl, xb, generator=torch.Generator().manual_seed(5))
    for (k, a), b in zip(tr.model.state_dict().items(), tr2.model.state_dict().values()):
        assert torch.equal(a, b), k

    # weights only: no optimizer state; a template that does not fit raises
    p2 = save_checkpoint(str(tmp_path / "w.ckpt"), tr.model.state_dict())
    _, none_state, meta3 = load_checkpoint(p2)
    assert none_state is None and meta3["stats"] is None and meta3["epoch"] == 0
    with pytest.raises(ValueError, match="does not fit"):
        load_checkpoint(p2, GATRes(2, 4).state_dict())
    with pytest.raises(TypeError, match="not a tensor"):
        save_checkpoint(str(tmp_path / "bad.ckpt"), {"w": 1.0})


def test_norm_stats_dict_matches_jax():
    arr = np.random.default_rng(1).standard_normal((5, 7)) * 3 + 2
    a, b = NormStats.from_array(arr, "minmax"), JaxNormStats.from_array(arr, "minmax")
    for f in ("norm_type", "mean", "std", "min", "max"):
        assert getattr(a, f) == getattr(b, f)
    assert NormStats.from_dict(b.to_dict()) == a            # the JAX dict (null edge stats) loads
    assert NormStats.from_dict(a.to_dict()) == a
    # edge statistics cross both ways (the JAX dict's lists load as arrays)
    e = JaxNormStats.from_array(arr, "minmax").with_edge_stats(arr.T)
    back = NormStats.from_dict(e.to_dict())
    np.testing.assert_array_equal(back.edge_mean, e.edge_mean)
    np.testing.assert_array_equal(back.edge_max, a.with_edge_stats(arr.T).edge_max)
    assert back.to_dict() == e.to_dict()


@pytest.mark.parametrize("shuffle,drop_last", [(True, False), (False, False), (True, True)])
def test_snapshot_loader_order_matches_jax(rng, shuffle, drop_last):
    jta, jtb = random_graph(rng, n=12, extra_edges=6), random_graph(rng, n=18, extra_edges=9)
    arrs = [rng.standard_normal((10, 12)).astype(np.float32),
            rng.standard_normal((7, 18)).astype(np.float32)]
    jds = object.__new__(JaxWDNDataset)
    jds.members = [JaxMember(jta, arrs[0], [], None), JaxMember(jtb, arrs[1], [], None)]
    tpls = [GraphTemplate(t.n_node, t.senders, t.receivers) for t in (jta, jtb)]
    ds = WDNDataset.from_members([_Member(t, a, [], None) for t, a in zip(tpls, arrs)])
    assert len(ds) == 17 and len(ds + ds) == 34 and (ds + ds).stats == ds.stats
    assert (ds + ds).from_set == "train+train"
    jl = JaxSnapshotLoader(jds, 4, shuffle=shuffle, seed=3, drop_last=drop_last)
    pl = SnapshotLoader(ds, 4, shuffle=shuffle, seed=3, drop_last=drop_last)
    assert pl.num_batches() == jl.num_batches()
    for epoch in (None, 1, 2, 1):
        if epoch is not None:
            jl.set_epoch(epoch)
            pl.set_epoch(epoch)
        jb, pb = list(jl), list(pl)
        assert len(jb) == len(pb) == pl.num_batches()
        for (jt_, jx, ji), (pt_, px, pi) in zip(jb, pb):
            assert pt_ is tpls[0 if jt_ is jta else 1]
            np.testing.assert_array_equal(pi, ji)
            np.testing.assert_array_equal(px, jx)
