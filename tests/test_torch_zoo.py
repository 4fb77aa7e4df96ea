"""PyTorch port: the model zoo against the JAX package.

- The six baselines at a small depth and width (GIN 3 blocks nc 8; GCN2 4
  layers nc 8; ChebNet ks (3, 2, 2, 1) nc 8; GraphConvWat channels (8, 6,
  4), ks (12, 6, 3, 1); m_GCN latent 8, 3 aggregations, 2 hops, edge
  attributes; GAT 3 blocks nc 8) in the dense, banded (BLK 16) and padded
  modes: the forward, and one train step through each package's ``Trainer``
  with one explicit mask (loss, every gradient, the parameters after one
  Adam step). Weights are the JAX ``Trainer``'s ``init``, carried across by
  ``weights.params_from_flax``.
- The registry against the JAX registry; the converter round trip
  (``params_to_flax``, ``tools/flax_ckpt_to_torch.py`` with the Adam state)
  for each model; ``apply_model_knobs`` refusing what the JAX function
  refuses.
- The bigtown fixtures ``artifacts/parity_zoo_<model>.npz``
  (``tools/parity_zoo_export.py``: preset width and depth, m_GCN at 4 of its
  45 aggregations) on the CPU through the plain versions: each layer's
  output on the fixture's rows and the model's output within 1e-3 relative
  to max|ref|, and the loss and gradients of the fixture's step.
- ``cli train | eval | infer --model <zoo name> --device cpu`` on a small
  generated network.
"""

import configparser
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gnn_pressure_estimation_tpu.models import presets as jpresets
from gnn_pressure_estimation_tpu.models import zoo as jzoo
from gnn_pressure_estimation_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from gnn_pressure_estimation_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from gnn_pressure_estimation_tpu.train.loop import TrainConfig as JaxTrainConfig
from gnn_pressure_estimation_tpu.train.loop import Trainer as JaxTrainer
from gnn_pressure_estimation_tpu.train.loop import make_optimizer
from gnn_pressure_estimation_tpu.utils.scaling import NormStats as JaxNormStats
from gnn_pressure_estimation_tpu_torch import cli as pcli
from gnn_pressure_estimation_tpu_torch.core.graph import GraphTemplate
from gnn_pressure_estimation_tpu_torch.models import presets, zoo
from gnn_pressure_estimation_tpu_torch.train import TrainConfig, Trainer
from gnn_pressure_estimation_tpu_torch.utils.masking import masked_count
from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats
from gnn_pressure_estimation_tpu_torch.weights import params_from_flax, params_to_flax
from helpers import random_graph

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import flax_ckpt_to_torch  # noqa: E402

torch.set_num_threads(1)
MODES = ("dense", "banded", "padded")

# name → (JAX model, port model, criterion)
SMALL = {
    "gin": (lambda: jzoo.GIN(num_blocks=3, channels=8),
            lambda: zoo.GIN(num_blocks=3, channels=8), "mse"),
    "gcn2": (lambda: jzoo.GCN2(num_blocks=4, channels=8),
             lambda: zoo.GCN2(num_blocks=4, channels=8), "mse"),
    "chebnet": (lambda: jzoo.ChebNet(channels=8, ks=(3, 2, 2, 1)),
                lambda: zoo.ChebNet(channels=8, ks=(3, 2, 2, 1)), "mse"),
    "graphconvwat": (lambda: jzoo.GraphConvWat(channels=(8, 6, 4), ks=(12, 6, 3, 1)),
                     lambda: zoo.GraphConvWat(channels=(8, 6, 4), ks=(12, 6, 3, 1)), "mse"),
    "mgcn": (lambda: jzoo.MGCN(latent_dim=8, n_aggr=3, n_hops=2),
             lambda: zoo.MGCN(latent_dim=8, n_aggr=3, n_hops=2), "mae"),
    "gat": (lambda: jzoo.GAT(num_blocks=3, channels=8),
            lambda: zoo.GAT(num_blocks=3, channels=8), "mse"),
}


def within(name, got, ref, rel=1e-4, floor=1e-6):
    """max|got − ref| ≤ rel·max|ref| + floor."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, name
    err, top = float(np.abs(got - ref).max()), float(np.abs(ref).max())
    assert err <= rel * top + floor, f"{name}: off by {err:.3e} (max |ref| {top:.3e})"


@pytest.fixture(scope="module")
def templates():
    rng = np.random.default_rng(11)
    jt = random_graph(rng, n=70, extra_edges=40, edge_dim=2)
    return jt, GraphTemplate(jt.n_node, jt.senders, jt.receivers, edge_attr=jt.edge_attr)


def _trainers(name, mode, templates, bs=2):
    jt, pt = templates
    jmodel, pmodel, criterion = SMALL[name]
    kw = dict(batch_size=bs, mask_rate=0.5, criterion=criterion, agg_mode=mode,
              band_block=16 if mode == "banded" else None, donate_state=False, seed=0)
    stats = dict(norm_type="znorm", mean=1.0, std=3.0)
    jtr = JaxTrainer(jmodel(), JaxTrainConfig(**kw), JaxNormStats(**stats), jt)
    ptr = Trainer(pmodel(), TrainConfig(**kw), NormStats(**stats), pt, device="cpu")
    ptr.model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, jtr.params), ptr.model))
    return jtr, ptr


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(SMALL))
def test_model_forward_and_step_match_jax(templates, name, mode):
    """Forward within 1e-4·max|ref| + 1e-6; one train step: loss rtol 1e-5,
    each gradient within 1e-4·max|g_ref| + 1e-6, the per-block gradient
    norms that ``log_gradient`` logs (rtol 1e-4) under the JAX names, and
    after one Adam step
    every parameter whose gradient is above that tolerance within 1e-6 of
    the JAX parameter (Adam's first step moves each by lr·sign(g), so a
    component whose gradient is rounding noise may step either way)."""
    jt, pt = templates
    jtr, ptr = _trainers(name, mode, templates)
    bs, n = 2, jt.n_node
    rng = np.random.default_rng(3)
    xb = rng.standard_normal((bs, n)).astype(np.float32)
    k = masked_count(n, 0.5)
    mask = np.zeros((bs, n), bool)
    for b in range(bs):
        mask[b, rng.permutation(n)[:k]] = True
    mask = mask.reshape(-1)

    jg = jtr._batched_graph(jt, bs)
    jx, jmask = jnp.asarray(xb.reshape(-1, 1)), jnp.asarray(mask)
    if jg.banded:
        jx = jg.pack_nodes(jx, n)
        jmask = jg.pack_nodes(jmask.astype(jnp.float32)[:, None], n)[:, 0] > 0.5
    jout = jtr.model.apply(jtr.params, jnp.where(jmask[:, None], 0.0, jx), jg)

    @jax.jit
    def value_and_grad(p):
        def loss_fn(p_):
            loss, mets, _ = jtr._masked_loss_and_metrics(p_, jg, jx, jx, jmask, bs * k, "train")
            return loss, mets
        return jax.value_and_grad(loss_fn, has_aux=True)(p)

    (jloss, _), jgrads = value_and_grad(jtr.params)
    graph, x, pmask, pn = ptr._prepare(pt, xb, mask, None, None)
    with torch.no_grad():
        out = ptr.model(torch.where(pmask[:, None], 0.0, x), graph)
    within("forward", out.numpy(), jout)
    ptr.model.train()
    loss, _, _ = ptr._masked_loss_and_metrics(graph, x, x, pmask, pn, "train")
    params = list(ptr.model.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in params])
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    ref = params_from_flax(jax.tree.map(np.asarray, jgrads), ptr.model)
    assert sorted(ref) == sorted(k_ for k_, _ in params)
    for (pname, _), g in zip(params, grads):
        within(f"d {pname}", g.numpy(), ref[pname])

    updates, _ = jtr.tx.update(jgrads, jtr.opt_state, jtr.params)
    p1 = params_from_flax(jax.tree.map(np.asarray, optax.apply_updates(jtr.params, updates)),
                          ptr.model)
    ptr.train_step(pt, xb, mask)
    # the per-block gradient norms of log_gradient, by the JAX package's names
    jnorms = {f"grad_norm_{k}": float(optax.global_norm(v)) for k, v in jgrads["params"].items()
              if any(tag in k.lower() for tag in ("block", "mlp", "res", "gcn"))}
    pnorms = {k: float(v) for k, v in ptr._block_grad_norms().items()}
    assert pnorms.keys() == jnorms.keys()
    for k in jnorms:
        np.testing.assert_allclose(pnorms[k], jnorms[k], rtol=1e-4, atol=1e-6, err_msg=k)
    for pname, p in ptr.model.named_parameters():
        g = ref[pname].abs()
        real = g > 1e-4 * g.max() + 1e-6
        np.testing.assert_allclose(p.detach()[real].numpy(), p1[pname][real].numpy(), atol=1e-6,
                                   rtol=0, err_msg=pname)


def test_registry_matches_jax():
    """The eight names, each with the JAX preset's criterion,
    normalisation and edge attributes; every one builds."""
    assert sorted(presets.MODEL_REGISTRY) == sorted(jpresets.MODEL_REGISTRY)
    assert not hasattr(presets, "NOT_YET_PORTED")
    for name, jp in jpresets.MODEL_REGISTRY.items():
        p = presets.MODEL_REGISTRY[name]
        assert (p.name, p.criterion, p.norm_type, p.edge_attrs) == \
            (jp.name, jp.criterion, jp.norm_type, jp.edge_attrs), name
    model, _ = presets.select_model("mgcn", device="cpu", edge_dim=1)
    assert model.edge.in_features == 1 and len(model.gcn) == 45
    with pytest.raises(ValueError, match="reads no edge attributes"):
        presets.select_model("gin", device="cpu", edge_dim=1)


@pytest.mark.parametrize("mode", MODES)
def test_edge_tables_built_on_first_use(templates, mode):
    """A batch builds its edge list and attributes when a layer first reads
    them: a GATRes forward leaves them unbuilt, an m_GCN forward builds
    them once, in the batch's node space, the attributes in its order, and
    none of the self-loop list's tables or the edge weights it never reads."""
    from gnn_pressure_estimation_tpu_torch.models.gatres import GATRes

    jt, _ = templates
    # a template of its own: the module's template caches batches other tests ran
    pt = GraphTemplate(jt.n_node, jt.senders, jt.receivers, edge_attr=jt.edge_attr)
    blk = 16 if mode == "banded" else None
    g = pt.batch(2, mode=mode, band_block=blk, device="cpu")
    x = torch.zeros(g.n_node, 1)
    GATRes(1, 4)(x, g)
    assert not g._edge_cache
    zoo.MGCN(latent_dim=4, n_aggr=1)(x, g)
    edges, ea = g.edges, g.edge_attr
    assert g.edges is edges and ea.shape == (2 * pt.n_edge, 2)
    assert set(g._edge_cache) == {"edges", "edge_attr"}
    assert bool((edges.receivers[1:] >= edges.receivers[:-1]).all())
    assert int(edges.receivers.max()) < g.n_node
    el = pt.edge_list(blk, mode == "banded")
    np.testing.assert_array_equal(ea[:pt.n_edge].numpy(), pt.edge_attr[el["order"]])


def test_flax_names_refuse_another_model(templates):
    """A parameter tree converts only onto a model of its structure."""
    jt, _ = templates
    params = jzoo.GIN(num_blocks=3, channels=8).init(
        jax.random.PRNGKey(0), jnp.zeros((jt.n_node, 1)), jt.batch(1))
    with pytest.raises(ValueError, match="has no parameter for the flax leaves"):
        params_from_flax(jax.tree.map(np.asarray, params), zoo.GAT(num_blocks=3, channels=8))


@pytest.mark.parametrize("name", ["gat", "mgcn", "gin"])
@pytest.mark.parametrize("knob", ["attn_impl", "attn_dtype", "gate_dtype"])
def test_knobs_raise_as_in_jax(name, knob):
    """``apply_model_knobs`` raises on a zoo model wherever the JAX function
    raises (no model of the zoo has an attention knob at its top level)."""
    value = "softmax" if knob == "attn_impl" else "bfloat16"
    with pytest.raises(ValueError, match=f"has no '{knob}' knob"):
        jpresets.apply_model_knobs(jpresets.MODEL_REGISTRY[name].make(), **{knob: value})
    model, _ = presets.select_model(name, device="cpu")
    with pytest.raises(ValueError, match=f"has no '{knob}' knob"):
        presets.apply_model_knobs(model, **{knob: value})


@pytest.mark.parametrize("name", list(SMALL) + ["remask", "remask_stack"])
def test_converter_round_trip(tmp_path, templates, name):
    """A JAX checkpoint of the model (its ``init`` and the Adam state after
    one step) through ``tools/flax_ckpt_to_torch.py``: the port's Trainer
    restores parameters and moments equal to the JAX ones, and
    ``params_to_flax`` gives the flax tree back."""
    from gnn_pressure_estimation_tpu.models import remask as jremask
    from gnn_pressure_estimation_tpu_torch.models import remask

    jt, pt = templates
    if name.startswith("remask"):
        jcls, pcls = ((jremask.GATResRemask, remask.GATResRemask) if name == "remask"
                      else (jremask.GATResRemaskStack, remask.GATResRemaskStack))
        jg = jt.batch(1)
        x0 = jnp.zeros((jg.n_node, 1))
        params = jcls(num_blocks=2, channels=8).init(jax.random.PRNGKey(0), x0, jg,
                                                     jnp.zeros(jg.n_node, bool))
        params = {"params": params["params"]}
        pmodel = pcls(num_blocks=2, channels=8)
    else:
        jmodel, pmodel_fn, _ = SMALL[name]
        params = jmodel().init(jax.random.PRNGKey(0), jnp.zeros((jt.n_node, 1)), jt.batch(1))
        pmodel = pmodel_fn()
    params = jax.tree.map(np.asarray, params)
    sd = params_from_flax(params, pmodel)
    assert sorted(sd) == sorted(pmodel.state_dict())
    back = params_to_flax(sd, pmodel)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)

    tx = make_optimizer(JaxTrainConfig())
    opt = tx.init(params)
    _, opt = tx.update(jax.tree.map(lambda a: np.full_like(a, 0.5), params), opt, params)
    src, dst = str(tmp_path / "j.ckpt"), str(tmp_path / "p.ckpt")
    jax_save_checkpoint(src, params, opt, epoch=1, loss=0.5, stats=JaxNormStats())
    flax_ckpt_to_torch.convert(src, dst, pmodel)
    ptr = Trainer(pmodel, TrainConfig(), NormStats(), pt, device="cpu")
    ptr.restore(dst, log_fn=lambda s: None)
    for k, v in ptr.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k].numpy(), err_msg=k)
    st = ptr.opt_state_dict()
    adam = flax_ckpt_to_torch._find(jax_load_checkpoint(src)[1], {"count", "mu", "nu"}, [])[0]
    mu = params_from_flax(adam["mu"], pmodel)
    for k in sd:
        np.testing.assert_array_equal(st[f"adam.exp_avg.{k}"].numpy(), mu[k].numpy(), err_msg=k)
        assert int(st[f"adam.step.{k}"]) == 1


# ---- the bigtown fixtures on the plain path ----------------------------------------------

FIXTURES = ("gin", "gat", "gcn2", "chebnet", "mgcn", "graphconvwat")


@pytest.fixture(scope="module")
def bigtown():
    """The test split of ``artifacts/eval_bigtown.zip`` read by the port,
    per normalisation and edge attributes, as the fixtures scaled it."""
    from gnn_pressure_estimation_tpu_torch.data import WDNDataset

    zp, inp = str(ROOT / "artifacts" / "eval_bigtown.zip"), str(ROOT / "inputs" / "bigtown.inp")
    cache = {}

    def get(norm_type, edge_attrs):
        key = (norm_type, edge_attrs)
        if key not in cache:
            tr = WDNDataset([zp], [inp], from_set="train", norm_type=norm_type,
                            edge_attrs=edge_attrs)
            cache[key] = WDNDataset([zp], [inp], from_set="test", stats=tr.stats,
                                    norm_type=norm_type, edge_attrs=edge_attrs)
        return cache[key]
    return get


def fixture_model(fx, device="cpu"):
    """The preset's model, cut as the fixture was, with the fixture's weights."""
    import json

    from gnn_pressure_estimation_tpu_torch.weights import params_from_fixture

    name = fx["model"].item().decode()
    preset = presets.MODEL_REGISTRY[name]
    # the preset's model class and widths with the fixture's cut (m_GCN's n_aggr)
    model = preset.build(**json.loads(fx["hparams"].item())).to(device)
    model.load_state_dict(params_from_fixture(fx, model, "param"))
    return model, preset


@pytest.mark.parametrize("name", FIXTURES)
def test_bigtown_fixture(bigtown, name):
    """The preset at full width and depth on bigtown (banded, BLK 256,
    B 1) on the CPU: the input, edge attributes and statistics the port's
    dataset gives equal the fixture's; the serving forward of the masked
    input, each layer on the fixture's rows and the output, within 1e-3
    relative to max|ref|; the masked loss rtol 1e-4 and every gradient
    within 1e-3·max|g_ref| + 1e-6 (the card's gates)."""
    from gnn_pressure_estimation_tpu_torch.weights import params_from_fixture

    fx = np.load(ROOT / "artifacts" / f"parity_zoo_{name}.npz")
    model, preset = fixture_model(fx)
    ds = bigtown(preset.norm_type, preset.edge_attrs)
    tpl = ds.members[0].template
    np.testing.assert_array_equal(ds.members[0].array[0], fx["x"])
    if preset.edge_attrs:
        np.testing.assert_allclose(tpl.edge_attr, fx["edge_attr"], rtol=1e-6, atol=0)
    n = tpl.n_node
    graph = tpl.batch(1, device="cpu")
    assert graph.banded and graph.band_attn == "dma"
    x = torch.from_numpy(fx["x"][:, None].copy())
    mask = torch.from_numpy(fx["mask"])
    xp = graph.pack_nodes(torch.where(mask[:, None], 0.0, x), n)
    acts = {}
    hooks = [model.get_submodule(str(m)).register_forward_hook(
        lambda mod, a, o, m=str(m): acts.__setitem__(m, o)) for m in fx["act_layers"]]
    model.eval()
    with torch.no_grad():
        out = graph.unpack_nodes(model(xp, graph), n)
    for h in hooks:
        h.remove()
    rows = fx["act_rows"]
    for m in fx["act_layers"]:
        within(f"layer {m}", graph.unpack_nodes(acts[str(m)], n)[rows].numpy(), fx[f"act/{m}"],
               rel=1e-3)
    within("output", out.numpy(), fx["out"], rel=1e-3)
    tr = Trainer(model, TrainConfig(batch_size=1, criterion=preset.criterion,
                                    norm_type=preset.norm_type), ds.stats, tpl, device="cpu")
    g, xg, mg, k = tr._prepare(tpl, fx["x"][None], fx["mask"], None, None)
    assert k == int(fx["n_masked"])
    model.train()
    loss, _, _ = tr._masked_loss_and_metrics(g, xg, xg, mg, k, "train")
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(fx["loss"]), rtol=1e-4)
    ref = params_from_fixture(fx, model, "grad")
    for pname, p in model.named_parameters():
        within(f"d {pname}", p.grad.numpy(), ref[pname].numpy(), rel=1e-3)


# ---- the command line ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_network(tmp_path_factory):
    d = tmp_path_factory.mktemp("zoo_cli")
    inp, ini = str(d / "net.inp"), str(d / "net.ini")
    assert pcli.main(["netgen", "--junctions", "24", "--reservoirs", "1", "--tanks", "1",
                      "--out", inp, "--seed", "5"]) == 0
    assert pcli.main(["mkconfig", "--wn_inp_path", inp, "--out", ini,
                      "--num_scenarios", "12"]) == 0
    cp = configparser.ConfigParser()
    cp.read(ini)
    cp.set("general", "storage_dir", str(d / "data"))
    with open(ini, "w") as fh:
        cp.write(fh)
    assert pcli.main(["generate", "--config", ini, "--executors", "1", "--batch_size", "4",
                      "--gen_demand", "--gen_res_total_head"]) == 0
    return d, inp, str(d / "data.zip")


@pytest.mark.parametrize("name", ["gin", "gat", "gcn2", "chebnet", "graphconvwat", "mgcn"])
def test_cli_trains_evaluates_and_serves_zoo(small_network, capsys, monkeypatch, name):
    """``train`` (one epoch), ``eval`` (clean) and ``infer`` with ``--model``
    of each zoo preset on the CPU; m_GCN takes the preset's edge
    attributes, mae and minmax, and ``--use_data_edge_attrs length`` one
    attribute."""
    monkeypatch.setitem(sys.modules, "wandb", None)
    d, inp, zipf = small_network
    save = str(d / name)
    train = ["train", "--model", name, "--dataset_paths", zipf, "--input_paths", inp,
             "--batch_size", "4", "--mask_rate", "0.5", "--save_path", save, "--variant", "z",
             "--epochs", "1", "--device", "cpu"]
    assert pcli.main(train) == 0
    out = capsys.readouterr().out
    assert f"Model: {name}" in out and "best epoch 1" in out
    best = os.path.join(save, f"best_{name}_z.ckpt")
    assert pcli.main(["eval", "--model", name, "--model_path", best, "--test_data_path", zipf,
                      "--test_input_path", inp, "--num_test_trials", "1", "--batch_size", "2",
                      "--device", "cpu", "--gpu_warmup_times", "0"]) == 0
    assert pcli.main(["infer", "--model", name, "--model_path", best, "--test_data_path", zipf,
                      "--test_input_path", inp, "--from_set", "test", "--observed", "random",
                      "--mask_rate", "0.5", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "average result of 1 runs" in out and "inferred" in out
    from gnn_pressure_estimation_tpu_torch.train import load_checkpoint

    meta = load_checkpoint(best)[2]
    expect = presets.MODEL_REGISTRY[name].norm_type
    assert meta["stats"].norm_type == expect
    if name == "mgcn":
        assert meta["stats"].edge_mean is not None and len(meta["stats"].edge_mean) == 2
        assert pcli.main(train + ["--use_data_edge_attrs", "length", "--variant", "l"]) == 0
        sd = load_checkpoint(os.path.join(save, f"best_{name}_l.ckpt"))[0]
        assert tuple(sd["edge.weight"].shape) == (96, 1)
