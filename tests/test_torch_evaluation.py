"""PyTorch port: the multi-trial evaluation harness (``Evaluator``: clean,
noisy11, noisyNN), ``Timer`` and ``InferenceResult``'s files against the JAX
package on the CPU.

The setup is ``tests/test_evaluation.py``'s: minitown, 24 snapshots drawn
with numpy in one zip, a small GATRes whose JAX weights cross through
``weights.params_from_flax``. The two packages draw their masks from
different PRNGs, so every mask the JAX harness draws is recorded (with the
arguments of the call) and handed, in order, to the port's harness, which
must ask for the same masks in the same order.

The model's output layer is scaled so that its predictions spread over the
field as a trained model's do (std ~1 in scaled units). The scene path takes
corr and r2 from moments (``sum_pt / n - mean_p * mean_t`` in f32, means ~50
m), whose rounding error grows as mean² / var of the predictions: for the
near-constant field of a random model both packages' values are off by up to
~1e-2 from the float64 value (the JAX package's reaches its -1 clamp where the
port gives -0.48), so no two f32 implementations agree there. With the spread
of a trained model the two packages agree within 4e-5 on those two, and they
are held at the atol 1e-3 that ROADMAP Queue 3 keeps for them. NSE there is
``1 - sse / (sum_tt - sum_t**2 / n)``, whose denominator cancels by mean² /
var of the truth (~40 here): it is held at rtol 1e-4. Everything else, and
every value of the gathered (clean and sequential) paths, at rtol 1e-5 /
atol 1e-6."""

import jax
import numpy as np
import pytest
import torch

from gnn_pressure_estimation_tpu.data import WDNDataset as JaxWDNDataset
from gnn_pressure_estimation_tpu.data import ZarrZipWriter as JaxZarrZipWriter
from gnn_pressure_estimation_tpu.evaluation import harness as jharness
from gnn_pressure_estimation_tpu.evaluation.infer import InferenceResult as JaxInferenceResult
from gnn_pressure_estimation_tpu.evaluation.timer import Timer as JaxTimer
from gnn_pressure_estimation_tpu.models.gatres import GATRes as JaxGATRes
from gnn_pressure_estimation_tpu_torch.data import WDNDataset
from gnn_pressure_estimation_tpu_torch.evaluation import EvalConfig, Evaluator, Timer
from gnn_pressure_estimation_tpu_torch.evaluation import harness
from gnn_pressure_estimation_tpu_torch.evaluation.infer import InferenceResult
from gnn_pressure_estimation_tpu_torch.models.gatres import GATRes
from gnn_pressure_estimation_tpu_torch.utils.masking import masked_count
from gnn_pressure_estimation_tpu_torch.weights import params_from_flax

torch.set_num_threads(1)
INP = "inputs/minitown.inp"
TIMING = ("test_time", "test_throughput")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    import jax.numpy as jnp
    from gnn_pressure_estimation_tpu.data.inp import parse_inp

    wn = parse_inp(INP)
    rng = np.random.default_rng(0)
    snaps = 50 + rng.normal(0, 8, size=(24, wn.n_nodes))
    zip_path = str(tmp_path_factory.mktemp("eval") / "mini.zip")
    with JaxZarrZipWriter(zip_path) as w:
        w.create_group("pressure")
        w.write_array("pressure/train", snaps[:12])
        w.write_array("pressure/valid", snaps[12:18])
        w.write_array("pressure/test", snaps[18:])
        w.set_attrs("", {})
    jtrain = JaxWDNDataset([zip_path], [INP], from_set="train")
    jtest = JaxWDNDataset([zip_path], [INP], from_set="test", stats=jtrain.stats)
    train = WDNDataset([zip_path], [INP], from_set="train")
    test = WDNDataset([zip_path], [INP], from_set="test", stats=train.stats)
    jmodel = JaxGATRes(num_blocks=2, channels=8)
    g = jtest.members[0].template.batch(1)
    params = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(0), jnp.zeros((g.n_node, 1)), g))
    params["params"]["lin1"]["kernel"] = params["params"]["lin1"]["kernel"] * 100.0
    model = GATRes(2, 8)
    model.load_state_dict(params_from_flax(params, model))
    names = jtest.members[0].template.node_names
    return dict(jtest=jtest, test=test, jstats=jtrain.stats, stats=train.stats, jmodel=jmodel,
                params=params, model=model, sensors=[names[3], names[0], names[11]])


def replayed(monkeypatch):
    """Record the JAX harness's mask draws; the port's harness then gets the
    same masks in the same order, and must make each call with the same
    arguments."""
    calls = []
    draw = jharness.batch_node_mask

    def jax_draw(key, n_graph, n, mask_rate, required_idx=(), shared=False):
        m = draw(key, n_graph, n, mask_rate, required_idx=required_idx, shared=shared)
        calls.append(((n_graph, n, mask_rate, tuple(required_idx), shared), np.asarray(m)))
        return m

    def port_draw(generator, n_graph, n, mask_rate, required_idx=None, shared=False,
                  device="cpu"):
        args, m = calls.pop(0)
        assert (n_graph, n, mask_rate, tuple(required_idx or ()), shared) == args
        assert isinstance(generator, torch.Generator)
        return torch.tensor(m, dtype=torch.bool, device=device)

    monkeypatch.setattr(jharness, "batch_node_mask", jax_draw)
    monkeypatch.setattr(harness, "batch_node_mask", port_draw)
    return calls


def assert_results_match(got, ref, moments=False):
    for g, r in zip(got, ref):
        keys = {k for k in r if not k.startswith(TIMING)}
        assert keys == {k for k in g if not k.startswith(TIMING)}
        for k in sorted(keys):
            if moments and k.startswith(("test_corr", "test_r2")):
                np.testing.assert_allclose(g[k], r[k], rtol=0, atol=1e-3, err_msg=k)
            elif moments and k.startswith("test_mynse"):
                np.testing.assert_allclose(g[k], r[k], rtol=1e-4, atol=1e-6, err_msg=k)
            else:
                np.testing.assert_allclose(g[k], r[k], rtol=1e-5, atol=1e-6, err_msg=k)
        for k in r:
            if k.startswith(TIMING):
                assert g[k] > 0


def both_evaluate(monkeypatch, s, cfg_kw, jdatasets, datasets):
    calls = replayed(monkeypatch)
    jcfg, cfg = jharness.EvalConfig(**cfg_kw), EvalConfig(**cfg_kw)
    ref = jharness.Evaluator(s["jmodel"], jcfg, s["jstats"]).evaluate(
        s["params"], jdatasets, log_fn=lambda *_: None)
    n_drawn = len(calls)
    got = Evaluator(s["model"], cfg, s["stats"], device="cpu").evaluate(
        datasets, log_fn=lambda *_: None)
    assert n_drawn > 0 and calls == []               # the port drew every mask, no more
    return got, ref, n_drawn


LAYOUTS = {"dense": dict(agg_mode="dense"), "banded": dict(agg_mode="banded", band_block=8)}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("same_mask", [False, True])
def test_clean_matches_jax(monkeypatch, setup, layout, same_mask):
    s = setup
    # batch 4 over 6 snapshots: a ragged last batch; sensors always masked
    kw = dict(test_type="clean", num_test_trials=2, batch_size=4, mask_rate=0.5,
              gpu_warmup_times=1, sensor_names=s["sensors"], use_same_mask=same_mask,
              **LAYOUTS[layout])
    got, ref, n_drawn = both_evaluate(monkeypatch, s, kw, s["jtest"], s["test"])
    assert n_drawn == 2 * 2 * 2                      # trials x passes x batches
    assert_results_match(got, ref)
    assert "test_mae_sensor_mean" in got[2]


@pytest.fixture(scope="module")
def scenes(setup):
    kw = dict(num_test_trials=3, mean_dmd=0.05, std_dmd=0.1, seed=7)
    jsc = jharness.make_noisy_scenes([INP], jharness.EvalConfig(**kw), setup["jstats"])
    sc = harness.make_noisy_scenes([INP], EvalConfig(**kw), setup["stats"])
    return jsc, sc, kw


def test_noisy_scenes_match_jax(scenes):
    jsc, sc, _ = scenes
    assert len(sc) == 3 and len({id(d.members[0].template) for d in sc}) == 1
    for jd, d in zip(jsc, sc):
        np.testing.assert_array_equal(d.members[0].array, jd.members[0].array)
        assert d.members[0].kept_names == jd.members[0].kept_names


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("test_type", ["noisy11", "noisyNN"])
@pytest.mark.parametrize("batchable", [True, False])
def test_noisy_matches_jax(monkeypatch, setup, scenes, layout, test_type, batchable):
    """The scene-batched path (all scenes on the batch axis) and, with it
    switched off in both packages, the sequential path."""
    s = setup
    jsc, sc, kw = scenes
    if not batchable:
        monkeypatch.setattr(jharness.Evaluator, "_scenes_batchable", lambda self, d: False)
        monkeypatch.setattr(harness.Evaluator, "_scenes_batchable", lambda self, d: False)
    cfg = dict(test_type=test_type, num_test_trials=3, batch_size=1, mask_rate=0.5,
               gpu_warmup_times=1, sensor_names=s["sensors"], seed=kw["seed"],
               **LAYOUTS[layout])
    got, ref, n_drawn = both_evaluate(monkeypatch, s, cfg, jsc, sc)
    draws = 1 if test_type == "noisy11" else 3
    assert n_drawn == 2 * (draws if batchable else 3 * draws)
    assert_results_match(got, ref, moments=batchable)


def test_scene_metrics_match_gathered(setup):
    """Per-scene moment metrics of the batched path == the gathered metrics
    of one scene at a time, on the same out / y / mask."""
    s = setup
    ev = Evaluator(s["model"], EvalConfig(mask_rate=0.5), s["stats"], device="cpu")
    tpl = s["test"].members[0].template
    n, N = tpl.n_node, 3
    rng = np.random.default_rng(7)
    out = torch.as_tensor(rng.standard_normal((N * n, 1)).astype(np.float32))
    y = torch.as_tensor((rng.standard_normal((N * n, 1)) * 0.5).astype(np.float32))
    k = masked_count(n, 0.5)
    rows = np.zeros((N, n), bool)
    for i in range(N):
        rows[i, rng.choice(n, size=k, replace=False)] = True
    mask = torch.as_tensor(rows.reshape(-1))
    loss_b, mets_b = ev._scene_metrics(N, n, "test", out, y, mask)
    for i in range(N):
        sl = slice(i * n, (i + 1) * n)
        loss_g, mets_g = ev._metrics(tpl, 1, "test", out[sl], y[sl], mask[sl])
        torch.testing.assert_close(loss_b[i], loss_g, rtol=1e-5, atol=0)
        for mk in mets_g:
            tol = dict(rtol=0, atol=1e-3) if mk in ("test_corr", "test_r2") else \
                dict(rtol=1e-4, atol=1e-5)
            torch.testing.assert_close(mets_b[mk][i], mets_g[mk], **tol, msg=mk)


def test_drawn_masks_repeat_from_the_seed(setup):
    """Without replay the port draws its own masks: one seed gives the same
    results twice; the sensor pass keeps the sensors masked."""
    s = setup
    cfg = EvalConfig(test_type="clean", num_test_trials=2, batch_size=4, mask_rate=0.5,
                     gpu_warmup_times=0, sensor_names=s["sensors"])
    a = Evaluator(s["model"], cfg, s["stats"], device="cpu").evaluate(s["test"], log_fn=lambda *_: None)
    b = Evaluator(s["model"], cfg, s["stats"], device="cpu").evaluate(s["test"], log_fn=lambda *_: None)
    for x, y in zip(a, b):
        assert {k: v for k, v in x.items() if not k.startswith(TIMING)} == \
               {k: v for k, v in y.items() if not k.startswith(TIMING)}
    ev = Evaluator(s["model"], cfg, s["stats"], device="cpu")
    tpl = s["test"].members[0].template
    req = ev._sensor_idx(tpl)
    assert req == tuple(tpl.node_names.index(nm) for nm in s["sensors"])
    m = ev._draw_mask(np.random.default_rng(0), 3, tpl.n_node, req).reshape(3, -1)
    assert m[:, list(req)].all() and (m.sum(1) == masked_count(tpl.n_node, 0.5)).all()


def test_evaluator_refuses_a_mesh(setup):
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        Evaluator(setup["model"], EvalConfig(), setup["stats"], mesh=object(), device="cpu")


def test_timer_formulas_match_jax():
    timings, graphs = [3.5, 1.25, 2.0, 7.75], [4, 4, 2, 4]
    t, jt = Timer(), JaxTimer()
    t.timings, t.num_graphs = list(timings), list(graphs)
    jt.timings, jt.num_graphs = list(timings), list(graphs)
    for n in (14, 3):
        assert t.compute_time(n) == jt.compute_time(n)
        assert t.compute_throughput(n) == jt.compute_throughput(n)
    calls = []
    f = Timer().auto_measure(lambda v: calls.append(v) or v, 5, warmup_times=2)
    assert f(1) == 1 and f(2) == 2 and calls == [1, 1, 1, 2]


@pytest.mark.parametrize("with_truth", [False, True])
def test_inference_result_files_match_jax(tmp_path, with_truth):
    rng = np.random.default_rng(3)
    kw = dict(node_names=[f"J{i}" for i in range(7)],
              pred=(50 + 10 * rng.standard_normal((3, 7))).astype(np.float32),
              observed=rng.random(7) < 0.4,
              true=(50 + 10 * rng.standard_normal((3, 7))).astype(np.float32) if with_truth else None)
    InferenceResult(**kw).save_csv(str(tmp_path / "p.csv"))
    JaxInferenceResult(**kw).save_csv(str(tmp_path / "j.csv"))
    assert (tmp_path / "p.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    InferenceResult(**kw).save_npz(str(tmp_path / "p.npz"))
    JaxInferenceResult(**kw).save_npz(str(tmp_path / "j.npz"))
    with np.load(tmp_path / "p.npz") as p, np.load(tmp_path / "j.npz") as j:
        assert sorted(p.files) == sorted(j.files) == sorted(
            ["node_names", "pred", "observed"] + (["true"] if with_truth else []))
        for k in p.files:
            np.testing.assert_array_equal(p[k], j[k])
            assert p[k].dtype == j[k].dtype
