"""PyTorch port, scenario generation's parts and run logging against the JAX
package: the five formulas, the feature layout and its sampling under one
seed (bit-equal), the options, the config creator, the user-value
injections, the executor's network state and solve (pressures within 1e-6
m), ``mean_feature_corr``, and ``make_logger``'s three loggers.

The counterparts of ``tests/test_simgen.py:22-98`` and of the executor and
injection checks there and in ``test_generation_repro.py``. The port's
modules are copies over its own ``data/inp.py`` and solver, so everything
numpy computes is held bit for bit; the solve within 1e-6 m.
"""

import dataclasses
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from gnn_pressure_estimation_tpu.data.inp import parse_inp as jax_parse_inp
from gnn_pressure_estimation_tpu.simgen import config as jcfg
from gnn_pressure_estimation_tpu.simgen import executor as jex
from gnn_pressure_estimation_tpu.simgen import runner as jrun
from gnn_pressure_estimation_tpu.simgen import tokens as jtk
from gnn_pressure_estimation_tpu.utils import logging as jlog
from gnn_pressure_estimation_tpu_torch.data.inp import parse_inp, write_inp
from gnn_pressure_estimation_tpu_torch.simgen import config as pcfg
from gnn_pressure_estimation_tpu_torch.simgen import executor as pex
from gnn_pressure_estimation_tpu_torch.simgen import runner as prun
from gnn_pressure_estimation_tpu_torch.simgen import tokens as ptk
from gnn_pressure_estimation_tpu_torch.simgen.netgen import make_wdn
from gnn_pressure_estimation_tpu_torch.utils import logging as plog

ROOT = Path(__file__).resolve().parents[1]
# every gen_* flag on, so the layout holds all sixteen parameter keys
ALL_GEN = dict(gen_demand=True, gen_elevation=True, gen_roughness=True, gen_diameter=True,
               gen_length=True, gen_minorloss=True, gen_valve_init_status=True,
               gen_valve_setting=True, gen_valve_diameter=True, gen_pump_init_status=True,
               gen_pump_speed=True, gen_pump_length=True, gen_tank_level=True,
               gen_tank_elevation=True, gen_tank_diameter=True, gen_res_total_head=True)


@pytest.fixture(scope="module")
def net(tmp_path_factory):
    """A synthetic network with every element kind, as an INP both packages
    parse, and its generation INI from each package's config creator."""
    d = tmp_path_factory.mktemp("torch_simgen")
    inp = str(d / "net.inp")
    write_inp(make_wdn(30, 1, 2, 2, 3, seed=4), inp)
    return inp, jcfg.create_dummy_config(inp), pcfg.create_dummy_config(inp)


def _formula_inputs(name, seed=0):
    rng = np.random.default_rng(seed)
    t = rng.random((4, 30))
    ori = rng.random(30) * 10 + 1.0
    kw = dict(ori_vals=ori)
    if name == "ran_cluster":
        kw.update(coords=rng.random((30, 2)), num_clusters_lo=2, num_clusters_hi=5, sigma=1.0)
    if name == "ratio" or name == "diameter_ratio":
        t = t * 2.0 - 1.0                # signed ratios
    return t, kw


@pytest.mark.parametrize("name", ["range", "bool", "ratio", "diameter_ratio", "ran_cluster"])
def test_formula_matches_jax(name):
    """Each formula gives the JAX values bit for bit on the same tokens, and
    consumes the generator as the JAX one does (ran_cluster draws from it)."""
    assert set(ptk.FORMULAS) == set(jtk.FORMULAS)
    t, kw = _formula_inputs(name)
    lo, hi = (0.5, 0.5) if name == "bool" else (2.0, 8.0)
    args = (t, lo) if name == "bool" else (t, lo, hi)
    rj, rp = np.random.default_rng(9), np.random.default_rng(9)
    ref = jtk.FORMULAS[name](*args, rng=rj, **kw)
    got = ptk.FORMULAS[name](*args, rng=rp, **kw)
    np.testing.assert_array_equal(got, ref)
    assert rp.random() == rj.random()        # the same draws were taken
    if name in ("range", "ran_cluster"):
        assert got.min() >= lo and got.max() <= hi


def test_ran_cluster_without_sklearn_names_the_formula(monkeypatch):
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.cluster", None)
    t, kw = _formula_inputs("ran_cluster")
    with pytest.raises(ImportError, match="ran_cluster"):
        ptk.values_by_ran_cluster(t, 2.0, 8.0, rng=np.random.default_rng(0), **kw)


def test_gen_options_match_jax():
    jf = {f.name: (f.default, str(f.type)) for f in dataclasses.fields(jcfg.GenOptions)}
    pf = {f.name: (f.default, str(f.type)) for f in dataclasses.fields(pcfg.GenOptions)}
    assert pf == jf
    opts = dict(att="pressure, head,flow", backend="cpp", seed=3)
    assert pcfg.GenOptions(**opts).to_dict() == jcfg.GenOptions(**opts).to_dict()
    assert pcfg.GenOptions(**opts).attributes() == ["pressure", "head", "flow"]


def _specs_equal(ps, js):
    assert [s.key.value for s in ps] == [s.key.value for s in js]
    for p, j in zip(ps, js):
        for f in dataclasses.fields(jtk.FeatureSpec):
            a, b = getattr(p, f.name), getattr(j, f.name)
            if f.name == "key":
                assert a.value == b.value
            elif isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b, (p.key, f.name)


@pytest.mark.parametrize("flags", [
    dict(ALL_GEN),
    dict(gen_demand=True, gen_res_total_head=True, demand_formula="ran_cluster"),
    dict(gen_elevation=True, elevation_formula="ratio", gen_pump_init_status=True,
         gen_valve_setting=True),
], ids=["all", "demand-ran_cluster", "elevation-ratio"])
def test_feature_specs_and_sampling_match_jax(net, flags):
    """The layout (key order, lengths, ranges, formulas, per-element ranges,
    uids) and the sampled parameters of one seed equal the JAX package's,
    and split back into the same per-key blocks."""
    inp, jc, _ = net
    pspecs = ptk.build_feature_specs(parse_inp(inp), jc, pcfg.GenOptions(**flags))
    jspecs = jtk.build_feature_specs(jax_parse_inp(inp), jc, jcfg.GenOptions(**flags))
    _specs_equal(pspecs, jspecs)
    assert ptk.featlen_dict(pspecs) == jtk.featlen_dict(jspecs)
    if flags == ALL_GEN:
        assert len(pspecs) == 16
    got = ptk.sample_params(pspecs, 5, np.random.default_rng(7))
    ref = jtk.sample_params(jspecs, 5, np.random.default_rng(7))
    np.testing.assert_array_equal(got, ref)
    pb, jb = ptk.split_params(pspecs, got), jtk.split_params(jspecs, ref)
    assert pb.keys() == jb.keys()
    for k in jb:
        np.testing.assert_array_equal(pb[k], jb[k])


@pytest.mark.parametrize("strategy", ["minmax", "quantile"])
def test_config_creator_matches_jax(net, strategy, tmp_path):
    inp, out = net[0], str(tmp_path / "net.ini")
    texts, cfgs = [], []
    for mod in (pcfg, jcfg):
        cfg = mod.create_dummy_config(inp, out_path=out, num_scenarios=7, strategy=strategy, seed=3)
        cfgs.append({s: dict(cfg.items(s)) for s in cfg.sections()})
        texts.append(Path(out).read_text())
        assert {s: dict(v) for s, v in mod.read_config(out).items() if s != "DEFAULT"} == cfgs[-1]
    assert cfgs[0] == cfgs[1] and texts[0] == texts[1]
    assert set(cfgs[0]) == {"general", "junction", "pump", "tank", "valve", "pipe", "reservoir"}
    for values in (np.arange(101.0), np.array([]), np.array([3.0, -1.0, 7.5])):
        assert pcfg.get_range(values, strategy) == jcfg.get_range(values, strategy)


def test_injections_match_jax(net, tmp_path):
    """update_*_json: the same masks and values, inline and from a file, the
    same pinned samples and replayed rows; an unknown uid raises in both."""
    inp, jc, _ = net
    wn = parse_inp(inp)
    inj = {"update_demand_json": json.dumps({wn.junctions[0].id: 1.5, wn.junctions[3].id: 0.0}),
           "update_pipe_roughness_json": f"@{tmp_path / 'rough.json'}"}
    (tmp_path / "rough.json").write_text(json.dumps({wn.pipes[1].id: 90.0}))
    flags = dict(gen_demand=True, gen_roughness=True, gen_res_total_head=True, **inj)
    pspecs = ptk.build_feature_specs(wn, jc, pcfg.GenOptions(**flags))
    jspecs = jtk.build_feature_specs(jax_parse_inp(inp), jc, jcfg.GenOptions(**flags))
    pin = ptk.build_injections(pspecs, pcfg.GenOptions(**flags))
    jin = jtk.build_injections(jspecs, jcfg.GenOptions(**flags))
    assert [i is None for i in pin] == [i is None for i in jin] == [False, False, True]
    for a, b in zip(pin[:2], jin[:2]):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    got = ptk.sample_params(pspecs, 4, np.random.default_rng(1), pin)
    ref = jtk.sample_params(jspecs, 4, np.random.default_rng(1), jin)
    np.testing.assert_array_equal(got, ref)
    assert (got[:, 0] == 1.5).all() and (got[:, 3] == 0.0).all()
    rows = np.random.default_rng(2).random(got.shape)
    np.testing.assert_array_equal(ptk.apply_injections(pspecs, rows, pin),
                                  jtk.apply_injections(jspecs, rows, jin))
    for tk_, specs in ((ptk, pspecs), (jtk, jspecs)):
        with pytest.raises(ValueError, match="not in the network"):
            tk_.parse_injection(json.dumps({"nope": 1.0}), specs[0].uids, specs[0].length)


@pytest.mark.parametrize("flags", [
    dict(ALL_GEN, accept_warning_code=True, allow_error=True),
    dict(gen_demand=True, gen_res_total_head=True, update_totalhead_method="add_max_elevation",
         replace_nonzero_basedmd=True, init_pipe_state=1, pressure_lowerbound=-5.0,
         neighbor_std_threshold=50.0, mean_cv_threshold=100.0, att="pressure,head,demand"),
    dict(gen_valve_init_status=True, gen_tank_level=True, gen_pump_speed=True,
         skip_resevoir_result=True, convert_results_by_flow_unit="GPM", allow_error=True,
         att="pressure,flow,velocity"),
], ids=["all", "filters", "valves-gpm"])
def test_executor_matches_jax(net, flags):
    """The network state each parameter row writes is the JAX executor's,
    field by field, and the solve gives the same accepted rows, names and
    attribute values (within 1e-6 in the output units)."""
    inp, jc, _ = net
    popts, jopts = pcfg.GenOptions(**flags), jcfg.GenOptions(**flags)
    pwn, jwn = parse_inp(inp), jax_parse_inp(inp)
    pspecs = ptk.build_feature_specs(pwn, jc, popts)
    jspecs = jtk.build_feature_specs(jwn, jc, jopts)
    pe, je = pex.ScenarioExecutor(pwn, pspecs, jc, popts), jex.ScenarioExecutor(jwn, jspecs, jc, jopts)
    params = ptk.sample_params(pspecs, 6, np.random.default_rng(5))
    for row in params[:3]:
        ps, js = pe.apply_tokens(row), je.apply_tokens(row)
        for f in dataclasses.fields(js):
            a, b = getattr(ps, f.name), getattr(js, f.name)
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=f.name)
            else:
                assert a == b, f.name
    pout, pnames, pok = pe.simulate(params)
    jout, jnames, jok = je.simulate(params)
    assert pnames == jnames
    np.testing.assert_array_equal(pok, jok)
    assert pout.keys() == jout.keys() and len(pok) > 0
    for k in jout:
        assert pout[k].shape == jout[k].shape
        np.testing.assert_allclose(pout[k], jout[k], rtol=0, atol=1e-6)


def test_executor_prv_setting_converts_psi_in_us_units():
    """As ``test_simgen.py``'s regression: a sampled PRV setting on a US-unit
    network is written as pressure (psi → ft of head), as the INP path does."""
    import configparser

    from gnn_pressure_estimation_tpu_torch.simgen import units as U
    from gnn_pressure_estimation_tpu_torch.simgen.network_state import build_state

    inp = ("[JUNCTIONS]\n N1 80 0\n N2 80 0\n N3 60 250\n[RESERVOIRS]\n R1 300\n"
           "[PIPES]\n P1 R1 N1 500 12 100 0 Open\n P2 N2 N3 800  8 100 0 Open\n"
           "[VALVES]\n V1 N1 N2 200 PRV 40 0\n[OPTIONS]\n UNITS GPM\n HEADLOSS H-W\n"
           "[TIMES]\n DURATION 0\n[END]\n")
    wn = parse_inp(inp)
    cfg = configparser.ConfigParser()
    cfg.add_section("valve")
    cfg.set("valve", "setting_prv_lo", "40")
    cfg.set("valve", "setting_prv_hi", "40")
    opts = pcfg.GenOptions(gen_valve_setting=True)
    specs = ptk.build_feature_specs(wn, cfg, opts)
    params = ptk.sample_params(specs, 1, np.random.default_rng(0))
    ns = pex.ScenarioExecutor(wn, specs, None, opts).apply_tokens(params[0])
    li = list(wn.link_names).index("V1")
    assert abs(ns.valve_setting[li] - U.pressure_to_ft(40.0, ns.units)) < 1e-9
    assert abs(build_state(wn).valve_setting[li] - ns.valve_setting[li]) < 1e-9


@pytest.mark.parametrize("width", [800, 2600], ids=["corrcoef", "closed-form"])
def test_mean_feature_corr_matches_jax(width):
    df = np.random.default_rng(3).standard_normal((9, width))
    df[:, 5] = 2.0          # constant columns: NaN rows in corrcoef
    assert prun.mean_feature_corr(df) == jrun.mean_feature_corr(df)
    assert prun.mean_feature_corr(df[:1]) == jrun.mean_feature_corr(df[:1]) == 1.0


def _strip_times(lines):
    return [{k: v for k, v in json.loads(ln).items() if k != "time"} for ln in lines]


def test_jsonl_logger_matches_jax(tmp_path):
    """The JSONL stream (start with the run's config, one line an epoch,
    finish) is the JAX logger's, times apart."""
    for mod, sub in ((plog, "p"), (jlog, "j")):
        cfg = {"save_path": str(tmp_path / sub), "lr": 5e-4, "model": "gatres_small"}
        lg = mod.make_logger("jsonl", "proj", "run_a", cfg)
        lg.log_epoch(1, {"train_loss": np.float32(0.5), "val_mae": 2.0})
        lg.log_epoch(2, {"train_loss": 0.25, "val_mae": 1.5})
        lg.finish()
    got = (tmp_path / "p" / "run_a.jsonl").read_text().splitlines()
    ref = (tmp_path / "j" / "run_a.jsonl").read_text().splitlines()
    got_rows = _strip_times(got)
    ref_rows = _strip_times(ref)
    for row in got_rows[:1] + ref_rows[:1]:     # the config names its save path
        row["config"].pop("save_path")
    assert got_rows == ref_rows and len(got) == 4
    assert isinstance(plog.make_logger(None, "proj", "run", {}), plog._NullLogger)


def test_wandb_missing_falls_back_to_jsonl(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "wandb", None)
    lg = plog.make_logger("wandb", "proj", "run_b", {"save_path": str(tmp_path)})
    assert "wandb not installed — falling back to JSONL logging" in capsys.readouterr().out
    lg.log_epoch(1, {"val_loss": 0.1})
    lg.finish()
    rows = _strip_times((tmp_path / "run_b.jsonl").read_text().splitlines())
    assert [r["event"] for r in rows] == ["start", "epoch", "finish"]


def test_wandb_logger_when_installed(monkeypatch):
    """With wandb importable the run goes to it: init with the project, run
    name and config, one log an epoch with the epoch, finish."""
    calls = []
    fake = types.SimpleNamespace(init=lambda **kw: calls.append(("init", kw)),
                                 log=lambda d: calls.append(("log", d)),
                                 finish=lambda: calls.append(("finish",)))
    monkeypatch.setitem(sys.modules, "wandb", fake)
    lg = plog.make_logger("wandb", "proj", "run_c", {"lr": 1.0})
    lg.log_epoch(3, {"val_loss": 0.2})
    lg.finish()
    assert calls == [("init", {"project": "proj", "name": "run_c", "config": {"lr": 1.0}}),
                     ("log", {"val_loss": 0.2, "epoch": 3}), ("finish",)]
