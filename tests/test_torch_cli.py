"""PyTorch port, the command line against the JAX package's.

- the parser: every subcommand has the JAX flags with the same defaults,
  choices and types, ``--device`` apart (``cuda | cpu``);
- ``train`` and ``eval`` build the JAX ``TrainConfig`` / ``EvalConfig`` from
  the same argv, field by field (``Trainer`` / ``Evaluator`` patched in each
  package to capture them);
- ``mkconfig`` and ``netgen`` write the JAX files byte for byte;
- the ``test_cli_e2e.py`` workflow through the port's CLI with ``--device
  cpu``, with ``--do_test``, the JSONL log, a profiler trace and a resume;
- a checkpoint the JAX CLI trained, converted by
  ``tools/flax_ckpt_to_torch.py``: its parameters and Adam state equal
  ``weights.params_from_flax`` / ``adam_state_from_optax`` of the JAX trees,
  ``Trainer.restore`` resumes from it, and the port's ``cli infer`` on it
  gives the JAX ``cli infer``'s fields within 1e-4 in the dense and the
  banded mode;
- the refusals: each flag or command the port does not have yet exits
  non-zero, naming its ROADMAP item; no card means a raise, not the CPU.

One module fixture runs the JAX side once: netgen, mkconfig, generate (20
scenarios: train 12, valid 4, test 4) and one epoch of ``train``.
"""

import argparse
import configparser
import dataclasses
import os
import subprocess
import sys
import tomllib
from pathlib import Path

import numpy as np
import pytest
import torch

from gnn_pressure_estimation_tpu import cli as jcli
from gnn_pressure_estimation_tpu_torch import cli as pcli

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import flax_ckpt_to_torch  # noqa: E402

SUBCOMMANDS = ["train", "eval", "infer", "generate", "mkconfig", "netgen", "benchmark"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX CLI's netgen → mkconfig → generate → train (1 epoch,
    gatres_small, AutoClip), and the trained checkpoint converted."""
    d = tmp_path_factory.mktemp("torch_cli")
    inp, ini, ck = str(d / "net.inp"), str(d / "net.ini"), str(d / "ck")
    assert jcli.main(["netgen", "--junctions", "24", "--reservoirs", "1", "--tanks", "1",
                      "--pumps", "1", "--valves", "1", "--out", inp, "--seed", "3"]) == 0
    assert jcli.main(["mkconfig", "--wn_inp_path", inp, "--out", ini,
                      "--num_scenarios", "20"]) == 0
    cp = configparser.ConfigParser()
    cp.read(ini)
    cp.set("general", "storage_dir", str(d / "data"))
    with open(ini, "w") as fh:
        cp.write(fh)
    assert jcli.main(["generate", "--config", ini, "--executors", "1", "--batch_size", "4",
                      "--gen_demand", "--gen_res_total_head"]) == 0
    zipf = str(d / "data.zip")
    assert jcli.main(["train", "--model", "gatres_small", "--dataset_paths", zipf,
                      "--input_paths", inp, "--epochs", "1", "--batch_size", "4",
                      "--mask_rate", "0.75", "--save_path", ck, "--variant", "jax",
                      "--use_gradient_clipping", "--device", "cpu"]) == 0
    jax_ckpt = os.path.join(ck, "last_gatres_small_jax.ckpt")
    torch_ckpt = str(d / "converted.ckpt")
    from gnn_pressure_estimation_tpu_torch.models.presets import select_model

    flax_ckpt_to_torch.convert(jax_ckpt, torch_ckpt, select_model("gatres_small", device="cpu")[0])
    return dict(dir=d, inp=inp, ini=ini, zip=zipf, jax_ckpt=jax_ckpt, torch_ckpt=torch_ckpt)


# ---- the parser --------------------------------------------------------------

def _actions(parser, command):
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {a.dest: a for a in sub.choices[command]._actions if a.dest != "help"}


@pytest.mark.parametrize("command", SUBCOMMANDS)
def test_parser_matches_jax(command):
    """The same flags, defaults, choices, types, nargs and actions; only
    ``--device`` differs (``cuda | cpu``, not ``tpu | cpu``)."""
    # the JAX parser is built inside its main(): capture it at parse time
    got = {}

    def capture(self, args=None, namespace=None):
        got["parser"] = self
        raise SystemExit(0)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(SystemExit):
            jcli.main([command])
    jp = got["parser"]
    ja, pa = _actions(jp, command), _actions(pcli.build_parser(), command)
    assert ja.keys() == pa.keys()
    for dest, j in ja.items():
        p = pa[dest]
        assert p.option_strings == j.option_strings, dest
        assert type(p) is type(j) and p.nargs == j.nargs and p.type == j.type, dest
        assert p.required == j.required, dest
        if dest == "device":
            assert j.choices == ["tpu", "cpu", None] and p.choices == ["cuda", "cpu", None]
            assert p.default is j.default is None
        elif dest == "variant":           # a time stamp of the minute the parser was built
            assert len(p.default) == len(j.default) == 13 and p.default[8] == "_"
        else:
            assert p.choices == j.choices and p.default == j.default, dest


# ---- the configs each CLI builds ------------------------------------------------

class _Captured(Exception):
    pass


def _capture(monkeypatch, module, name):
    seen = []

    def stub(model, cfg, *args, **kwargs):
        seen.append(cfg)
        raise _Captured

    monkeypatch.setattr(module, name, stub)
    return seen


def _same_fields(jcfg, pcfg):
    """Every field of the JAX config has the port's value."""
    for f in dataclasses.fields(jcfg):
        assert hasattr(pcfg, f.name), f.name
        assert getattr(pcfg, f.name) == getattr(jcfg, f.name), f.name


@pytest.mark.parametrize("extra", [
    [],
    ["--criterion", "mae", "--norm_type", "minmax", "--scheduler", "ReduceLROnPlateau",
     "--use_gradient_clipping", "--percentile", "25", "--log_gradient", "--num_trains", "8"],
    ["--lr", "0.002", "--weight_decay", "0", "--patience", "3", "--min_delta", "0.01",
     "--agg_mode", "banded", "--band_block", "16", "--matmul_precision", "highest",
     "--attn_impl", "softmax", "--seed", "5", "--scheduler_patience", "4"],
], ids=["defaults", "criterion-clip", "layout"])
def test_train_config_matches_jax(jax_run, monkeypatch, extra):
    import gnn_pressure_estimation_tpu.train as jtrain
    import gnn_pressure_estimation_tpu_torch.train as ptrain

    argv = ["train", "--dataset_paths", jax_run["zip"], "--input_paths", jax_run["inp"],
            "--variant", "v1", "--save_path", str(jax_run["dir"] / "cfg"), "--device", "cpu",
            *extra]
    jseen, pseen = _capture(monkeypatch, jtrain, "Trainer"), _capture(monkeypatch, ptrain, "Trainer")
    for main in (jcli.main, pcli.main):
        with pytest.raises(_Captured):
            main(argv)
    _same_fields(jseen[0], pseen[0])
    assert pseen[0].band_attn is None         # the port's own field: routed by layout


@pytest.mark.parametrize("extra", [
    ["--test_type", "clean", "--num_test_trials", "3", "--batch_size", "2", "--use_same_mask"],
    ["--test_type", "noisyNN", "--num_test_trials", "2", "--mean_dmd", "0.05", "--std_dmd",
     "0.2", "--gpu_warmup_times", "0", "--criterion", "mae"],
    ["--from_set", "all", "--num_tests", "5", "--agg_mode", "banded", "--band_block", "8",
     "--test_removal", "keep_all", "--mask_rate", "0.5"],
], ids=["clean", "noisyNN", "all-banded"])
def test_eval_config_matches_jax(jax_run, monkeypatch, extra):
    import gnn_pressure_estimation_tpu.evaluation as jeval
    import gnn_pressure_estimation_tpu_torch.evaluation as peval

    common = ["eval", "--test_data_path", jax_run["zip"], "--test_input_path", jax_run["inp"],
              "--device", "cpu", *extra]
    jseen, pseen = _capture(monkeypatch, jeval, "Evaluator"), _capture(monkeypatch, peval, "Evaluator")
    with pytest.raises(_Captured):
        jcli.main(common + ["--model_path", jax_run["jax_ckpt"]])
    with pytest.raises(_Captured):
        pcli.main(common + ["--model_path", jax_run["torch_ckpt"]])
    _same_fields(jseen[0], pseen[0])


# ---- mkconfig, netgen ------------------------------------------------------------

@pytest.mark.parametrize("strategy", ["minmax", "quantile"])
def test_mkconfig_matches_jax(tmp_path, strategy):
    inp = str(ROOT / "inputs" / "minitown.inp")
    out = str(tmp_path / "minitown.ini")
    texts = []
    for main in (jcli.main, pcli.main):
        assert main(["mkconfig", "--wn_inp_path", inp, "--out", out, "--num_scenarios", "12",
                     "--strategy", strategy]) == 0
        texts.append(Path(out).read_text())
    assert texts[0] == texts[1] and "[junction]" in texts[0]


def test_netgen_matches_jax(tmp_path):
    argv = ["netgen", "--junctions", "40", "--reservoirs", "2", "--tanks", "1", "--pumps", "2",
            "--valves", "2", "--seed", "11"]
    assert jcli.main(argv + ["--out", str(tmp_path / "j" / "n.inp")]) == 0
    assert pcli.main(argv + ["--out", str(tmp_path / "p" / "n.inp")]) == 0
    assert (tmp_path / "p" / "n.inp").read_text() == (tmp_path / "j" / "n.inp").read_text()


# ---- the workflow of test_cli_e2e.py through the port's CLI --------------------------

def test_port_cli_full_workflow(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "wandb", None)       # the JSONL fallback, as on the card
    d = str(tmp_path)
    inp, ini, ckdir = f"{d}/net.inp", f"{d}/net.ini", f"{d}/ckpt"
    assert pcli.main(["netgen", "--junctions", "24", "--reservoirs", "1", "--tanks", "1",
                      "--pumps", "1", "--valves", "1", "--out", inp, "--seed", "3"]) == 0
    assert pcli.main(["mkconfig", "--wn_inp_path", inp, "--out", ini,
                      "--num_scenarios", "16"]) == 0
    cp = configparser.ConfigParser()
    cp.read(ini)
    cp.set("general", "storage_dir", f"{d}/data")
    with open(ini, "w") as fh:
        cp.write(fh)
    assert pcli.main(["generate", "--config", ini, "--executors", "2", "--batch_size", "4",
                      "--gen_demand", "--gen_res_total_head"]) == 0
    zipf = f"{d}/data.zip"
    assert os.path.exists(zipf)

    train = ["train", "--model", "gatres_small", "--dataset_paths", zipf, "--input_paths", inp,
             "--batch_size", "4", "--mask_rate", "0.75", "--save_path", ckdir, "--variant", "w",
             "--device", "cpu"]
    assert pcli.main(train + ["--epochs", "2", "--do_test", "--log_method", "wandb",
                              "--profile_dir", f"{d}/prof", "--profile_epochs", "1"]) == 0
    out = capsys.readouterr().out
    assert "wandb not installed — falling back to JSONL logging" in out
    assert "average result of 10 runs" in out                   # --do_test: 10 clean trials
    assert sorted(os.listdir(ckdir)) == ["best_gatres_small_w.ckpt", "gatres_small_w.jsonl",
                                         "last_gatres_small_w.ckpt"]
    log = Path(ckdir, "gatres_small_w.jsonl").read_text().splitlines()
    assert len(log) == 4 and '"epoch": 2' in log[2]
    assert os.listdir(f"{d}/prof") == ["gatres_small_w.trace.json"]
    assert pcli.main(train + ["--epochs", "3", "--model_path",
                              f"{ckdir}/last_gatres_small_w.ckpt"]) == 0
    assert "continuing at 3" in capsys.readouterr().out
    from gnn_pressure_estimation_tpu_torch.train import load_checkpoint

    assert load_checkpoint(f"{ckdir}/last_gatres_small_w.ckpt")[2]["epoch"] == 3

    best = f"{ckdir}/best_gatres_small_w.ckpt"
    assert pcli.main(["eval", "--model", "gatres_small", "--model_path", best,
                      "--test_input_path", inp, "--test_type", "noisyNN",
                      "--num_test_trials", "2", "--batch_size", "1", "--mask_rate", "0.5",
                      "--mean_dmd", "0.05", "--std_dmd", "0.1", "--device", "cpu",
                      "--gpu_warmup_times", "0"]) == 0
    assert pcli.main(["eval", "--model", "gatres_small", "--model_path", best,
                      "--test_data_path", zipf, "--test_input_path", inp, "--from_set", "all",
                      "--num_tests", "5", "--num_test_trials", "1", "--batch_size", "2",
                      "--mask_rate", "0.75", "--device", "cpu", "--gpu_warmup_times", "0"]) == 0
    assert "average result of 1 runs" in capsys.readouterr().out
    # one fresh noise-free simulation of the INP as the snapshot source
    assert pcli.main(["eval", "--model", "gatres_small", "--model_path", best,
                      "--test_input_path", inp, "--from_set", "inp", "--num_test_trials", "2",
                      "--batch_size", "1", "--device", "cpu", "--gpu_warmup_times", "0"]) == 0
    assert pcli.main(["infer", "--model", "gatres_small", "--model_path", best,
                      "--test_input_path", inp, "--from_set", "inp", "--observed",
                      "J1,J2,J3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "average result of 2 runs" in out and "inferred 1 snapshots × 24 nodes (3 observed)" in out
    assert pcli.main(["infer", "--model", "gatres_small", "--model_path", best,
                      "--test_data_path", zipf, "--test_input_path", inp, "--from_set", "test",
                      "--observed", "random", "--mask_rate", "0.5", "--batch_size", "2",
                      "--num_snapshots", "3", "--device", "cpu", "--out_npz", f"{d}/preds.npz",
                      "--out_csv", f"{d}/preds.csv"]) == 0
    z = np.load(f"{d}/preds.npz")
    assert z["pred"].shape[0] == 3 and np.isfinite(z["pred"]).all()
    obs = z["observed"].astype(bool)
    np.testing.assert_allclose(z["pred"][:, obs], z["true"][:, obs], rtol=1e-5)
    assert os.path.getsize(f"{d}/preds.csv") > 0


# ---- the converter and serving a JAX-trained model -------------------------------------

def test_converter_matches_weights_helpers(jax_run):
    """The converted checkpoint holds ``params_from_flax`` of the JAX
    parameters, ``adam_state_from_optax`` of its Adam state, its learning
    rate and AutoClip buffer, and its meta unchanged."""
    from gnn_pressure_estimation_tpu.train.checkpoint import load_checkpoint as jload
    from gnn_pressure_estimation_tpu_torch.train import load_checkpoint
    from gnn_pressure_estimation_tpu_torch.models.presets import select_model
    from gnn_pressure_estimation_tpu_torch.weights import adam_state_from_optax, params_from_flax

    jparams, jopt, jmeta = jload(jax_run["jax_ckpt"])
    params, opt, meta = load_checkpoint(jax_run["torch_ckpt"])
    model = select_model("gatres_small", device="cpu")[0]
    ref = params_from_flax(jparams, model)
    assert params.keys() == ref.keys() and all(torch.equal(params[k], ref[k]) for k in ref)
    (chain, hyper) = jopt["0"], jopt["1"]
    adam = chain["2"]
    names = [k for k, _ in model.named_parameters()]
    for i, st in adam_state_from_optax(adam["mu"], adam["nu"], int(adam["count"]), model).items():
        for key, t in (("step", "adam.step"), ("exp_avg", "adam.exp_avg"),
                       ("exp_avg_sq", "adam.exp_avg_sq")):
            assert torch.equal(opt[f"{t}.{names[i]}"], st[key])
    assert float(opt["adam.step.lin0.bias"]) == int(adam["count"]) > 0
    assert float(opt["lr"]) == float(hyper["hyperparams"]["learning_rate"])
    np.testing.assert_array_equal(opt["autoclip.history"].numpy(), chain["0"]["history"])
    assert int(opt["autoclip.count"]) == int(chain["0"]["count"])
    assert {k: meta[k] for k in ("epoch", "loss", "metrics", "extra")} == \
           {k: jmeta[k] for k in ("epoch", "loss", "metrics", "extra")}
    assert meta["stats"].to_dict() == jmeta["stats"].to_dict()


def test_converter_command_line(jax_run, tmp_path, monkeypatch, capsys):
    out = str(tmp_path / "again.ckpt")
    monkeypatch.setattr(sys, "argv", ["flax_ckpt_to_torch.py", jax_run["jax_ckpt"], out])
    flax_ckpt_to_torch.main()
    assert f"wrote {out}: epoch 1" in capsys.readouterr().out
    a = torch.load(out, weights_only=True)
    b = torch.load(jax_run["torch_ckpt"], weights_only=True)
    assert a["meta_json"] == b["meta_json"]
    assert all(torch.equal(a["params"][k], b["params"][k]) for k in b["params"])


def test_converted_checkpoint_resumes(jax_run, capsys):
    """``Trainer.restore`` takes the converted checkpoint whole (parameters,
    Adam state, learning rate, AutoClip, epoch, resume state, stats, layout),
    and ``cli train --model_path`` continues at the next epoch."""
    from gnn_pressure_estimation_tpu_torch.data import WDNDataset
    from gnn_pressure_estimation_tpu_torch.models.presets import select_model
    from gnn_pressure_estimation_tpu_torch.train import Trainer, load_checkpoint

    params, opt, meta = load_checkpoint(jax_run["torch_ckpt"])
    ds = WDNDataset([jax_run["zip"]], [jax_run["inp"]])
    model, preset = select_model("gatres_small", device="cpu")
    tr = Trainer(model, preset.train_config(use_gradient_clipping=True), ds.stats,
                 ds.members[0].template, device="cpu")
    got = tr.restore(jax_run["torch_ckpt"])
    assert got["epoch"] == 1 and tr._resume["epoch"] == 1
    assert got["stats"] == meta["stats"] and got["extra"]["layout"] == {"agg_mode": None,
                                                                         "band_block": None}
    assert tr._resume["early"] == meta["extra"]["resume"]["early"]
    assert all(torch.equal(v, params[k]) for k, v in tr.model.state_dict().items())
    assert tr.lr == float(opt["lr"])
    state = tr.opt_state_dict()
    assert all(torch.equal(state[k], opt[k].to(state[k].dtype)) for k in opt)
    assert pcli.main(["train", "--model", "gatres_small", "--dataset_paths", jax_run["zip"],
                      "--input_paths", jax_run["inp"], "--epochs", "2", "--batch_size", "4",
                      "--mask_rate", "0.75", "--save_path", str(jax_run["dir"] / "resumed"),
                      "--variant", "r", "--use_gradient_clipping", "--device", "cpu",
                      "--model_path", jax_run["torch_ckpt"]]) == 0
    out = capsys.readouterr().out
    assert "(epoch 1, continuing at 2)" in out and "Epoch: 002" not in out.split("continuing")[0]
    last = load_checkpoint(str(jax_run["dir"] / "resumed" / "last_gatres_small_r.ckpt"))
    assert last[2]["epoch"] == 2


@pytest.mark.parametrize("layout", [["--agg_mode", "dense"],
                                    ["--agg_mode", "banded", "--band_block", "8"]],
                         ids=["dense", "banded"])
def test_infer_matches_jax_cli(jax_run, tmp_path, layout):
    """The JAX ``cli infer`` on its checkpoint and the port's on the
    converted one export the same fields: predictions within 1e-4 m, the
    same observed nodes, names and truth, observed nodes served exactly."""
    flags = ["infer", "--model", "gatres_small", "--test_data_path", jax_run["zip"],
             "--test_input_path", jax_run["inp"], "--from_set", "test", "--observed", "random",
             "--seed", "7", "--mask_rate", "0.75", "--batch_size", "2", "--device", "cpu",
             *layout]
    jnpz, pnpz = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    assert jcli.main(flags + ["--model_path", jax_run["jax_ckpt"], "--out_npz", jnpz]) == 0
    assert pcli.main(flags + ["--model_path", jax_run["torch_ckpt"], "--out_npz", pnpz]) == 0
    j, p = np.load(jnpz), np.load(pnpz)
    np.testing.assert_array_equal(p["observed"], j["observed"])
    np.testing.assert_array_equal(p["node_names"], j["node_names"])
    np.testing.assert_allclose(p["true"], j["true"], rtol=0, atol=1e-5)
    assert p["pred"].shape == j["pred"].shape == (4, 24)
    np.testing.assert_allclose(p["pred"], j["pred"], rtol=0, atol=1e-4)
    obs = p["observed"].astype(bool)
    np.testing.assert_array_equal(p["pred"][:, obs], p["true"][:, obs])


# ---- refusals and the device ---------------------------------------------------------------

@pytest.mark.parametrize("argv,item", [
    # the first four cases refused the model zoo (item 6) until it was ported; they
    # keep their ids, as do the cases of --mesh and --distributed (item 7) and of the
    # training knobs (items 8 and 2, ported since): a case whose flags all run stops at
    # the device check, with no card and no --device cpu, as every command does (item
    # None); a model without the activation-dtype knob fails as the JAX command fails
    # ("jax"); benchmark still names its item
    pytest.param(["train", "--model", "gin", "--activation_dtype", "bfloat16"], "jax",
                 id="train---model-gin-6"),
    pytest.param(["eval", "--model", "mgcn", "--mesh", "2,1", "--model_path", "x.ckpt"], None,
                 id="eval---model-mgcn---model_path-x.ckpt-6"),
    pytest.param(["train", "--model", "gat", "--distributed", "--matmul_precision", "bfloat16"],
                 None, id="infer---model-gat---model_path-x.ckpt-6"),
    pytest.param(["train", "--model", "chebnet", "--epochs_per_dispatch", "2"], None,
                 id="train---model-chebnet-6"),
    pytest.param(["train", "--mesh", "2,1", "--epochs_per_dispatch", "2"], None,
                 id="train---mesh-2,1-7"),
    pytest.param(["eval", "--mesh", "4,2", "--model_path", "x.ckpt"], None,
                 id="eval---mesh-4,2---model_path-x.ckpt-7"),
    pytest.param(["train", "--distributed", "--activation_dtype", "bfloat16"], None,
                 id="train---distributed-7"),
    pytest.param(["train", "--activation_dtype", "bfloat16"], None,
                 id="train---activation_dtype-bfloat16-8"),
    pytest.param(["train", "--matmul_precision", "bfloat16"], None,
                 id="train---matmul_precision-bfloat16-8"),
    pytest.param(["train", "--matmul_precision", "tensorfloat32"], None,
                 id="train---matmul_precision-tensorfloat32-8"),
    pytest.param(["train", "--epochs_per_dispatch", "4"], None,
                 id="train---epochs_per_dispatch-4-2"),
    pytest.param(["benchmark"], 1, id="benchmark-1"),
])
def test_refused_flags_name_their_item(argv, item, monkeypatch):
    if item is None:                 # the flags run: no refusal, the device check stops it
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pcli.main(argv)
        return
    if item == "jax":                # the JAX command fails on the same model: its message
        import jax.numpy as jnp

        from gnn_pressure_estimation_tpu.models.presets import select_model as jax_select

        with pytest.raises(ValueError) as jax_err:
            jax_select(argv[2], dtype=jnp.bfloat16)
        with pytest.raises(SystemExit) as e:
            pcli.main(argv)
        assert e.value.code == str(jax_err.value)
        return
    with pytest.raises(SystemExit) as e:
        pcli.main(argv)
    assert e.value.code not in (0, None)
    assert f"ROADMAP Queue 1 item {item}" in str(e.value.code)
    assert "not yet ported" in str(e.value.code)


@pytest.mark.parametrize("command", ["train", "eval", "infer"])
def test_no_card_raises_without_device_cpu(command, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pcli.main([command, "--model_path", "x.ckpt"])


def test_module_entry_point_and_packaging():
    """``python -m gnn_pressure_estimation_tpu_torch.cli`` runs ``main``;
    ``pyproject.toml`` installs it as ``gnn-wdn-torch`` with the solver's
    source beside the kernels'."""
    proc = subprocess.run([sys.executable, "-m", "gnn_pressure_estimation_tpu_torch.cli",
                           "benchmark"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1 and "item 1" in proc.stderr
    proj = tomllib.loads((ROOT / "pyproject.toml").read_text())
    assert proj["project"]["scripts"]["gnn-wdn-torch"] == "gnn_pressure_estimation_tpu_torch.cli:main"
    data = proj["tool"]["setuptools"]["package-data"]
    assert set(data["gnn_pressure_estimation_tpu_torch.simgen.solver"]) == {"*.cpp", "Makefile"}
