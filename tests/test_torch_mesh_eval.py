"""PyTorch port: the mesh evaluation (``Evaluator(mesh=...)``,
``parallel/eval_forward.py``) against the JAX package, and ``cli train |
eval --mesh`` on the CPU.

The JAX ``Evaluator`` runs over a JAX mesh of this process's virtual CPU
devices; every mask it draws is recorded and handed, in order, to the port's
``Evaluator`` over a mesh of 2 gloo ranks (``parallel.launch``,
``torch_rank_jobs.evaluate``), which must ask for as many. Both start from
the JAX model's weights, the output layer scaled ×100 so that predictions
spread as a trained model's do (``tests/test_torch_evaluation.py`` explains
why the moment-based metrics need that). Cases: the halo strategy on
``tests/test_parallel.py``'s chain template (``DENSE_THRESHOLD`` 32) at 1×2,
the graphs strategy at 2×1, each clean with a ragged last batch, and the
scene-batched noisy path (noisyNN on three single-snapshot scenes) at 1×2.
Tolerances are ``test_torch_evaluation.py``'s: rtol 1e-5 / atol 1e-6, on the
scene path corr and r2 atol 1e-3 and NSE rtol 1e-4; the timings only > 0.

The command line: ``train --mesh 1,2`` (graphs strategy) writes rank 0's
checkpoints and a resume continues from them; ``train --mesh 2,1`` with
``--model_path`` resumes; ``eval --mesh 1,2`` under the halo strategy
(``--agg_mode banded``) reports the metrics the single-device ``eval`` of
the same checkpoint reports (the masks come from the same seeds), to the
printed precision; two processes joined with ``--distributed`` train.
"""

import os
import pickle
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_pressure_estimation_tpu.core.graph import GraphTemplate as JaxGraphTemplate
from gnn_pressure_estimation_tpu.data import ZarrZipWriter as JaxZarrZipWriter
from gnn_pressure_estimation_tpu.data.dataset import WDNDataset as JaxWDNDataset
from gnn_pressure_estimation_tpu.data.dataset import _Member as JaxMember
from gnn_pressure_estimation_tpu.evaluation import harness as jharness
from gnn_pressure_estimation_tpu.models.gatres import GATRes as JaxGATRes
from gnn_pressure_estimation_tpu.parallel import make_mesh as jax_make_mesh
from gnn_pressure_estimation_tpu.utils.scaling import NormStats as JaxNormStats
from gnn_pressure_estimation_tpu_torch import cli as pcli
from gnn_pressure_estimation_tpu_torch.models.gatres import GATRes
from gnn_pressure_estimation_tpu_torch.weights import params_from_flax
from helpers import random_graph
from torch_rank_jobs import spawn_jobs

torch.set_num_threads(1)
TIMING = ("test_time", "test_throughput")
INP = "inputs/minitown.inp"


def chain_template(rng, n=64):
    s, r = [], []
    for i in range(n - 1):
        s += [i, i + 1]
        r += [i + 1, i]
    for i in range(n - 2):
        if rng.random() < 0.5:
            s += [i, i + 2]
            r += [i + 2, i]
    tpl = JaxGraphTemplate(n, np.array(s), np.array(r))
    tpl.band_layout(block=8, lane=8)
    return tpl


def jax_dataset(tpl, arrays):
    ds = object.__new__(JaxWDNDataset)
    ds.feature, ds.from_set, ds.norm_type, ds.edge_attrs = "pressure", "test", "znorm", None
    ds.stats = JaxNormStats()
    ds.members = [JaxMember(tpl, np.asarray(arrays, np.float32), [], None)]
    ds._lengths = [len(arrays)]
    ds.length = len(arrays)
    return ds


# case → (strategy's template maker, mesh, evaluation config)
CASES = {
    "halo_clean": ("chain", (1, 2), dict(test_type="clean", num_test_trials=2, batch_size=4)),
    "graphs_clean": ("random", (2, 1), dict(test_type="clean", num_test_trials=2, batch_size=4)),
    "halo_noisyNN": ("chain", (1, 2), dict(test_type="noisyNN", num_test_trials=2, batch_size=1)),
}


@pytest.fixture(scope="module")
def evaluated(tmp_path_factory):
    """The JAX evaluations (masks recorded) and the port's, one launch."""
    jmodel = JaxGATRes(num_blocks=2, channels=8)
    g = random_graph(np.random.default_rng(0), n=6, extra_edges=2).batch(1, mode="dense")
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0),
                                                   jnp.zeros((6, 1), jnp.float32), g))
    params["params"]["lin1"]["kernel"] = params["params"]["lin1"]["kernel"] * 100.0
    state = {k: v.numpy() for k, v in params_from_flax(params, GATRes(2, 8)).items()}
    refs, jobs = {}, []
    old = JaxGraphTemplate.DENSE_THRESHOLD
    draw = jharness.batch_node_mask
    try:
        JaxGraphTemplate.DENSE_THRESHOLD = 32
        for i, (case, (kind, (dp, gp), kw)) in enumerate(sorted(CASES.items())):
            rng = np.random.default_rng(50 + i)
            jt = chain_template(rng) if kind == "chain" else random_graph(rng, n=20,
                                                                         extra_edges=10)
            n = jt.n_node
            cfg = dict(kw, mask_rate=0.5, gpu_warmup_times=1, seed=11)
            calls = []

            def record(key, n_graph, n_, mask_rate, required_idx=(), shared=False):
                m = draw(key, n_graph, n_, mask_rate, required_idx=required_idx, shared=shared)
                calls.append(np.asarray(m))
                return m
            jharness.batch_node_mask = record
            data = rng.standard_normal((6 if kw["test_type"] == "clean" else 3, n))
            data = data.astype(np.float32)
            if kw["test_type"] == "clean":
                jdata = jax_dataset(jt, data)
            else:
                jdata = [jax_dataset(jt, s[None]) for s in data]
            ev = jharness.Evaluator(jmodel, jharness.EvalConfig(**cfg), JaxNormStats(),
                                    mesh=jax_make_mesh(dp=dp, gp=gp))
            refs[case] = (ev.evaluate(params, jdata, log_fn=lambda *_: None), len(calls))
            tpl = dict(n=n, senders=np.asarray(jt.senders), receivers=np.asarray(jt.receivers),
                       band=(8, 8) if kind == "chain" else None)
            job = dict(kind="evaluate", dp=dp, gp=gp, dense_threshold=32, template=tpl,
                       model=("gatres", dict(num_blocks=2, channels=8), state), cfg=cfg,
                       stats={}, masks=calls)
            job["x" if kw["test_type"] == "clean" else "scenes"] = data
            jobs.append(job)
    finally:
        JaxGraphTemplate.DENSE_THRESHOLD = old
        jharness.batch_node_mask = draw
    out = tmp_path_factory.mktemp("mesh_eval")
    spec = os.path.join(out, "spec.pkl")
    with open(spec, "wb") as f:
        pickle.dump({"jobs": jobs, "out": str(out)}, f)
    assert spawn_jobs(2, spec, device="cpu", threads=1, timeout_s=300) == 0
    ranks = [pickle.load(open(os.path.join(out, f"rank{r}.pkl"), "rb"))["results"]
             for r in range(2)]
    return {case: (refs[case], [r[i] for r in ranks])
            for i, case in enumerate(sorted(CASES))}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_evaluation_matches_jax(evaluated, case):
    (ref, n_drawn), ranks = evaluated[case]
    moments = case.endswith("noisyNN")
    assert n_drawn > 0
    for r in ranks:
        assert r["masks_left"] == 0                      # the port asked for every mask
        for g, rf in zip(r["result"], ref):
            keys = {k for k in rf if not k.startswith(TIMING)}
            assert keys == {k for k in g if not k.startswith(TIMING)}
            for k in sorted(keys):
                if moments and k.startswith(("test_corr", "test_r2")):
                    np.testing.assert_allclose(g[k], rf[k], rtol=0, atol=1e-3, err_msg=k)
                elif moments and k.startswith("test_mynse"):
                    np.testing.assert_allclose(g[k], rf[k], rtol=1e-4, atol=1e-6, err_msg=k)
                else:
                    np.testing.assert_allclose(g[k], rf[k], rtol=1e-5, atol=1e-6, err_msg=k)
            for k in rf:
                if k.startswith(TIMING):
                    assert g[k] > 0
    # every rank computed the same numbers
    a, b = ranks
    for x, y in zip(a["result"], b["result"]):
        assert {k: v for k, v in x.items() if not k.startswith(TIMING)} == \
               {k: v for k, v in y.items() if not k.startswith(TIMING)}


# ---- the command line -----------------------------------------------------------------------

@pytest.fixture(scope="module")
def store(tmp_path_factory):
    from gnn_pressure_estimation_tpu.data.inp import parse_inp

    wn = parse_inp(INP)
    rng = np.random.default_rng(0)
    snaps = 50 + rng.normal(0, 8, size=(20, wn.n_nodes))
    path = str(tmp_path_factory.mktemp("cli") / "mini.zip")
    with JaxZarrZipWriter(path) as w:
        w.create_group("pressure")
        w.write_array("pressure/train", snaps[:8])
        w.write_array("pressure/valid", snaps[8:12])
        w.write_array("pressure/test", snaps[12:])
        w.set_attrs("", {})
    return path


def metrics_line(text: str) -> dict:
    line = next(ln for ln in text.splitlines() if ln.startswith("test_loss:"))
    return {k: float(v) for k, v in re.findall(r"(\w[\w.]*): (-?[\d.]+) \+/-", line)
            if not k.startswith(TIMING)}


def test_cli_train_and_eval_over_a_mesh(store, tmp_path, capfd):
    ck = str(tmp_path / "ck")
    train = ["train", "--model", "gatres_small", "--dataset_paths", store, "--input_paths", INP,
             "--batch_size", "4", "--mask_rate", "0.5", "--save_path", ck, "--variant", "m",
             "--device", "cpu"]
    assert pcli.main(train + ["--epochs", "1", "--mesh", "1,2"]) == 0
    out = capfd.readouterr().out
    assert "mesh 1×2 (graphs strategy, backend gloo)" in out
    assert sorted(os.listdir(ck)) == ["best_gatres_small_m.ckpt", "last_gatres_small_m.ckpt"]
    assert pcli.main(train + ["--epochs", "2", "--mesh", "2,1", "--model_path",
                              f"{ck}/last_gatres_small_m.ckpt"]) == 0
    assert "continuing at 2" in capfd.readouterr().out
    from gnn_pressure_estimation_tpu_torch.train import load_checkpoint

    assert load_checkpoint(f"{ck}/last_gatres_small_m.ckpt")[2]["epoch"] == 2
    ev = ["eval", "--model", "gatres_small", "--model_path", f"{ck}/best_gatres_small_m.ckpt",
          "--test_data_path", store, "--test_input_path", INP, "--num_test_trials", "2",
          "--batch_size", "4", "--mask_rate", "0.5", "--device", "cpu", "--gpu_warmup_times", "0",
          "--agg_mode", "banded"]
    assert pcli.main(ev) == 0
    single = metrics_line(capfd.readouterr().out)
    assert pcli.main(ev + ["--mesh", "1,2"]) == 0
    out = capfd.readouterr().out
    assert "mesh eval 1×2 (backend gloo)" in out
    mesh = metrics_line(out)
    assert mesh.keys() == single.keys() and len(single) >= 8
    for k in single:
        assert abs(mesh[k] - single[k]) <= 1e-4 + 1e-4 * abs(single[k]), (k, mesh[k], single[k])
    # the same training joined from outside: two processes, --distributed
    import subprocess
    import sys

    from gnn_pressure_estimation_tpu_torch.parallel.launch import free_port

    cmd = [sys.executable, "-m", "gnn_pressure_estimation_tpu_torch.cli"] + train + [
        "--epochs", "1", "--save_path", str(tmp_path / "dist"), "--distributed", "--coordinator",
        f"127.0.0.1:{free_port()}", "--num_processes", "2", "--mesh", "1,2"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(cmd + ["--process_id", str(i)], env=env) for i in range(2)]
    try:
        assert [p.wait(timeout=240) for p in procs] == [0, 0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    out = capfd.readouterr().out
    assert "rank 0/2: backend gloo (CPU ranks)" in out and "rank 1/2: backend gloo" in out
    assert sorted(os.listdir(tmp_path / "dist")) == ["best_gatres_small_m.ckpt",
                                                     "last_gatres_small_m.ckpt"]


def test_cli_mesh_failure_exits_nonzero(tmp_path, capfd):
    """A rank that fails (here: a dataset that does not exist) ends the
    launch with a non-zero code; the other rank is stopped."""
    code = pcli.main(["train", "--model", "gatres_small", "--dataset_paths",
                      str(tmp_path / "none.zip"), "--input_paths", INP, "--epochs", "1",
                      "--save_path", str(tmp_path / "ck"), "--device", "cpu", "--mesh", "1,2"])
    assert code not in (0, None)
    assert "a rank exited with" in capfd.readouterr().err
