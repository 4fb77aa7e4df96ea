"""PyTorch port, scenario generation end to end against the JAX generator:
``simgen.runner.generate`` on minitown (12 scenarios) gives the same
accepted count, the ``token`` arrays bit for bit and every attribute array
within 1e-6 (m of pressure and head, LPS of demand), with one executor and
with two; regeneration from a stored ``token`` array (``load_params``) and
the ``update_*_json`` injections as in ``test_generation_repro.py``; the
solver backend rule; the debug dump.

With two executors the batches finish in any order, so that run is held
row by row: each stored token row is one the JAX sampler draws for one of
the run's batch seeds, and its attribute rows are what the JAX executor
gives for it.
"""

import configparser
import json
import os
from pathlib import Path

import numpy as np
import pytest

from gnn_pressure_estimation_tpu.data.inp import parse_inp as jax_parse_inp
from gnn_pressure_estimation_tpu.data.zarrzip import ZarrZipReader as JaxReader
from gnn_pressure_estimation_tpu.simgen import config as jcfg
from gnn_pressure_estimation_tpu.simgen import runner as jrun
from gnn_pressure_estimation_tpu.simgen import tokens as jtk
from gnn_pressure_estimation_tpu.simgen.executor import ScenarioExecutor as JaxExecutor
from gnn_pressure_estimation_tpu_torch.data.inp import parse_inp
from gnn_pressure_estimation_tpu_torch.data.zarrzip import ZarrZipReader
from gnn_pressure_estimation_tpu_torch.simgen import runner as prun
from gnn_pressure_estimation_tpu_torch.simgen import solver_api, solver_cpp
from gnn_pressure_estimation_tpu_torch.simgen.config import GenOptions

ROOT = Path(__file__).resolve().parents[1]
MINITOWN = str(ROOT / "inputs" / "minitown.inp")
ATT = ("pressure", "head", "demand")
SPLITS = ("train", "valid", "test")


@pytest.fixture(scope="module")
def ini_dir(tmp_path_factory):
    """A generation INI for minitown from the JAX config creator (12
    scenarios); ``ini(name)`` writes a copy whose store lands in ``name``."""
    d = tmp_path_factory.mktemp("torch_generation")
    base = jcfg.create_dummy_config(MINITOWN, num_scenarios=12)

    def ini(name: str, **general) -> str:
        cp = configparser.ConfigParser()
        cp.read_dict({s: dict(base.items(s)) for s in base.sections()})
        cp.set("general", "storage_dir", str(d / name))
        for k, v in general.items():
            cp.set("general", k, str(v))
        path = str(d / f"{name}.ini")
        with open(path, "w") as f:
            cp.write(f)
        return path

    return ini


def _opts(**kw):
    base = dict(gen_demand=True, gen_res_total_head=True, att=",".join(ATT), batch_size=4,
                executors=1, seed=7)
    base.update(kw)
    return base


def _read(reader_cls, path):
    with reader_cls(path) as r:
        root = r.root()
        out = {"attrs": root.attrs}
        for key in ATT:
            if r.is_group(key):
                out[key] = {s: r.read_array(f"{key}/{s}") for s in SPLITS}
                out[f"{key}_attrs"] = root[key].attrs
        out["token"] = r.read_array("token") if r.is_array("token") else None
    return out


def _generate_both(ini_dir, name, **kw):
    logs = []
    pz = prun.generate(ini_dir(f"p_{name}"), GenOptions(**_opts(**kw)), log_fn=logs.append)
    jz = jrun.generate(ini_dir(f"j_{name}"), jcfg.GenOptions(**_opts(**kw)), log_fn=lambda m: None)
    return _read(ZarrZipReader, pz), _read(JaxReader, jz), logs, pz, jz


def _held_to_jax(got, ref, atol=1e-6):
    for key in ATT:
        for s in SPLITS:
            assert got[key][s].shape == ref[key][s].shape, (key, s)
            np.testing.assert_allclose(got[key][s], ref[key][s], rtol=0, atol=atol,
                                       err_msg=f"{key}/{s}")
        for stat, v in ref[f"{key}_attrs"].items():
            assert got[f"{key}_attrs"][stat] == pytest.approx(v, rel=1e-9, abs=1e-9, nan_ok=True)
    assert got["attrs"]["ordered_names_by_attr"] == ref["attrs"]["ordered_names_by_attr"]


def test_generate_matches_jax_one_executor(ini_dir):
    got, ref, logs, _, _ = _generate_both(ini_dir, "one")
    n = sum(ref["pressure"][s].shape[0] for s in SPLITS)
    assert n == 12 and sum(got["pressure"][s].shape[0] for s in SPLITS) == n
    assert got["token"].dtype == ref["token"].dtype == np.float64
    assert got["token"].tobytes() == ref["token"].tobytes()
    _held_to_jax(got, ref)
    assert got["attrs"]["args"] == ref["attrs"]["args"]
    assert {k: v for k, v in got["attrs"]["config"].items() if k != "general"} == \
           {k: v for k, v in ref["attrs"]["config"].items() if k != "general"}
    assert any(m.startswith("solver backend: ") for m in logs)


def test_generate_two_executors_rows_are_jax_rows(ini_dir):
    """Two worker processes: 12 rows accepted, each token row one that the
    JAX sampler draws for a batch seed of the run, each attribute row the
    JAX executor's solve of it within 1e-6."""
    pz = prun.generate(ini_dir("p_two"), GenOptions(**_opts(executors=2)), log_fn=lambda m: None)
    got = _read(ZarrZipReader, pz)
    tokens = got["token"]
    assert tokens.shape[0] == 12
    jopts = jcfg.GenOptions(**_opts())
    jcp = jcfg.read_config(ini_dir("j_ref"))
    wn = jax_parse_inp(MINITOWN)
    specs = jtk.build_feature_specs(wn, jcp, jopts)
    drawn = {row.tobytes(): row
             for b in range(12 * jopts.oversample_factor // jopts.batch_size)
             for row in jtk.sample_params(specs, jopts.batch_size,
                                          np.random.default_rng(jopts.seed * 1_000_003 + b))}
    assert all(row.tobytes() in drawn for row in tokens)
    out, _, ok = JaxExecutor(wn, specs, jcp, jopts).simulate(tokens)
    np.testing.assert_array_equal(ok, tokens)          # every stored row passes the filters
    for key in ATT:
        stacked = np.concatenate([got[key][s] for s in SPLITS])
        np.testing.assert_allclose(stacked, out[key], rtol=0, atol=1e-6, err_msg=key)


def test_load_params_regenerates_a_jax_store(ini_dir):
    """The port regenerates a JAX store from its ``token`` array: the same
    rows, arrays within 1e-6; and a port store regenerates to itself byte
    for byte."""
    _, ref, _, pz, jz = _generate_both(ini_dir, "lp_src", seed=3)
    regen = _read(ZarrZipReader, prun.generate(
        ini_dir("p_lp_jax"), GenOptions(**_opts(load_params=jz, seed=999)), log_fn=lambda m: None))
    assert regen["token"].tobytes() == ref["token"].tobytes()
    _held_to_jax(regen, ref)
    assert prun.load_computed_params(jz).tobytes() == jrun.load_computed_params(jz).tobytes()
    own = _read(ZarrZipReader, pz)
    again = _read(ZarrZipReader, prun.generate(
        ini_dir("p_lp_own"), GenOptions(**_opts(load_params=pz)), log_fn=lambda m: None))
    for key in ATT:
        for s in SPLITS:
            assert again[key][s].tobytes() == own[key][s].tobytes()
    assert again["token"].tobytes() == own["token"].tobytes()


def test_update_json_injection_matches_jax(ini_dir, tmp_path):
    """A demand pinned by ``update_demand_json`` (inline) and a reservoir head
    by ``update_res_total_head_json`` (from a file): the same token rows as
    JAX's, the pinned demand comes out of the solve, arrays within 1e-6."""
    wn = parse_inp(MINITOWN)
    uid, res = wn.junctions[0].id, wn.reservoirs[0].id
    head_file = tmp_path / "head.json"
    head_file.write_text(json.dumps({res: 60.0}))
    inj = dict(update_demand_json=json.dumps({uid: 1.75}),
               update_res_total_head_json=f"@{head_file}")
    got, ref, _, _, _ = _generate_both(ini_dir, "inj", **inj)
    assert got["token"].tobytes() == ref["token"].tobytes()
    col = wn.junction_names.index(uid)
    np.testing.assert_allclose(got["token"][:, col], 1.75)
    np.testing.assert_allclose(got["token"][:, -1], 60.0)
    _held_to_jax(got, ref)
    names = got["attrs"]["ordered_names_by_attr"]["demand"]
    demand = np.concatenate([got["demand"][s] for s in SPLITS])
    np.testing.assert_allclose(demand[:, names.index(uid)], 1.75, rtol=1e-6)


def test_load_params_composes_with_injection_like_jax(ini_dir):
    wn = parse_inp(MINITOWN)
    uid = wn.junctions[1].id
    _, _, _, pz, jz = _generate_both(ini_dir, "lpi_src")
    kw = dict(update_demand_json=json.dumps({uid: 2.5}))
    got, ref, _, _, _ = _generate_both(ini_dir, "lpi", load_params=jz, **kw)
    assert got["token"].tobytes() == ref["token"].tobytes()
    col = wn.junction_names.index(uid)
    np.testing.assert_allclose(got["token"][:, col], 2.5)
    src = prun.load_computed_params(pz)
    other = [c for c in range(src.shape[1]) if c != col]
    np.testing.assert_array_equal(got["token"][:, other], src[:, other])
    _held_to_jax(got, ref)


def test_cpp_backend_asked_for_raises_when_the_build_fails(ini_dir, monkeypatch):
    """``backend="cpp"`` never falls back to the NumPy solver: a failed build
    raises before any scenario runs, and no store is written."""
    def failed_build():
        raise RuntimeError("hydraulic solver build failed (make exit 2)")

    monkeypatch.setattr(solver_cpp, "build", failed_build)
    ini = ini_dir("p_nocpp")
    with pytest.raises(RuntimeError, match="build failed"):
        prun.generate(ini, GenOptions(**_opts(backend="cpp")), log_fn=lambda m: None)
    assert not os.path.exists(jcfg.read_config(ini).get("general", "storage_dir") + ".zip")


def test_automatic_backend_says_when_it_falls_back(ini_dir, monkeypatch):
    """With no backend asked for and no C++ solver, generation runs the NumPy
    solver and says so; the arrays still agree with the C++ run within 1e-6."""
    monkeypatch.setitem(solver_api._BACKEND, "impl", "py")
    logs = []
    pz = prun.generate(ini_dir("p_auto_py"), GenOptions(**_opts()), log_fn=logs.append)
    assert "solver backend: py (the C++ solver did not build; NumPy solver)" in logs
    py = _read(ZarrZipReader, pz)
    monkeypatch.setitem(solver_api._BACKEND, "impl", None)
    logs = []
    cz = prun.generate(ini_dir("p_auto_cpp"), GenOptions(**_opts(backend="cpp")), log_fn=logs.append)
    assert "solver backend: cpp" in logs
    cpp = _read(ZarrZipReader, cz)
    assert py["token"].tobytes() == cpp["token"].tobytes()
    for key in ATT:
        for s in SPLITS:
            np.testing.assert_allclose(py[key][s], cpp[key][s], rtol=0, atol=1e-6)


def test_no_gen_flags_raises(ini_dir):
    with pytest.raises(ValueError, match="nothing to randomize"):
        prun.generate(ini_dir("p_none"), GenOptions(att="pressure"), log_fn=lambda m: None)


def test_debug_dump_renders(ini_dir):
    ini = ini_dir("p_dbg", num_scenarios=16)
    logs = []
    prun.generate(ini, GenOptions(**_opts(debug=True)), log_fn=logs.append)
    store = jcfg.read_config(ini).get("general", "storage_dir")
    assert os.path.exists(store + "_debug.png")
    assert any("hist10" in ln for ln in logs) and any("feat_corr" in ln for ln in logs)
