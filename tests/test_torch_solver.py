"""PyTorch port: the hydraulic solver copy (``simgen``: units, network
state, the NumPy and C++ solvers, ``solve``) and the online-simulation
dataset ``NoisyWDNDataset`` against the JAX package's, on minitown and
synthctown."""

import dataclasses

import numpy as np
import pytest

from gnn_pressure_estimation_tpu.data.inp import parse_inp as jax_parse_inp
from gnn_pressure_estimation_tpu.data.noisy import NoisyWDNDataset as JaxNoisy
from gnn_pressure_estimation_tpu.simgen import units as jax_units
from gnn_pressure_estimation_tpu.simgen.network_state import build_state as jax_build_state
from gnn_pressure_estimation_tpu.simgen.solver_api import solve as jax_solve
from gnn_pressure_estimation_tpu.utils.scaling import NormStats as JaxNormStats
from gnn_pressure_estimation_tpu_torch.data.inp import parse_inp
from gnn_pressure_estimation_tpu_torch.data.noisy import NoisyWDNDataset
from gnn_pressure_estimation_tpu_torch.simgen import solver_api, solver_cpp, units
from gnn_pressure_estimation_tpu_torch.simgen.network_state import build_state
from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats

NETWORKS = ["inputs/minitown.inp", "inputs/synthctown.inp"]


@pytest.mark.parametrize("inp", NETWORKS)
def test_build_state_matches_jax(inp):
    ns, jns = build_state(parse_inp(inp)), jax_build_state(jax_parse_inp(inp))
    for f in dataclasses.fields(jns):
        a, b = getattr(ns, f.name), getattr(jns, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    c = ns.clone()
    c.demand[0] += 1.0
    assert c.demand[0] != ns.demand[0]


@pytest.mark.parametrize("inp", NETWORKS)
@pytest.mark.parametrize("backend", ["cpp", "py"])
def test_solve_matches_jax(inp, backend):
    """Same demands (perturbed), same backend: the same results. The C++
    solver is the same source built with the same flags on this host, so it
    agrees bit for bit; the NumPy solver too."""
    ns, jns = build_state(parse_inp(inp)), jax_build_state(jax_parse_inp(inp))
    rng = np.random.default_rng(3)
    scale = 1.0 + 0.2 * rng.standard_normal(ns.n_junctions)
    ns.demand[:ns.n_junctions] *= scale
    jns.demand[:jns.n_junctions] *= scale
    res, ref = solver_api.solve(ns, backend=backend), jax_solve(jns, backend=backend)
    assert res.converged == ref.converged and res.warn_code == ref.warn_code
    assert res.iterations == ref.iterations
    for f in ("head", "pressure", "demand", "flow", "velocity", "status"):
        np.testing.assert_array_equal(getattr(res, f), getattr(ref, f), err_msg=f)


@pytest.mark.parametrize("inp", NETWORKS)
def test_cpp_and_py_solvers_agree(inp):
    ns = build_state(parse_inp(inp))
    a, b = solver_api.solve(ns, backend="cpp"), solver_api.solve(ns, backend="py")
    assert a.converged and b.converged
    np.testing.assert_allclose(a.pressure, b.pressure, atol=1e-3)


def test_solver_builds_outside_the_source_tree():
    """The library goes to the package's ``_build/`` under a name keyed by
    the source, the Makefile and the host's CPU; nothing is built beside the
    source."""
    so = solver_cpp.build()
    assert so.parent == solver_cpp.BUILD_DIR and so.name.startswith("libhydraulic-")
    assert so == solver_cpp.library_path() and so.exists()
    assert sorted(p.name for p in solver_cpp.SRC_DIR.iterdir()) == ["Makefile", "hydraulic.cpp"]
    assert solver_cpp.is_available() and solver_api._resolve_backend() in ("cpp", "py")


def test_units_match_jax():
    v = np.array([0.0, 1.5, 42.0])
    for u in ("GPM", "LPS", "CMH", "MGD"):
        for fn in ("flow_to_cfs", "flow_from_cfs", "length_to_ft", "diameter_to_ft",
                   "pressure_from_ft", "pressure_to_ft", "head_from_ft"):
            np.testing.assert_array_equal(getattr(units, fn)(v, u), getattr(jax_units, fn)(v, u))
        for param in ("pressure", "head", "flow", "velocity"):
            np.testing.assert_array_equal(units.convert_result(v, param, u, "LPS"),
                                          jax_units.convert_result(v, param, u, "LPS"))


@pytest.mark.parametrize("inp", NETWORKS)
@pytest.mark.parametrize("backend", ["cpp", "py"])
@pytest.mark.parametrize("removal", ["keep_junction", "keep_all"])
def test_noisy_dataset_matches_jax(inp, backend, removal):
    stats = dict(norm_type="znorm", mean=40.0, std=12.0)
    kw = dict(removal=removal, mean_dmd=0.05, std_dmd=0.2, seed=11, backend=backend)
    ds = NoisyWDNDataset([inp, inp], stats=NormStats(**stats), **kw)
    jds = JaxNoisy([inp, inp], stats=JaxNormStats(**stats), **kw)
    assert len(ds) == len(jds) == 2
    for m, jm in zip(ds.members, jds.members):
        assert m.array.dtype == np.float32 and m.array.shape == (1, m.template.n_node)
        np.testing.assert_array_equal(m.array, jm.array)
        assert m.kept_names == jm.kept_names
    # the two members drew different noise from the one stream
    assert not np.array_equal(ds.members[0].array, ds.members[1].array)


def test_noisy_scenes_share_templates_and_own_stats():
    shared = {}
    a = NoisyWDNDataset([NETWORKS[0]], seed=1, shared_templates=shared)
    b = NoisyWDNDataset([NETWORKS[0]], seed=2, shared_templates=shared)
    assert a.members[0].template is b.members[0].template and len(shared) == 1
    assert not np.array_equal(a.members[0].array, b.members[0].array)
    # stats=None: computed from the simulated values, as the JAX package does
    j = JaxNoisy([NETWORKS[0]], seed=1)
    assert a.stats == NormStats(**{f: getattr(j.stats, f) for f in
                                   ("norm_type", "mean", "std", "min", "max")})
    with pytest.raises(KeyError, match="unsupported"):
        NoisyWDNDataset([NETWORKS[0]], feature="quality")
