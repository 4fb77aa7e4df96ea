"""PyTorch port: the solver oracles (``simgen/solver_certify.py``, the
first-principles certificates, and ``simgen/solver_root.py``, the dense
scipy root engine) against the JAX package's, on the cases of
``tests/test_solver_oracle.py``.

- Every ``Certificate`` field of the port equals the JAX one, to the bit,
  on the same network and the same solution: the two modules evaluate the
  same formulas with the same numpy on network states that are equal (as
  ``tests/test_torch_solver.py`` holds them).
- The port's GGA solutions (``solver_py``, and ``solver_cpp`` on three
  randomized networks) pass the port's certificates at the JAX test's
  tolerances: mass < 1e-4 cfs (1e-3 for the PBV), energy < 2e-3 ft,
  setting < 1e-3, no status violation.
- The port's root engine gives the JAX engine's heads and flows (both run
  ``scipy.optimize.root`` from the same start on the same residuals; held
  to rtol 1e-12, atol 1e-9) and agrees with the GGA solve at the JAX
  test's tolerances (heads rtol 1e-6 / atol 2e-3, flows rtol 1e-4 /
  atol 2e-3).
- The five analytic fixtures: the port's ``solve`` against the published
  formulas, as the JAX test holds the JAX one.

The network texts come from ``tests/test_solver_cpp.py``'s builders.
"""

import dataclasses

import numpy as np
import pytest

from gnn_pressure_estimation_tpu.data.inp import parse_inp as jax_parse_inp
from gnn_pressure_estimation_tpu.simgen import solver_certify as jax_certify
from gnn_pressure_estimation_tpu.simgen import solver_root as jax_root
from gnn_pressure_estimation_tpu.simgen.network_state import build_state as jax_build_state
from gnn_pressure_estimation_tpu_torch.data.inp import parse_inp
from gnn_pressure_estimation_tpu_torch.simgen import solver_certify, solver_cpp, solver_py, solver_root
from gnn_pressure_estimation_tpu_torch.simgen.network_state import ACTIVE, build_state
from gnn_pressure_estimation_tpu_torch.simgen.solver_api import solve as api_solve
from test_solver_cpp import _bridge_net, _valve_net, make_random_net

FT_PER_M = 1.0 / 0.3048
CFS_PER_GPM = 1.0 / 448.831
CFS_PER_LPS = 0.035314666721489
PSI_PER_FT = 0.4333


def _tight(ns, accuracy=1e-9, trials=400):
    ns.accuracy = accuracy
    ns.trials = trials
    return ns


def _hw_headloss_ft(L_ft, d_ft, C, q_cfs):
    return 4.727 * L_ft / (C**1.852 * d_ft**4.871) * q_cfs**1.852


def _random_txt(seed, **kw):
    return make_random_net(np.random.default_rng(seed), **kw)


def _valve_txt(vtype, setting):
    if vtype in ("PRV", "TCV"):
        return _valve_net(vtype, setting)
    if vtype == "PSV":
        return _bridge_net("PSV", setting, d1=100.0, l1=1000.0)
    return _bridge_net(vtype, setting)


MULTI_RESERVOIR = """
[JUNCTIONS]
 N1 0 6
[RESERVOIRS]
 R1 60
 R2 40
[PIPES]
 P1 R1 N1 400 250 120 0 Open
 P2 R2 N1 400 250 120 0 Open
[OPTIONS]
 UNITS LPS
 HEADLOSS H-W
[TIMES]
 DURATION 0
[END]
"""

CHEZY_MANNING = """
[JUNCTIONS]
 N1 2 3
 N2 0 5
[RESERVOIRS]
 R1 45
[PIPES]
 P1 R1 N1 400 300 0.013 0 Open
 P2 N1 N2 300 250 0.015 0 Open
 P3 R1 N2 500 200 0.013 0 Open
[OPTIONS]
 UNITS LPS
 HEADLOSS C-M
[TIMES]
 DURATION 0
[END]
"""

ANALYTIC = {
    "single pipe gpm": """
[JUNCTIONS]
 N1 0 500
[RESERVOIRS]
 R1 100
[PIPES]
 P1 R1 N1 1000 12 100 0 Open
[OPTIONS]
 UNITS GPM
 HEADLOSS H-W
[TIMES]
 DURATION 0
[END]
""",
    "single pipe lps": """
[JUNCTIONS]
 N1 0 31.5
[RESERVOIRS]
 R1 30.5
[PIPES]
 P1 R1 N1 305 300 100 0 Open
[OPTIONS]
 UNITS LPS
 HEADLOSS H-W
[TIMES]
 DURATION 0
[END]
""",
    "parallel and series": """
[JUNCTIONS]
 N1 0 0
 N2 0 800
[RESERVOIRS]
 R1 120
[PIPES]
 PA R1 N1 800 10 110 0 Open
 PB R1 N1 800 10 110 0 Open
 PC N1 N2 600 10 110 0 Open
[OPTIONS]
 UNITS GPM
 HEADLOSS H-W
[TIMES]
 DURATION 0
[END]
""",
    "pump one-point curve": """
[JUNCTIONS]
 N1 0 600
[RESERVOIRS]
 R1 50
[PUMPS]
 PU1 R1 N1 HEAD C1
[CURVES]
 C1 600 90
[OPTIONS]
 UNITS GPM
 HEADLOSS H-W
[TIMES]
 DURATION 0
[END]
""",
    "pump three-point curve": """
[JUNCTIONS]
 N1 0 30
[RESERVOIRS]
 R1 20
[PUMPS]
 PU1 R1 N1 HEAD C1
[CURVES]
 C1 0 70
 C1 30 55
 C1 60 20
[OPTIONS]
 UNITS LPS
 HEADLOSS H-W
[TIMES]
 DURATION 0
[END]
""",
}


@dataclasses.dataclass
class Case:
    txt: str
    tight: bool = True
    accuracy: float = None          # after _tight (the PBV's realistic accuracy)
    mass_tol: float = 1e-4
    full: bool = True               # the full certificate (the infeasible FCV: mass only)


def _dw_txt():
    return _random_txt(7, with_pump=False, with_valve=False).replace("HEADLOSS H-W",
                                                                      "HEADLOSS D-W")


CERT_CASES = {
    **{f"randomized-{s}": Case(_random_txt(s, with_pump=s % 2 == 0, with_tank=s % 3 != 2,
                                           with_valve=s != 1)) for s in range(6)},
    **{f"active-{v}": Case(_valve_txt(v, st), accuracy=1e-4 if v == "PBV" else None,
                           mass_tol=1e-3 if v == "PBV" else 1e-4)
       for v, st in (("PRV", 40.0), ("PSV", 40.0), ("FCV", 3.0), ("TCV", 12.0), ("PBV", 5.0))},
    "infeasible-FCV": Case(_valve_net("FCV", 4.0), tight=False, full=False),
    "multi-reservoir": Case(MULTI_RESERVOIR),
    "darcy-weisbach": Case(_dw_txt()),
    "chezy-manning": Case(CHEZY_MANNING),
    **{f"analytic-{k}": Case(t) for k, t in ANALYTIC.items()},
}

ROOT_CASES = {
    **{f"randomized-{s}": Case(_random_txt(s, with_pump=s % 2 == 0, with_valve=s != 1))
       for s in range(4)},
    **{f"active-{v}": CERT_CASES[f"active-{v}"] for v in ("PRV", "PSV", "FCV", "PBV")},
    "multi-reservoir": CERT_CASES["multi-reservoir"],
    "darcy-weisbach": CERT_CASES["darcy-weisbach"],
    "chezy-manning": CERT_CASES["chezy-manning"],
}


def states(case: Case):
    """The port's and the JAX package's network state of the case."""
    out = []
    for parse, build in ((parse_inp, build_state), (jax_parse_inp, jax_build_state)):
        ns = build(parse(case.txt))
        if case.tight:
            _tight(ns)
        if case.accuracy is not None:
            ns.accuracy = case.accuracy
        out.append(ns)
    return out


def _certify_passes(ns, raw, case):
    cert = solver_certify.certify(ns, raw.head, raw.flow, raw.status)
    assert cert.mass < case.mass_tol, f"mass balance violated: {cert.mass} cfs"
    if case.full:
        assert cert.status_ok, cert.violations
        assert cert.energy < 2e-3, f"energy equation violated: {cert.energy} ft"
        assert cert.setting < 1e-3, f"valve setting violated: {cert.setting}"
    return cert


def _same_certificate(cert, jcert):
    for f in dataclasses.fields(jcert):
        assert getattr(cert, f.name) == getattr(jcert, f.name), f.name


@pytest.mark.parametrize("name", sorted(CERT_CASES))
def test_certificates_match_jax_and_pass(name):
    case = CERT_CASES[name]
    ns, jns = states(case)
    raw = solver_py.solve(ns)
    assert raw.converged
    cert = _certify_passes(ns, raw, case)
    _same_certificate(cert, jax_certify.certify(jns, raw.head, raw.flow, raw.status))
    if name.startswith("active-") and name != "active-TCV":
        assert raw.status[np.where(ns.link_type == 2)[0][0]] == ACTIVE
    if name == "infeasible-FCV":
        vi = np.where(ns.link_type == 2)[0][0]
        assert raw.head[ns.node1[vi]] - raw.head[ns.node2[vi]] > 1e5
        assert api_solve(ns, backend="py").warn_code == 6


def test_link_formulas_match_jax():
    """``pipe_headloss``, ``pump_gain`` and ``valve_loss`` at flows of both
    signs, on every link of a randomized network with a pump and a valve,
    under each headloss model."""
    txt = _random_txt(0, with_pump=True, with_valve=True)
    for model in ("H-W", "D-W", "C-M"):
        ns, jns = states(Case(txt.replace("HEADLOSS H-W", f"HEADLOSS {model}")))
        for li in range(len(ns.link_type)):
            for q in (-0.7, 1e-7, 0.35, 2.5):
                for fn in ("pipe_headloss", "pump_gain"):
                    assert getattr(solver_certify, fn)(ns, li, q) == \
                        getattr(jax_certify, fn)(jns, li, q), (model, li, q, fn)
                assert solver_certify.valve_loss(ns, li, q, 3.0) == \
                    jax_certify.valve_loss(jns, li, q, 3.0)


@pytest.mark.skipif(not solver_cpp.is_available(), reason="libhydraulic not built")
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cpp_solutions_pass_the_certificates(seed):
    case = Case(_random_txt(seed, with_pump=True, with_valve=seed != 1))
    ns, jns = states(case)
    raw = solver_cpp.solve_raw(ns)
    assert raw.converged
    cert = _certify_passes(ns, raw, case)
    _same_certificate(cert, jax_certify.certify(jns, raw.head, raw.flow, raw.status))


@pytest.mark.parametrize("name", sorted(ROOT_CASES))
def test_root_engine_matches_jax_and_the_gga_solve(name):
    case = ROOT_CASES[name]
    ns, jns = states(case)
    raw = solver_py.solve(ns)
    assert raw.converged
    alt = solver_root.solve(ns, raw.status)
    ref = jax_root.solve(jns, raw.status)
    np.testing.assert_allclose(alt.head, ref.head, rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(alt.flow, ref.flow, rtol=1e-12, atol=1e-9)
    assert isinstance(alt, solver_py.SolverResult) and alt.converged
    np.testing.assert_array_equal(alt.status, raw.status)
    np.testing.assert_allclose(alt.head, raw.head, rtol=1e-6, atol=2e-3)
    np.testing.assert_allclose(alt.flow, raw.flow, rtol=1e-4, atol=2e-3)


def _solved(name):
    ns = _tight(build_state(parse_inp(ANALYTIC[name])))
    return ns, api_solve(ns, backend="py")


@pytest.mark.parametrize("name", sorted(ANALYTIC))
def test_analytic_fixtures(name):
    """The published formulas, as ``tests/test_solver_oracle.py`` holds them."""
    ns, res = _solved(name)
    n1 = ns.node_names.index("N1")
    if name == "single pipe gpm":
        h = 100.0 - _hw_headloss_ft(1000.0, 1.0, 100.0, 500.0 * CFS_PER_GPM)
        assert res.head[n1] == pytest.approx(h, abs=2e-4)
        assert res.pressure[n1] == pytest.approx(h * PSI_PER_FT, abs=1e-3)
        assert res.flow[0] == pytest.approx(500.0, rel=1e-6)
    elif name == "single pipe lps":
        h_ft = _hw_headloss_ft(305.0 * FT_PER_M, 0.300 * FT_PER_M, 100.0, 31.5 * CFS_PER_LPS)
        assert res.head[n1] == pytest.approx(30.5 - h_ft / FT_PER_M, abs=1e-4)
        assert res.pressure[n1] == pytest.approx(30.5 - h_ft / FT_PER_M, abs=1e-4)
    elif name == "parallel and series":
        q, d = 800.0 * CFS_PER_GPM, 10.0 / 12.0
        h_par = _hw_headloss_ft(800.0, d, 110.0, q / 2.0)
        h_ser = _hw_headloss_ft(600.0, d, 110.0, q)
        assert res.flow[0] == pytest.approx(400.0, rel=1e-5)
        assert res.flow[1] == pytest.approx(400.0, rel=1e-5)
        assert res.head[n1] == pytest.approx(120.0 - h_par, abs=2e-4)
        assert res.head[ns.node_names.index("N2")] == pytest.approx(120.0 - h_par - h_ser,
                                                                    abs=2e-4)
    elif name == "pump one-point curve":
        assert res.head[n1] == pytest.approx(50.0 + 90.0, abs=1e-3)
        ns2 = _tight(build_state(parse_inp(ANALYTIC[name].replace("N1 0 600", "N1 0 300"))))
        q1 = 600.0 * CFS_PER_GPM
        h0 = 4.0 / 3.0 * 90.0
        gain = h0 - (h0 - 90.0) / q1**2 * (q1 / 2.0) ** 2
        assert api_solve(ns2, backend="py").head[n1] == pytest.approx(50.0 + gain, abs=1e-3)
    else:
        assert res.head[n1] == pytest.approx(20.0 + 55.0, abs=1e-3)
