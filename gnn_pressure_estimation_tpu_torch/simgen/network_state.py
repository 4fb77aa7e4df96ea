"""WaterNetwork → flat solver arrays in EPANET internal units (ft, cfs).

This is the boundary between the INP/object world and the numeric solvers
(NumPy reference and the C++ component). A :class:`NetworkState` is mutable:
the scenario executor overwrites demands/elevations/roughness/etc. per token
vector (reference Executorv7.py:204-315 does the same through EN_set* ctypes
calls) and re-solves without re-parsing anything.

A copy of ``gnn_pressure_estimation_tpu/simgen/network_state.py`` over the
port's own ``data/inp.py``, kept here so the PyTorch package imports nothing
of the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from gnn_pressure_estimation_tpu_torch.data import inp as inp_mod
from gnn_pressure_estimation_tpu_torch.simgen import units as U

# link status codes (solver contract)
CLOSED, OPEN, ACTIVE = 0, 1, 2
# valve type codes
VALVE_CODE = {"PRV": 0, "PSV": 1, "PBV": 2, "FCV": 3, "TCV": 4, "GPV": 5}
HEADLOSS_CODE = {"H-W": 0, "D-W": 1, "C-M": 2}


@dataclasses.dataclass
class NetworkState:
    """Flat arrays; node order = canonical (junctions, reservoirs, tanks),
    link order = (pipes, pumps, valves) — see data/inp.py."""

    units: str
    headloss_model: int
    n_junctions: int
    n_nodes: int
    node_names: list
    link_names: list
    # nodes
    elevation: np.ndarray      # [n_nodes] ft (junction elevation; res/tank base)
    fixed_head: np.ndarray     # [n_nodes] ft hydraulic grade for non-junctions
    demand: np.ndarray         # [n_nodes] cfs (zero for non-junctions)
    # links
    link_type: np.ndarray      # [L] 0 pipe / 1 pump / 2 valve
    node1: np.ndarray
    node2: np.ndarray
    status: np.ndarray         # [L] CLOSED/OPEN/ACTIVE initial status
    check_valve: np.ndarray    # [L] bool
    length: np.ndarray         # ft
    diameter: np.ndarray       # ft
    roughness: np.ndarray      # HW C / DW ft / CM n
    minor_loss: np.ndarray     # K coefficient
    # pumps (aligned to links; zero elsewhere)
    pump_h0: np.ndarray        # shutoff head ft (speed 1)
    pump_r: np.ndarray         # curve resistance
    pump_n: np.ndarray         # curve exponent
    pump_speed: np.ndarray
    pump_power: np.ndarray     # horsepower-equivalent (ft·cfs basis), 0 = curve
    # valves
    valve_type: np.ndarray     # [L] code or -1
    valve_setting: np.ndarray  # ft (PRV/PSV/PBV), cfs (FCV), K (TCV)
    # solver options
    trials: int = 200
    accuracy: float = 0.001
    viscosity: float = 1.1e-5  # ft^2/s kinematic (water 20C, EPANET VISCOS)

    def clone(self) -> "NetworkState":
        out = dataclasses.replace(self)
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, np.ndarray):
                setattr(out, f.name, v.copy())
        return out


def _pump_curve_params(points: list, pump_id: str) -> tuple[float, float, float]:
    """EPANET pump-curve fitting (epanet.c getpumpparams / updatepumpparams):
    1-point curve (q1,h1): h0 = 4/3 h1, qmax = 2 q1  →  h = h0 − r·q^n with
    n = 2, r = (h0−h1)/q1².  3-point: n = ln((h0−h1)/(h0−h2)) / ln(q1/q2),
    r = (h0−h1)/q1^n.  ≥4 points: least-squares fit through the same form
    using first/mid/last (EPANET uses piecewise-linear custom curves; the
    monotone 3-point fit is our single-period approximation)."""
    pts = sorted(points)
    if len(pts) == 1:
        q1, h1 = pts[0]
        h0 = 4.0 / 3.0 * h1
        if q1 <= 0:
            return h1, 0.0, 1.0
        return h0, (h0 - h1) / (q1**2), 2.0
    if len(pts) >= 3:
        if len(pts) > 3:
            pts = [pts[0], pts[len(pts) // 2], pts[-1]]
        (q0, h0), (q1, h1), (q2, h2) = pts
        if q0 != 0.0 or h0 <= h1 or h1 <= h2 or q1 <= 0 or q2 <= q1:
            raise ValueError(f"pump {pump_id}: invalid head curve {pts}")
        n = math.log((h0 - h1) / (h0 - h2)) / math.log(q1 / q2)
        r = (h0 - h1) / (q1**n)
        return h0, r, n
    # 2 points: fit through both with n=2 if first not at q=0
    (q1, h1), (q2, h2) = pts
    if q1 == 0.0:
        h0 = h1
        n = 2.0
        r = (h0 - h2) / (q2**n)
        return h0, r, n
    raise ValueError(f"pump {pump_id}: unsupported 2-point curve {pts}")


def build_state(wn: inp_mod.WaterNetwork) -> NetworkState:
    units = wn.options.units.upper()
    hl = HEADLOSS_CODE.get(wn.options.headloss.upper().replace("HW", "H-W"), 0)
    nj, nr, nt = len(wn.junctions), len(wn.reservoirs), len(wn.tanks)
    n_nodes = nj + nr + nt
    L = wn.n_links

    elevation = np.zeros(n_nodes)
    fixed_head = np.zeros(n_nodes)
    demand = np.zeros(n_nodes)

    dm = wn.options.demand_multiplier
    for i, j in enumerate(wn.junctions):
        elevation[i] = U.length_to_ft(j.elevation, units)
        base = 0.0
        cats = j.demand_categories if j.demand_categories else [(j.base_demand, j.pattern)]
        for b, pat in cats:
            mult = wn.get_pattern(pat)[0] if pat else 1.0
            base += b * mult
        demand[i] = U.flow_to_cfs(base * dm, units)
    for i, r in enumerate(wn.reservoirs):
        gi = nj + i
        mult = wn.get_pattern(r.pattern)[0] if r.pattern else 1.0
        elevation[gi] = U.length_to_ft(r.head, units)
        fixed_head[gi] = U.length_to_ft(r.head * mult, units)
    for i, t in enumerate(wn.tanks):
        gi = nj + nr + i
        elevation[gi] = U.length_to_ft(t.elevation, units)
        fixed_head[gi] = U.length_to_ft(t.elevation + t.init_level, units)

    node1, node2, link_type = wn.link_endpoints()
    status = np.full(L, OPEN, np.int32)
    check_valve = np.zeros(L, bool)
    length = np.zeros(L)
    diameter = np.zeros(L)
    roughness = np.zeros(L)
    minor_loss = np.zeros(L)
    pump_h0 = np.zeros(L)
    pump_r = np.zeros(L)
    pump_n = np.ones(L)
    pump_speed = np.ones(L)
    pump_power = np.zeros(L)
    valve_type = np.full(L, -1, np.int32)
    valve_setting = np.zeros(L)

    np_pipes = len(wn.pipes)
    np_pumps = len(wn.pumps)
    for i, p in enumerate(wn.pipes):
        length[i] = U.length_to_ft(p.length, units)
        diameter[i] = U.diameter_to_ft(p.diameter, units)
        if hl == 1:
            roughness[i] = U.dw_rough_to_ft(p.roughness, units)
        else:
            roughness[i] = p.roughness
        minor_loss[i] = p.minor_loss
        st = p.status.upper()
        if st == "CLOSED":
            status[i] = CLOSED
        elif st == "CV":
            check_valve[i] = True
    for i, p in enumerate(wn.pumps):
        li = np_pipes + i
        pump_speed[li] = p.speed
        status[li] = CLOSED if p.status.upper() == "CLOSED" else OPEN
        if p.power is not None:
            # INP power in kW (SI) or hp (US); internal h = Y/q with
            # Y = 8.814·hp (ft·cfs). kW → hp: /0.7457.
            hp = p.power if U.is_us(units) else p.power / 0.7457
            pump_power[li] = hp
        elif p.head_curve is not None:
            pts = wn.curves.get(p.head_curve)
            if not pts:
                raise ValueError(f"pump {p.id}: head curve {p.head_curve} missing")
            pts_ft = [
                (float(U.flow_to_cfs(q, units)), float(U.length_to_ft(h, units)))
                for q, h in pts
            ]
            h0, r, n = _pump_curve_params(pts_ft, p.id)
            pump_h0[li], pump_r[li], pump_n[li] = h0, r, n
        else:
            raise ValueError(f"pump {p.id}: needs HEAD curve or POWER")
    for i, v in enumerate(wn.valves):
        li = np_pipes + np_pumps + i
        diameter[li] = U.diameter_to_ft(v.diameter, units)
        minor_loss[li] = v.minor_loss
        vt = VALVE_CODE[v.valve_type.upper()]
        valve_type[li] = vt
        st = v.status.upper()
        status[li] = {"CLOSED": CLOSED, "OPEN": OPEN, "ACTIVE": ACTIVE}.get(st, ACTIVE)
        if vt in (0, 1, 2):
            # PRV/PSV/PBV settings are PRESSURES — psi in US unit systems
            # (÷0.4333 → ft), meters of head in SI.  (Was length_to_ft,
            # which is a no-op on US systems: a real unit bug surfaced by
            # the hand-derived external anchor, tests/test_solver_external.)
            valve_setting[li] = U.pressure_to_ft(v.setting, units)
        elif vt == 3:  # FCV: flow
            valve_setting[li] = U.flow_to_cfs(v.setting, units)
        else:  # TCV loss coeff, GPV curve id (unsupported → K)
            valve_setting[li] = v.setting

    visc_rel = wn.options.viscosity if wn.options.viscosity > 0 else 1.0

    return NetworkState(
        units=units,
        headloss_model=hl,
        n_junctions=nj,
        n_nodes=n_nodes,
        node_names=wn.node_names,
        link_names=wn.link_names,
        elevation=elevation,
        fixed_head=fixed_head,
        demand=demand,
        link_type=link_type.astype(np.int32),
        node1=node1.astype(np.int32),
        node2=node2.astype(np.int32),
        status=status,
        check_valve=check_valve,
        length=length,
        diameter=diameter,
        roughness=roughness,
        minor_loss=minor_loss,
        pump_h0=pump_h0,
        pump_r=pump_r,
        pump_n=pump_n,
        pump_speed=pump_speed,
        pump_power=pump_power,
        valve_type=valve_type,
        valve_setting=valve_setting,
        trials=wn.options.trials,
        accuracy=wn.options.accuracy,
        viscosity=1.1e-5 * visc_rel,
    )
