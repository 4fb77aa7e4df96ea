"""First-principles solution certificates for hydraulic solves.

Both in-repo engines (``solver_py``, ``solver/hydraulic.cpp``) are Global
Gradient Algorithm implementations, so a semantic error shared by the pair
would be invisible to their cross-check (EPANET and wntr are not installed,
so no externally produced numbers exist to compare against). This module attacks that gap from the physics side: given a
:class:`~.network_state.NetworkState` and a raw solver result, it evaluates
the *defining equations* of the steady-state hydraulic problem directly —

- mass balance at every junction (Kirchhoff current law),
- the energy equation along every conducting link (Hazen-Williams /
  Darcy-Weisbach / Chezy-Manning headloss, pump head gain, valve minor loss),
- the control-constraint of every ACTIVE valve (PRV/PSV hold a head,
  FCV holds a flow, PBV holds a drop, TCV throttles),
- status consistency (closed links carry no flow; check valves never flow
  backward; a closed pump's required lift exceeds its shutoff head).

No GGA machinery is involved: the checks are straight evaluations of the
published formulas (EPANET 2.2 manual, eqs. in hydcoeffs.c terms), so they
certify a solution independently of how it was produced. Semantics source in
the reference: generator/EPYNET/Executorv7.py:325-424 (solve + plausibility).

A copy of ``gnn_pressure_estimation_tpu/simgen/solver_certify.py`` on the
port's ``network_state``, kept here so the PyTorch package imports nothing
of the JAX package. Nothing on the training or serving path calls it: it is
an oracle that certifies a solve.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gnn_pressure_estimation_tpu_torch.simgen.network_state import (
    ACTIVE,
    CLOSED,
    OPEN,
    NetworkState,
)

HW_EXP = 1.852
GRAV2 = 64.4
PRV, PSV, PBV, FCV, TCV, GPV = range(6)


@dataclasses.dataclass
class Certificate:
    """Max-norm residuals of the defining equations (ft / cfs)."""

    mass: float          # max junction mass-balance violation, cfs
    energy: float        # max conducting-link energy-equation violation, ft
    setting: float       # max ACTIVE-valve control-constraint violation
    status_ok: bool      # closed/CV/pump status consistency
    violations: list     # human-readable list of status violations

    def ok(self, mass_tol: float, energy_tol: float, setting_tol: float) -> bool:
        return (
            self.mass <= mass_tol
            and self.energy <= energy_tol
            and self.setting <= setting_tol
            and self.status_ok
        )


def _friction_factor(d, e, q, viscosity):
    """Swamee-Jain / laminar friction factor (published formula, evaluated
    directly — matches the EPANET manual's D-W description)."""
    d = max(d, 1e-6)
    Re = max(4.0 * abs(q) / (np.pi * d * viscosity), 1.0)
    if Re < 2000.0:
        return 64.0 / Re
    arg = e / (3.7 * d) + 5.74 / Re**0.9
    f_turb = 0.25 / np.log10(arg) ** 2
    if Re > 4000.0:
        return f_turb
    x = (Re - 2000.0) / 2000.0
    blend = x * x * (3.0 - 2.0 * x)
    f_lo = 64.0 / 2000.0
    arg4 = e / (3.7 * d) + 5.74 / 4000.0**0.9
    f_hi = 0.25 / np.log10(arg4) ** 2
    return f_lo + blend * (f_hi - f_lo)


def pipe_headloss(ns: NetworkState, li: int, q: float) -> float:
    """Signed headloss H(node1) − H(node2) through pipe ``li`` at flow ``q``
    (ft, cfs). Direct evaluation of the headloss formula for the network's
    model plus the minor-loss term."""
    L, d, c = ns.length[li], max(ns.diameter[li], 1e-6), ns.roughness[li]
    aq = abs(q)
    if ns.headloss_model == 0:      # Hazen-Williams
        r = 4.727 * L / max(c, 1e-6) ** HW_EXP / d**4.871
        hl = r * aq**HW_EXP
    elif ns.headloss_model == 2:    # Chezy-Manning
        A = np.pi * d**2 / 4.0
        r = L * (c / 1.49) ** 2 / (A**2 * (d / 4.0) ** (4.0 / 3.0))
        hl = r * aq**2
    else:                            # Darcy-Weisbach
        A = np.pi * d**2 / 4.0
        f = _friction_factor(d, c, q, ns.viscosity)
        hl = f * L / (GRAV2 * d * A**2) * aq**2
    m = 0.02517 * ns.minor_loss[li] / d**4
    return float(np.sign(q) * (hl + m * aq**2))


def pump_gain(ns: NetworkState, li: int, q: float) -> float:
    """Head added by pump ``li`` at flow ``q`` (curve or constant power)."""
    w = ns.pump_speed[li]
    qa = max(q, 1e-6)
    if ns.pump_power[li] > 0:
        return float(8.814 * ns.pump_power[li] / qa)
    return float(ns.pump_h0[li] * w * w - ns.pump_r[li] * w ** (2.0 - ns.pump_n[li]) * qa ** ns.pump_n[li])


def valve_loss(ns: NetworkState, li: int, q: float, K: float) -> float:
    """Minor-loss h = sign(q)·0.02517·K·q²/d⁴ through an open/throttling valve."""
    d = max(ns.diameter[li], 1e-6)
    return float(np.sign(q) * 0.02517 * K / d**4 * q * q)


def certify(
    ns: NetworkState,
    head: np.ndarray,
    flow: np.ndarray,
    status: np.ndarray,
    q_tol: float = 5e-3,
) -> Certificate:
    """Evaluate all defining-equation residuals for a (head, flow, status)
    solution in solver-internal units (ft, cfs)."""
    nj = ns.n_junctions
    n1, n2 = ns.node1, ns.node2
    L = len(ns.link_type)

    # ---- mass balance (junctions) -------------------------------------
    net = np.zeros(ns.n_nodes)
    np.add.at(net, n2, flow)
    np.add.at(net, n1, -flow)
    mass = float(np.max(np.abs(net[:nj] - ns.demand[:nj]))) if nj else 0.0

    # ---- per-link energy / control / status ---------------------------
    energy = 0.0
    setting = 0.0
    violations: list[str] = []
    for li in range(L):
        dh = float(head[n1[li]] - head[n2[li]])
        q = float(flow[li])
        st = int(status[li])
        lt = int(ns.link_type[li])
        name = ns.link_names[li] if li < len(ns.link_names) else str(li)

        if st == CLOSED:
            if abs(q) > q_tol:
                violations.append(f"link {name}: closed but |q|={abs(q):.4g} cfs")
            if lt == 0 and ns.check_valve[li] and dh > 0.5:
                violations.append(
                    f"CV {name}: closed under forward head dh={dh:.3g} ft"
                )
            if lt == 1 and ns.status[li] != CLOSED and ns.pump_power[li] == 0:
                w = ns.pump_speed[li]
                hmax = ns.pump_h0[li] * w * w
                if w > 1e-6 and -dh < hmax - 0.5:
                    violations.append(
                        f"pump {name}: closed but required lift {-dh:.3g} "
                        f"< shutoff {hmax:.3g} ft"
                    )
            continue

        if lt == 0:  # pipe
            if ns.check_valve[li] and q < -q_tol:
                violations.append(f"CV {name}: reverse flow q={q:.4g} cfs")
            energy = max(energy, abs(dh - pipe_headloss(ns, li, q)))
        elif lt == 1:  # pump
            if q < -q_tol:
                violations.append(f"pump {name}: reverse flow q={q:.4g} cfs")
            if ns.pump_speed[li] <= 1e-6:
                violations.append(f"pump {name}: open at zero speed")
            else:
                energy = max(energy, abs(dh + pump_gain(ns, li, q)))
        else:  # valve
            vt = int(ns.valve_type[li])
            if st == ACTIVE and vt == PRV:
                hset = ns.elevation[n2[li]] + ns.valve_setting[li]
                setting = max(setting, abs(float(head[n2[li]]) - hset))
                if q < -q_tol:
                    violations.append(f"PRV {name}: reverse flow q={q:.4g}")
            elif st == ACTIVE and vt == PSV:
                hset = ns.elevation[n1[li]] + ns.valve_setting[li]
                setting = max(setting, abs(float(head[n1[li]]) - hset))
                if q < -q_tol:
                    violations.append(f"PSV {name}: reverse flow q={q:.4g}")
            elif st == ACTIVE and vt == PBV:
                setting = max(setting, abs(dh - ns.valve_setting[li]))
            elif st == ACTIVE and vt == FCV:
                setting = max(setting, abs(q - ns.valve_setting[li]))
                if dh < -0.5:
                    violations.append(
                        f"FCV {name}: active with head rise dh={dh:.3g} ft"
                    )
            else:
                # OPEN valve, ACTIVE TCV (K = setting), or GPV (documented
                # simplification: open with its minor-loss coefficient)
                K = ns.valve_setting[li] if (vt == TCV and st == ACTIVE) \
                    else ns.minor_loss[li]
                energy = max(energy, abs(dh - valve_loss(ns, li, q, K)))

    return Certificate(
        mass=mass,
        energy=energy,
        setting=setting,
        status_ok=not violations,
        violations=violations,
    )
