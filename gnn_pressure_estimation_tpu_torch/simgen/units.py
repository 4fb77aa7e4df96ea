"""EPANET unit system — conversions without pint.

Replaces the reference's pint-based ``ENconvert`` (epynet_utils.py:256-323) and
mirrors EPANET's own units.c: the solver works in EPANET's internal US units
(feet, cfs) so its headloss constants (4.727 Hazen-Williams, 0.02517 minor
loss) match EPANET bit-for-bit at the formula level; results convert back to
the INP's unit system.

US flow units (CFS GPM MGD IMGD AFD): diameters in inches, lengths/elevations
in feet, pressure psi, D-W roughness in milli-feet.
SI flow units (LPS LPM MLD CMH CMD): pipe/valve diameters in mm, lengths m,
pressure in m of head, D-W roughness mm.

A copy of ``gnn_pressure_estimation_tpu/simgen/units.py``, kept here so the
PyTorch package imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

FT = 0.3048                  # m per foot
GAL = 3.785411784            # L per US gallon
IMP_GAL = 4.54609            # L per imperial gallon
ACRE_FT = 1233.48183754752   # m^3 per acre-foot
CFS = FT**3                  # m^3/s per cfs = 0.0283168...
PSI_PER_FT = 0.4333          # EPANET's psi per foot of head

# flow unit → m^3/s
FLOW_UNITS = {
    "CFS": CFS,
    "GPM": GAL / 1000.0 / 60.0,
    "MGD": 1e6 * GAL / 1000.0 / 86400.0,
    "IMGD": 1e6 * IMP_GAL / 1000.0 / 86400.0,
    "AFD": ACRE_FT / 86400.0,
    "LPS": 1e-3,
    "LPM": 1e-3 / 60.0,
    "MLD": 1e3 / 86400.0,
    "CMH": 1.0 / 3600.0,
    "CMD": 1.0 / 86400.0,
}

US_FLOW_UNITS = ("CFS", "GPM", "MGD", "IMGD", "AFD")
SI_FLOW_UNITS = ("LPS", "LPM", "MLD", "CMH", "CMD")


def is_us(units: str) -> bool:
    return units.upper() in US_FLOW_UNITS


def flow_to_cfs(values, units: str):
    """INP flow units → internal cfs."""
    return np.asarray(values, np.float64) * (FLOW_UNITS[units.upper()] / CFS)


def flow_from_cfs(values, units: str):
    return np.asarray(values, np.float64) * (CFS / FLOW_UNITS[units.upper()])


def length_to_ft(values, units: str):
    """lengths / elevations / heads / tank diameters → ft."""
    return np.asarray(values, np.float64) * (1.0 if is_us(units) else 1.0 / FT)


def diameter_to_ft(values, units: str):
    """pipe/valve diameters (inches US, mm SI) → ft."""
    f = 1.0 / 12.0 if is_us(units) else 1.0 / 304.8
    return np.asarray(values, np.float64) * f


def dw_rough_to_ft(values, units: str):
    """Darcy-Weisbach roughness (milli-feet US, mm SI) → ft."""
    f = 1e-3 if is_us(units) else 1.0 / 304.8
    return np.asarray(values, np.float64) * f


def head_from_ft(values, units: str):
    return np.asarray(values, np.float64) * (1.0 if is_us(units) else FT)


def pressure_from_ft(head_minus_elev_ft, units: str):
    """EPANET pressure: psi in US systems, meters of head in SI systems."""
    v = np.asarray(head_minus_elev_ft, np.float64)
    return v * (PSI_PER_FT if is_us(units) else FT)


def pressure_to_ft(values, units: str):
    """Inverse of :func:`pressure_from_ft` — PRV/PSV/PBV settings are
    PRESSURES (psi in US unit systems, meters of head in SI), not lengths
    (EPANET input.c valve-setting Ucf[PRESSURE] conversion)."""
    v = np.asarray(values, np.float64)
    return v / (PSI_PER_FT if is_us(units) else FT)


def velocity_from_fps(values, units: str):
    return np.asarray(values, np.float64) * (1.0 if is_us(units) else FT)


def convert_result(values, param: str, from_units: str, to_units: str):
    """Cross-unit-system result conversion (reference ENconvert semantics,
    epynet_utils.py:256-323): pressure psi↔m, head ft↔m, velocity fps↔mps,
    flow/demand between any two flow units."""
    values = np.asarray(values, np.float64)
    fu, tu = from_units.upper(), to_units.upper()
    if param in ("flow", "demand"):
        return values * (FLOW_UNITS[fu] / FLOW_UNITS[tu])
    same_system = is_us(fu) == is_us(tu)
    if same_system:
        return values
    if param == "pressure":
        # psi ↔ meter_H2O through feet of head
        return values / PSI_PER_FT * FT if is_us(fu) else values / FT * PSI_PER_FT
    if param == "head":
        return values * FT if is_us(fu) else values / FT
    if param == "velocity":
        return values * FT if is_us(fu) else values / FT
    raise ValueError(f"unsupported param {param!r}")
