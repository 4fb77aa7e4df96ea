"""Unified solve entry: C++ component when built, NumPy reference otherwise.

Returns results in the network's INP unit system (EPANET reporting
convention): pressure = psi (US) / m (SI), head = ft / m, flow = INP flow
units, velocity = fps / mps — matching what the reference extracts from
``wn.nodes.pressure`` etc. (Executorv7.py:429-459).

A copy of ``gnn_pressure_estimation_tpu/simgen/solver_api.py``, with the
same backend rule (the C++ solver when it builds, the NumPy one otherwise),
kept here so the PyTorch package imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from gnn_pressure_estimation_tpu_torch.simgen import units as U
from gnn_pressure_estimation_tpu_torch.simgen.network_state import NetworkState
from gnn_pressure_estimation_tpu_torch.simgen import solver_py


@dataclasses.dataclass
class SolverResult:
    """Physical-unit results in canonical node/link order."""

    head: np.ndarray       # [n_nodes] INP unit system
    pressure: np.ndarray   # [n_nodes]
    demand: np.ndarray     # [n_nodes] INP flow units
    flow: np.ndarray       # [n_links]
    velocity: np.ndarray   # [n_links]
    warn_code: int
    converged: bool
    iterations: int
    # final link statuses (CLOSED/OPEN/ACTIVE, network_state constants) —
    # EPANET exposes these via EN_STATUS; useful for auditing valve/CV flips
    status: np.ndarray = None


_BACKEND = {"impl": None}  # lazily resolved: "cpp" | "py"


def _resolve_backend(prefer_cpp: bool = True):
    if _BACKEND["impl"] is not None:
        return _BACKEND["impl"]
    impl = "py"
    if prefer_cpp:
        try:
            from gnn_pressure_estimation_tpu_torch.simgen.solver_cpp import (
                is_available,
            )

            if is_available():
                impl = "cpp"
        except Exception:
            impl = "py"
    _BACKEND["impl"] = impl
    return impl


def set_backend(name: Optional[str]):
    """Force 'cpp' or 'py' (None resets to auto)."""
    assert name in (None, "cpp", "py")
    _BACKEND["impl"] = name


def solve(ns: NetworkState, backend: Optional[str] = None) -> SolverResult:
    impl = backend or _resolve_backend()
    if impl == "cpp":
        from gnn_pressure_estimation_tpu_torch.simgen.solver_cpp import solve_raw

        raw = solve_raw(ns)
    else:
        raw = solver_py.solve(ns)

    units = ns.units
    head_ft = raw.head
    press_ft = head_ft - ns.elevation
    warn = raw.warn_code
    if warn == 0:
        # EPANET warning 6: negative pressures at nodes with positive demand
        junc = slice(0, ns.n_junctions)
        if np.any((press_ft[junc] < 0) & (ns.demand[junc] > 0)):
            warn = 6
    # non-junction pressure = head - base elevation (EPANET convention for
    # tanks reports level; reservoirs ~0)
    area = np.pi * np.maximum(ns.diameter, 1e-6) ** 2 / 4.0
    # EPANET reports zero velocity for pumps (no meaningful diameter);
    # pipes and valves use flow over cross-section
    vel_fps = np.where(ns.link_type == 1, 0.0, np.abs(raw.flow) / area)

    return SolverResult(
        head=U.head_from_ft(head_ft, units),
        pressure=U.pressure_from_ft(press_ft, units),
        demand=U.flow_from_cfs(ns.demand, units),
        flow=U.flow_from_cfs(raw.flow, units),
        velocity=U.velocity_from_fps(vel_fps, units),
        warn_code=warn,
        converged=raw.converged,
        iterations=raw.iterations,
        status=raw.status,
    )
