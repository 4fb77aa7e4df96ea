"""ctypes binding for the C++ hydraulic solver (simgen/solver/hydraulic.cpp).

The counterpart of ``gnn_pressure_estimation_tpu/simgen/solver_cpp.py``, over
a copy of its source and Makefile (g++ only; no pybind11 dependency — plain C
ABI). The library is built at first use with that Makefile into the
package's ``_build/`` by ``native_build``, not beside the source, under a
name that carries the hash of the source, the Makefile and the host's CPU.
A failed build means no cpp backend, never a stale one.
"""

from __future__ import annotations

import ctypes as ct
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from gnn_pressure_estimation_tpu_torch import native_build
from gnn_pressure_estimation_tpu_torch.simgen import solver_py
from gnn_pressure_estimation_tpu_torch.simgen.network_state import NetworkState

SRC_DIR = Path(__file__).resolve().parent / "solver"
BUILD_DIR = native_build.BUILD_DIR
_FILES = ("hydraulic.cpp", "Makefile")

_lock = threading.Lock()
_LIB: Optional[ct.CDLL] = None
_FAILED = False

_dp = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_ip = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_bp = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def library_path() -> Path:
    return native_build.library_path(SRC_DIR, "libhydraulic", _FILES)


def build() -> Path:
    """Build the library if this source has no build for this host yet;
    raises if ``make`` fails. Returns its path."""
    return native_build.build(SRC_DIR, "libhydraulic", _FILES)


def _load() -> Optional[ct.CDLL]:
    global _LIB, _FAILED
    with _lock:
        if _LIB is not None or _FAILED:
            return _LIB
        try:
            lib = ct.CDLL(str(build()))
        except (OSError, RuntimeError, subprocess.SubprocessError):
            _FAILED = True
            return None
        lib.hyd_solve.restype = ct.c_int
        lib.hyd_solve.argtypes = [
            ct.c_int, ct.c_int, ct.c_int,
            _dp, _dp, _dp,                 # elevation, fixed_head, demand
            _ip, _ip, _ip,                 # link_type, node1, node2
            _ip, _bp,                      # status_in, check_valve
            _dp, _dp, _dp, _dp,            # length, diameter, roughness, minor_loss
            _dp, _dp, _dp, _dp, _dp,       # pump h0/r/n/speed/power
            _ip, _dp,                      # valve_type, valve_setting
            ct.c_int, ct.c_double,         # headloss_model, viscosity
            ct.c_int, ct.c_double,         # max_iter, accuracy
            _dp, _dp, _ip,                 # head, flow, status_out
            ct.POINTER(ct.c_int),          # iters_out
        ]
        _LIB = lib
        return lib


def is_available() -> bool:
    return _load() is not None


def solve_raw(ns: NetworkState) -> solver_py.SolverResult:
    lib = _load()
    if lib is None:
        raise RuntimeError("libhydraulic.so unavailable (build failed)")
    n, nj, L = ns.n_nodes, ns.n_junctions, len(ns.link_type)
    head = np.empty(n, np.float64)
    flow = np.empty(L, np.float64)
    status_out = np.empty(L, np.int32)
    iters = ct.c_int(0)

    def d(a):
        return np.ascontiguousarray(a, np.float64)

    def i(a):
        return np.ascontiguousarray(a, np.int32)

    warn = lib.hyd_solve(
        n, nj, L,
        d(ns.elevation), d(ns.fixed_head), d(ns.demand),
        i(ns.link_type), i(ns.node1), i(ns.node2),
        i(ns.status), np.ascontiguousarray(ns.check_valve, np.uint8),
        d(ns.length), d(ns.diameter), d(ns.roughness), d(ns.minor_loss),
        d(ns.pump_h0), d(ns.pump_r), d(ns.pump_n), d(ns.pump_speed),
        d(ns.pump_power),
        i(ns.valve_type), d(ns.valve_setting),
        int(ns.headloss_model), float(ns.viscosity),
        int(ns.trials), float(ns.accuracy),
        head, flow, status_out, ct.byref(iters),
    )
    return solver_py.SolverResult(
        head=head, flow=flow, status=status_out,
        warn_code=int(warn), converged=warn in (0,), iterations=int(iters.value),
    )
