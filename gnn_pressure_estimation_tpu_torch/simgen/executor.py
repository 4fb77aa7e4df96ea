"""Scenario executor: token vector → NetworkState mutation → solve → filter.

Capability parity with reference generator/EPYNET/Executorv7.py
(WDNExecutor.epynet_simulate2, :153-459) without the ctypes/EPANET layer:
parameters are written straight into the flat :class:`NetworkState` arrays
and solved by the in-repo GGA solver (C++ when built).

Replicated semantics:
- demand via per-junction values (reference wrote them as one-value patterns,
  :204-214); ``replace_nonzero_basedmd`` keeps zero-demand junctions at zero
- valve closures only when the graph stays connected, with closures
  accumulating within a scenario (:247-265; union-find instead of networkx)
- reservoir head written directly (reference used elevation=1 × pattern,
  :302-315); optional ``add_max_elevation`` anchoring
- plausibility: NaN, warning codes (``accept_warning_code``→ only >6 fails),
  pressure bounds, 2-hop neighbor-std, coefficient of variation (:368-424)
- results converted to the ``convert_results_by_flow_unit`` unit system and
  filtered by skip_nodes/skip_links (:429-459)

A copy of ``gnn_pressure_estimation_tpu/simgen/executor.py`` over the port's
``simgen/units``, ``network_state`` and ``solver_api``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from gnn_pressure_estimation_tpu_torch.data.inp import WaterNetwork
from gnn_pressure_estimation_tpu_torch.simgen import units as U
from gnn_pressure_estimation_tpu_torch.simgen.config import GenOptions
from gnn_pressure_estimation_tpu_torch.simgen.network_state import (
    ACTIVE,
    CLOSED,
    OPEN,
    NetworkState,
    build_state,
)
from gnn_pressure_estimation_tpu_torch.simgen.solver_api import solve
from gnn_pressure_estimation_tpu_torch.simgen.tokens import FeatureSpec, ParamEnum, split_params

NODE_ATTRS = ("demand", "head", "pressure")
LINK_ATTRS = ("velocity", "flow")


class _UnionFind:
    def __init__(self, n):
        self.p = list(range(n))

    def find(self, a):
        while self.p[a] != a:
            self.p[a] = self.p[self.p[a]]
            a = self.p[a]
        return a

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.p[ra] = rb


class ScenarioExecutor:
    """Stateful executor reused across scenarios (one per worker process)."""

    def __init__(self, wn: WaterNetwork, specs: list[FeatureSpec],
                 cfg, opts: GenOptions):
        self.wn = wn
        self.specs = specs
        self.opts = opts
        self.base = build_state(wn)
        self.units = self.base.units

        self.skip_nodes: list[str] = []
        self.skip_links: list[str] = []
        if cfg is not None and cfg.has_option("general", "skip_nodes"):
            self.skip_nodes = [s for s in cfg.get("general", "skip_nodes").strip().split(",") if s]
        if cfg is not None and cfg.has_option("general", "skip_links"):
            self.skip_links = [s for s in cfg.get("general", "skip_links").strip().split(",") if s]
        if opts.skip_resevoir_result:
            self.skip_nodes.extend(wn.reservoir_names)

        names = self.base.node_names
        self._node_keep = np.array([n not in set(self.skip_nodes) for n in names])
        lnames = self.base.link_names
        self._link_keep = np.array([n not in set(self.skip_links) for n in lnames])
        self.kept_node_names = [n for n in names if n not in set(self.skip_nodes)]
        self.kept_link_names = [n for n in lnames if n not in set(self.skip_links)]
        self.junction_names = wn.junction_names

        # 2-hop neighborhoods for the neighbor-std filter (reference :393-417)
        n = self.base.n_nodes
        adj = [[] for _ in range(n)]
        for a, b in zip(self.base.node1, self.base.node2):
            adj[a].append(b)
            adj[b].append(a)
        self._two_hop = []
        for i in range(n):
            seen = {i}
            frontier = {i}
            for _ in range(2):
                frontier = {nb for f in frontier for nb in adj[f]} - seen
                seen |= frontier
            self._two_hop.append(np.array(sorted(seen - {i}), np.int32))

        # per-scenario init statuses
        self._init_status = self.base.status.copy()
        if opts.init_valve_state is not None:
            vmask = self.base.link_type == 2
            self._init_status[vmask] = {0: CLOSED, 1: OPEN, 2: ACTIVE, 3: OPEN}.get(
                int(opts.init_valve_state), OPEN
            )
        if opts.init_pipe_state is not None:
            pmask = (self.base.link_type == 0) & (~self.base.check_valve)
            self._init_status[pmask] = CLOSED if int(opts.init_pipe_state) == 0 else OPEN

    # ------------------------------------------------------------------
    def apply_tokens(self, params_row: np.ndarray) -> NetworkState:
        ns = self.base.clone()
        ns.status = self._init_status.copy()
        opts = self.opts
        vals = split_params(self.specs, params_row)
        nj = ns.n_junctions
        units = self.units
        n_pipes = int(np.sum(ns.link_type == 0))
        n_pumps = int(np.sum(ns.link_type == 1))

        def pipe_idx(i):
            return i

        def pump_idx(i):
            return n_pipes + i

        def valve_idx(i):
            return n_pipes + n_pumps + i

        k = ParamEnum
        if opts.gen_demand and k.JUNC_DEMAND.value in vals:
            d = vals[k.JUNC_DEMAND.value]
            dm = np.asarray(U.flow_to_cfs(d, units))
            if opts.replace_nonzero_basedmd:
                zero = self.base.demand[:nj] == 0.0
                dm = np.where(zero, 0.0, dm)
            ns.demand[:nj] = dm
        if opts.gen_elevation and k.JUNC_ELEVATION.value in vals:
            ns.elevation[:nj] = U.length_to_ft(vals[k.JUNC_ELEVATION.value], units)

        if opts.gen_roughness and k.PIPE_ROUGHNESS.value in vals:
            v = vals[k.PIPE_ROUGHNESS.value]
            if ns.headloss_model == 1:
                v = U.dw_rough_to_ft(v, units)
            ns.roughness[:n_pipes] = v
        if opts.gen_diameter and k.PIPE_DIAMETER.value in vals:
            ns.diameter[:n_pipes] = U.diameter_to_ft(
                np.maximum(vals[k.PIPE_DIAMETER.value], 1e-12), units
            )
        if opts.gen_length and k.PIPE_LENGTH.value in vals:
            ns.length[:n_pipes] = U.length_to_ft(
                np.maximum(vals[k.PIPE_LENGTH.value], 1e-12), units
            )
        if opts.gen_minorloss and k.PIPE_MINORLOSS.value in vals:
            ns.minor_loss[:n_pipes] = np.maximum(vals[k.PIPE_MINORLOSS.value], 1e-12)

        if opts.gen_pump_init_status and k.PUMP_STATUS.value in vals:
            st = vals[k.PUMP_STATUS.value]
            for i in range(n_pumps):
                ns.status[pump_idx(i)] = OPEN if st[i] > 0 else CLOSED
        if opts.gen_pump_speed and k.PUMP_SPEED.value in vals:
            ns.pump_speed[n_pipes : n_pipes + n_pumps] = vals[k.PUMP_SPEED.value]
        # gen_pump_length intentionally a no-op on hydraulics (EPANET stores
        # pump "length" but never uses it; reference sets EN_LENGTH,
        # Executorv7.py:232-233)

        n_tanks = len(self.wn.tanks)
        tank0 = nj + len(self.wn.reservoirs)
        if opts.gen_tank_elevation and k.TANK_ELEVATION.value in vals:
            ns.elevation[tank0 : tank0 + n_tanks] = U.length_to_ft(
                vals[k.TANK_ELEVATION.value], units
            )
        if opts.gen_tank_level and k.TANK_LEVEL.value in vals:
            lv = U.length_to_ft(vals[k.TANK_LEVEL.value], units)
            ns.fixed_head[tank0 : tank0 + n_tanks] = (
                ns.elevation[tank0 : tank0 + n_tanks] + lv
            )
        elif opts.gen_tank_elevation and k.TANK_ELEVATION.value in vals:
            # keep original level on top of the new elevation
            base_lv = self.base.fixed_head[tank0:tank0+n_tanks] - self.base.elevation[tank0:tank0+n_tanks]
            ns.fixed_head[tank0 : tank0 + n_tanks] = (
                ns.elevation[tank0 : tank0 + n_tanks] + base_lv
            )
        # tank diameter: no hydraulic effect in a single-period solve

        n_valves = len(self.wn.valves)
        if opts.gen_valve_init_status and k.VALVE_STATUS.value in vals:
            st = vals[k.VALVE_STATUS.value]
            # connectivity-guarded closure (reference :247-265): closures
            # accumulate — each proposed closure is tested against the graph
            # with all previously accepted closures applied.
            closed_links: set[int] = set(
                int(li) for li in np.where(ns.status == CLOSED)[0]
            )
            for i in range(n_valves):
                li = valve_idx(i)
                if st[i] > 0:
                    ns.status[li] = self._init_status[li] if self._init_status[li] != CLOSED else ACTIVE
                    continue
                trial_closed = closed_links | {li}
                uf = _UnionFind(ns.n_nodes)
                for lj in range(len(ns.link_type)):
                    if lj not in trial_closed:
                        uf.union(int(ns.node1[lj]), int(ns.node2[lj]))
                roots = {uf.find(v) for v in range(ns.n_nodes)}
                if len(roots) == 1:
                    ns.status[li] = CLOSED
                    closed_links.add(li)
                else:
                    ns.status[li] = self._init_status[li] if self._init_status[li] != CLOSED else OPEN
        if opts.gen_valve_setting and k.VALVE_SETTING.value in vals:
            sv = vals[k.VALVE_SETTING.value]
            for i, v in enumerate(self.wn.valves):
                if sv[i] <= 0:   # 0 means unused (reference :270)
                    continue
                li = valve_idx(i)
                vt = v.valve_type.upper()
                if vt in ("PRV", "PSV", "PBV"):
                    # pressure-valve settings are PRESSURE (psi in US units,
                    # m of head in SI) — same conversion as the INP path
                    # (network_state.py build_state; EPANET Setting semantics)
                    ns.valve_setting[li] = U.pressure_to_ft(sv[i], units)
                elif vt == "FCV":
                    ns.valve_setting[li] = U.flow_to_cfs(sv[i], units)
                else:
                    ns.valve_setting[li] = sv[i]
        if opts.gen_valve_diameter and k.VALVE_DIAMETER.value in vals:
            for i in range(n_valves):
                ns.diameter[valve_idx(i)] = U.diameter_to_ft(
                    max(vals[k.VALVE_DIAMETER.value][i], 1e-12), units
                )

        if opts.gen_res_total_head and k.RESERVOIR_TOTALHEAD.value in vals:
            heads = vals[k.RESERVOIR_TOTALHEAD.value]
            if opts.update_totalhead_method == "add_max_elevation":
                max_ele = max(j.elevation for j in self.wn.junctions)
                heads = heads + max_ele
            ns.fixed_head[nj : nj + len(self.wn.reservoirs)] = U.length_to_ft(
                heads, units
            )

        return ns

    # ------------------------------------------------------------------
    def simulate_one(self, params_row: np.ndarray):
        """Returns ({attr: [1, n]}, error: bool)."""
        opts = self.opts
        ns = self.apply_tokens(params_row)
        res = solve(ns, backend=opts.backend)

        out_units = opts.convert_results_by_flow_unit or self.units
        pressure = res.pressure[self._node_keep]
        if out_units != self.units:
            pressure = U.convert_result(pressure, "pressure", self.units, out_units)

        error = bool(np.isnan(pressure).any())
        code = res.warn_code
        if code > 0:
            if opts.accept_warning_code:
                error = error or code > 6
            else:
                error = error or code > 0
        if opts.pressure_lowerbound is not None:
            error = error or bool(pressure.min() < opts.pressure_lowerbound)
        if opts.pressure_upperbound is not None:
            error = error or bool(pressure.max() > opts.pressure_upperbound)
        if opts.neighbor_std_threshold is not None and not error:
            p_all = res.pressure  # unfiltered, reference uses all nodes
            stds = np.array([
                np.std(p_all[nbrs]) if len(nbrs) else 0.0 for nbrs in self._two_hop
            ])
            error = error or bool(np.mean(stds) > opts.neighbor_std_threshold)
        if opts.mean_cv_threshold is not None and not error:
            mean = pressure.mean()
            cv = float(pressure.var() / mean) if mean != 0 else np.inf
            error = error or bool(cv > opts.mean_cv_threshold)
        if opts.flowrate_threshold is not None and not error:
            # reject scenes with any near-stagnant link flow; the reference
            # accepts this flag but left the check commented out
            # (Executorv7.py:426-427) — here it is wired for real
            error = error or bool(np.abs(res.flow).min() < opts.flowrate_threshold)

        results = {}
        for attr in opts.attributes():
            if attr in NODE_ATTRS:
                if attr == "demand":
                    vals = res.demand[: len(self.junction_names)]
                    keep = self._node_keep[: len(self.junction_names)]
                    vals = vals[keep]
                elif attr == "head":
                    vals = res.head[self._node_keep]
                else:
                    vals = res.pressure[self._node_keep]
            elif attr in LINK_ATTRS:
                vals = (res.flow if attr == "flow" else res.velocity)[self._link_keep]
            else:
                raise AttributeError(f"{attr} is not found or not supported!")
            if out_units != self.units:
                param = {"demand": "demand", "flow": "flow", "head": "head",
                         "pressure": "pressure", "velocity": "velocity"}[attr]
                vals = U.convert_result(vals, param, self.units, out_units)
            results[attr] = np.reshape(vals, (1, -1))
        return results, error

    def simulate(self, batch_params: np.ndarray):
        """Batch loop (reference WDNExecutor.simulate, :478-497): returns
        ({attr: [n_ok, n]}, ordered_name_lists, accepted_params [n_ok, F]).

        ``accepted_params`` are the parameter rows of the scenarios that
        survived the plausibility filters, row-aligned with the output
        arrays — the audit trail the reference persists as the ``token``
        zarr array (TokenGeneratorByRange.py:592-621)."""
        batch: dict[str, list] = {}
        ok_rows: list[np.ndarray] = []
        for row in batch_params:
            single, error = self.simulate_one(row)
            if not error or self.opts.allow_error:
                for key, value in single.items():
                    batch.setdefault(key, []).append(value)
                ok_rows.append(np.asarray(row, np.float64))
        out = {
            key: np.concatenate(vals, axis=0) for key, vals in batch.items() if vals
        }
        n_feat = batch_params.shape[-1] if hasattr(batch_params, "shape") else 0
        ok_params = (
            np.stack(ok_rows, axis=0) if ok_rows else np.zeros((0, n_feat))
        )
        skip = set(self.skip_nodes)
        kept_junctions = [n for n in self.junction_names if n not in skip]
        names = {
            attr: (
                kept_junctions
                if attr == "demand"
                else (self.kept_link_names if attr in LINK_ATTRS else self.kept_node_names)
            )
            for attr in self.opts.attributes()
        }
        return out, names, ok_params
