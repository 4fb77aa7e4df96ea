"""Generation configuration: INI schema + typed options + config creator.

- :class:`GenOptions` is the typed replacement for scenegenv7's ~45 argparse
  flags (scenegenv7.py:35-334), defaults matched.
- :func:`read_config` loads the INI schema (reference C17,
  configs/v7.1/ctown_7v1__EPYNET_config.ini).
- :func:`create_dummy_config` derives a generation INI from an INP's actual
  value ranges (reference generator/EPYNET/ConfigCreator.py:95-223) — with
  the CLI actually wired up (the reference parses ``parse_args([])`` so its
  documented ``-r`` flag is dead, SURVEY.md §3.4).

A copy of ``gnn_pressure_estimation_tpu/simgen/config.py`` over the port's own
``data/inp.py``: the same options, defaults and INI.
"""

from __future__ import annotations

import dataclasses
import os
from configparser import ConfigParser
from typing import Optional

import numpy as np

from gnn_pressure_estimation_tpu_torch.data.inp import WaterNetwork, parse_inp


@dataclasses.dataclass
class GenOptions:
    """Scenario-generation flags (reference defaults, scenegenv7.py:35-334)."""

    config: str = ""
    init_valve_state: Optional[int] = 1
    init_pipe_state: Optional[int] = None
    remove_pattern: bool = True
    remove_control: bool = False
    remove_rule: bool = False
    # gen_* toggles
    gen_demand: bool = False
    replace_nonzero_basedmd: bool = False
    gen_elevation: bool = False
    gen_roughness: bool = False
    gen_diameter: bool = False
    gen_length: bool = False
    gen_minorloss: bool = False
    gen_valve_init_status: bool = False
    gen_valve_setting: bool = False
    gen_valve_diameter: bool = False
    gen_pump_init_status: bool = False
    gen_pump_speed: bool = False
    gen_pump_length: bool = False
    gen_tank_level: bool = False
    gen_tank_elevation: bool = False
    gen_tank_diameter: bool = False
    gen_res_total_head: bool = False
    skip_resevoir_result: bool = False
    update_totalhead_method: Optional[str] = None  # None | "add_max_elevation"
    # user-value injection: per-parameter JSON ``{"uid": value}`` (inline
    # string or ``@path/to/file``) pinning named elements to fixed values
    # (reference update_*_json flag family, scenegenv7.py:78-261; partial
    # override here instead of the reference's zero-fill — tokens.py)
    update_demand_json: Optional[str] = None
    update_elevation_json: Optional[str] = None
    update_pipe_roughness_json: Optional[str] = None
    update_pipe_diameter_json: Optional[str] = None
    update_pipe_length_json: Optional[str] = None
    update_pipe_minorloss_json: Optional[str] = None
    update_pump_init_status_json: Optional[str] = None
    update_pump_speed_json: Optional[str] = None
    update_pump_length_json: Optional[str] = None
    update_tank_level_json: Optional[str] = None
    update_tank_elevation_json: Optional[str] = None
    update_tank_diameter_json: Optional[str] = None
    update_valve_init_status_json: Optional[str] = None
    update_valve_setting_json: Optional[str] = None
    update_valve_diameter_json: Optional[str] = None
    update_res_total_head_json: Optional[str] = None
    # parameter persistence / reuse (reference RayTokenGenerator stores the
    # sampled matrix as the 'token' zarr array and can reload it,
    # TokenGeneratorByRange.py:564-633)
    save_params: bool = True      # write accepted rows as <store>/token
    load_params: Optional[str] = None  # regenerate from a prior store's token array
    # formula selection (reference defaults: range for demand,
    # ran_cluster documented for elevation — scenegenv7.py:90-94)
    demand_formula: str = "range"
    elevation_formula: str = "range"
    # plausibility thresholds
    allow_error: bool = False
    accept_warning_code: bool = False
    pressure_lowerbound: Optional[float] = None
    pressure_upperbound: Optional[float] = None
    flowrate_threshold: Optional[float] = None
    mean_cv_threshold: Optional[float] = None
    neighbor_std_threshold: Optional[float] = None
    convert_results_by_flow_unit: Optional[str] = "LPS"
    # run scale
    att: str = "pressure,head"
    batch_size: int = 5
    executors: int = 2
    train_ratio: float = 0.6
    valid_ratio: float = 0.2
    oversample_factor: int = 10
    seed: int = 0
    debug: bool = False
    backend: Optional[str] = None  # solver backend override ("cpp"/"py")

    def attributes(self) -> list[str]:
        return [a.strip() for a in self.att.split(",") if a.strip()]

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def read_config(path: str) -> ConfigParser:
    cfg = ConfigParser()
    if not cfg.read(path):
        raise FileNotFoundError(path)
    return cfg


def get_range(values, strategy: str = "minmax", q: float = 0.05):
    """[lo, hi] from an array: min/max or (q, 1-q) quantiles
    (reference ConfigCreator.py:73-92)."""
    values = np.asarray(values, np.float64)
    if values.size == 0:
        return 0.0, 0.0
    if strategy == "minmax":
        return float(values.min()), float(values.max())
    return float(np.quantile(values, q)), float(np.quantile(values, 1 - q))


def create_dummy_config(
    inp_path: str,
    out_path: Optional[str] = None,
    num_scenarios: int = 100,
    strategy: str = "minmax",
    storage_root: str = "datasets",
    seed: int = 0,
) -> ConfigParser:
    """Derive per-parameter ranges from the network's actual values
    (reference ConfigCreator.create_dummy_config, :95-223)."""
    wn = parse_inp(inp_path)
    rng = np.random.default_rng(seed)
    name = os.path.splitext(os.path.basename(inp_path))[0]

    cfg = ConfigParser()
    cfg["general"] = {
        "wn_inp_path": inp_path,
        "config_path": out_path or f"configs/{name}_config.ini",
        "storage_dir": os.path.join(storage_root, name),
        "doe": "uniform",
        "num_scenarios": str(num_scenarios),
    }

    if wn.junctions:
        demands = []
        for j in wn.junctions:
            cats = j.demand_categories if j.demand_categories else [(j.base_demand, j.pattern)]
            demands.append(sum(b * (wn.get_pattern(p)[0] if p else 1.0) for b, p in cats))
        dlo, dhi = get_range(demands, strategy)
        elo, ehi = get_range([j.elevation for j in wn.junctions], strategy)
        cfg["junction"] = {
            "demand_lo": str(max(dlo, 0.0)),
            "demand_hi": str(dhi if dhi > 0 else 1e-4),
            "ele_lo": str(elo),
            "ele_hi": str(ehi),
        }

    if wn.pumps:
        slo, shi = get_range([p.speed for p in wn.pumps], strategy)
        cfg["pump"] = {
            "open_prob": "1.0",
            "speed_lo": str(slo or 1.0),
            "speed_hi": str(shi or 1.0),
            "length_lo": "0.0",
            "length_hi": "0.0",
        }

    if wn.tanks:
        cfg["tank"] = {
            "level_lo": str(min(t.min_level for t in wn.tanks)),
            "level_hi": str(max(t.max_level for t in wn.tanks)),
            "ele_lo": str(min(t.elevation for t in wn.tanks)),
            "ele_hi": str(max(t.elevation for t in wn.tanks)),
            "dia_lo": str(min(t.diameter for t in wn.tanks)),
            "dia_hi": str(max(t.diameter for t in wn.tanks)),
        }

    if wn.valves:
        sec = {"open_prob": "1.0"}
        by_type: dict[str, list[float]] = {}
        for v in wn.valves:
            by_type.setdefault(v.valve_type.lower(), []).append(v.setting)
        for vt, settings in by_type.items():
            lo, hi = get_range(settings, strategy)
            sec[f"setting_{vt}_lo"] = str(lo)
            sec[f"setting_{vt}_hi"] = str(hi)
        dlo, dhi = get_range([v.diameter for v in wn.valves], strategy)
        sec["dia_lo"], sec["dia_hi"] = str(dlo), str(dhi)
        cfg["valve"] = sec

    if wn.pipes:
        rlo, rhi = get_range([p.roughness for p in wn.pipes], strategy)
        dlo, dhi = get_range([p.diameter for p in wn.pipes], strategy)
        llo, lhi = get_range([p.length for p in wn.pipes], strategy)
        mlo, mhi = get_range([p.minor_loss for p in wn.pipes], strategy)
        cfg["pipe"] = {
            "roughness_lo": str(rlo), "roughness_hi": str(rhi),
            "diameter_lo": str(dlo), "diameter_hi": str(dhi),
            "length_lo": str(llo), "length_hi": str(lhi),
            "minorloss_lo": str(mlo), "minorloss_hi": str(mhi),
        }

    if wn.reservoirs:
        # randomized head range anchored to top-10 junction elevations
        # (reference ConfigCreator.py:198-217)
        eles = sorted((j.elevation for j in wn.junctions), reverse=True)[:10]
        anchor = float(np.mean(eles)) if eles else 50.0
        heads = [r.head for r in wn.reservoirs]
        hlo = min(min(heads), anchor)
        hhi = max(max(heads), anchor * (1.0 + 0.25 * rng.random()))
        cfg["reservoir"] = {"head_lo": str(hlo), "head_hi": str(hhi)}

    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            cfg.write(f)
    return cfg
