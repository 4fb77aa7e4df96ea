"""Scenario token sampling — parameter formulas and feature layout.

Capability parity with reference generator/EPYNET/TokenGeneratorByRange.py:
uniform [0,1) tokens per scenario are mapped to hydraulic parameter values via
per-parameter formula families (range / boolean / ratio / spatial k-means
cluster — reference :74-165), laid out in a fixed feature order
(``featlen_dict``, scenegenv7.py:381-429).

Fixed vs the reference: ``PUMP_LENGTH`` gets its own key (the reference enum
aliases it to 'pump_speed', collapsing both features into one zarr key —
SURVEY.md §2 quirk).

A copy of ``gnn_pressure_estimation_tpu/simgen/tokens.py``: the same formulas,
feature layout and RNG calls in the same order, so one seed samples the same
parameters in both packages.
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Callable, Optional

import numpy as np

EPSILON = 1e-12


class ParamEnum(str, Enum):
    RANDOM_TOKEN = "token"
    JUNC_DEMAND = "junc_demand"
    JUNC_ELEVATION = "junc_elevation"
    PUMP_STATUS = "pump_status"
    PUMP_SPEED = "pump_speed"
    PUMP_LENGTH = "pump_length"  # reference aliases this to 'pump_speed'
    TANK_LEVEL = "tank_level"
    TANK_ELEVATION = "tank_elevation"
    TANK_DIAMETER = "tank_diameter"
    VALVE_SETTING = "valve_setting"
    VALVE_STATUS = "valve_status"
    VALVE_DIAMETER = "valve_diameter"
    PIPE_ROUGHNESS = "pipe_roughness"
    PIPE_DIAMETER = "pipe_diameter"
    PIPE_LENGTH = "pipe_length"
    PIPE_MINORLOSS = "pipe_minor_loss"
    RESERVOIR_TOTALHEAD = "reservoir_totalhead"


# ---- formula families (reference TokenGeneratorByRange.py:74-165) ---------

def values_by_range(tokens, lo, hi, ori_vals=None, **kw):
    return lo + tokens * (hi - lo)


def boolean_values(tokens, open_prob, **kw):
    return np.less(tokens, open_prob).astype(tokens.dtype)


def values_by_ratio(tokens, lo, hi, ori_vals, **kw):
    hi_clip = np.max(ori_vals)
    new = ori_vals + np.sign(tokens) * (lo + np.abs(tokens) * (hi - lo)) * ori_vals
    return np.clip(new, 0.0, hi_clip)


def diameter_by_ratio(tokens, lo, hi, ori_vals, **kw):
    mn = np.min(ori_vals)
    new = ori_vals + np.sign(tokens) * (lo + np.abs(tokens) * (hi - lo)) * ori_vals
    return np.where(new <= mn, ori_vals, new)


def values_by_ran_cluster(
    tokens, lo, hi, ori_vals, *, coords, rng,
    num_clusters_lo=4, num_clusters_hi=50, sigma=1.0, kmean_init="k-means++",
    **kw,
):
    """Spatially clustered sampling: k-means over element coordinates, one
    uniform [lo,hi] value per cluster, plus ±token·sigma jitter, clipped
    (reference :99-165)."""
    try:
        from sklearn.cluster import KMeans
    except ImportError as e:
        raise ImportError("the 'ran_cluster' formula (demand_formula / elevation_formula) needs "
                          "scikit-learn's KMeans, which is not installed") from e

    chunk, n = tokens.shape
    if num_clusters_hi < n:
        labels = np.empty((chunk, n), np.int64)
        for c in range(chunk):
            k = int(num_clusters_lo + rng.random() * (num_clusters_hi - num_clusters_lo))
            km = KMeans(n_clusters=max(k, 1), init=kmean_init, n_init="auto",
                        random_state=int(rng.integers(0, 2**31 - 1)))
            labels[c] = km.fit_predict(coords)
        width = num_clusters_hi
    else:
        labels = np.tile(np.arange(n), (chunk, 1))
        width = n
    local = lo + rng.random((chunk, width)) * (hi - lo)
    sign = np.where(rng.random(tokens.shape) >= 0.5, 1.0, -1.0)
    cluster_vals = np.take_along_axis(local, labels, axis=1)
    if sigma is None:
        sigma = float(np.std(np.asarray(ori_vals).ravel()))
    return np.clip(cluster_vals + sign * tokens * sigma, lo, hi)


FORMULAS: dict[str, Callable] = {
    "range": values_by_range,
    "bool": boolean_values,
    "ratio": values_by_ratio,
    "diameter_ratio": diameter_by_ratio,
    "ran_cluster": values_by_ran_cluster,
}


# ---- feature layout --------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FeatureSpec:
    key: ParamEnum
    length: int
    lo: float
    hi: float
    formula: str = "range"   # FORMULAS key
    ori_vals: Optional[np.ndarray] = None
    coords: Optional[np.ndarray] = None
    # per-element (lo, hi) overrides (valve settings per valve type,
    # reference TokenGeneratorByRange.py:411-442)
    elem_lo: Optional[np.ndarray] = None
    elem_hi: Optional[np.ndarray] = None
    # element uids in feature order, for update_*_json targeting
    uids: tuple = ()


def build_feature_specs(wn, cfg, opts) -> list[FeatureSpec]:
    """featlen layout in the reference's flag order (scenegenv7.py:381-429):
    junctions → pipes → pumps → tanks → valves → reservoirs."""
    from gnn_pressure_estimation_tpu_torch.simgen.config import GenOptions  # noqa: F401

    specs: list[FeatureSpec] = []
    coords = np.array(
        [wn.coordinates.get(n, (0.0, 0.0)) for n in wn.node_names], np.float64
    )
    norm = np.linalg.norm(coords) + EPSILON
    coords = coords / norm
    nj = len(wn.junctions)
    jc = coords[:nj]

    def rng_of(section, lo_key, hi_key):
        return cfg.getfloat(section, lo_key), cfg.getfloat(section, hi_key)

    if nj and cfg.has_section("junction"):
        if opts.gen_demand:
            lo, hi = rng_of("junction", "demand_lo", "demand_hi")
            specs.append(FeatureSpec(ParamEnum.JUNC_DEMAND, nj, lo, hi,
                                     opts.demand_formula, coords=jc))
        if opts.gen_elevation:
            lo, hi = rng_of("junction", "ele_lo", "ele_hi")
            ori = np.array([j.elevation for j in wn.junctions])
            specs.append(FeatureSpec(ParamEnum.JUNC_ELEVATION, nj, lo, hi,
                                     opts.elevation_formula, ori_vals=ori, coords=jc))

    n_pipes = len(wn.pipes)
    if n_pipes and cfg.has_section("pipe"):
        if opts.gen_roughness:
            lo, hi = rng_of("pipe", "roughness_lo", "roughness_hi")
            specs.append(FeatureSpec(ParamEnum.PIPE_ROUGHNESS, n_pipes, lo, hi))
        if opts.gen_diameter:
            lo, hi = rng_of("pipe", "diameter_lo", "diameter_hi")
            specs.append(FeatureSpec(ParamEnum.PIPE_DIAMETER, n_pipes, lo, hi))
        if opts.gen_length:
            lo, hi = rng_of("pipe", "length_lo", "length_hi")
            specs.append(FeatureSpec(ParamEnum.PIPE_LENGTH, n_pipes, lo, hi))
        if opts.gen_minorloss:
            lo, hi = rng_of("pipe", "minorloss_lo", "minorloss_hi")
            specs.append(FeatureSpec(ParamEnum.PIPE_MINORLOSS, n_pipes, lo, hi))

    n_pumps = len(wn.pumps)
    if n_pumps and cfg.has_section("pump"):
        if opts.gen_pump_init_status:
            p = cfg.getfloat("pump", "open_prob")
            specs.append(FeatureSpec(ParamEnum.PUMP_STATUS, n_pumps, p, p, "bool"))
        if opts.gen_pump_speed:
            lo, hi = rng_of("pump", "speed_lo", "speed_hi")
            specs.append(FeatureSpec(ParamEnum.PUMP_SPEED, n_pumps, lo, hi))
        if opts.gen_pump_length:
            lo, hi = rng_of("pump", "length_lo", "length_hi")
            specs.append(FeatureSpec(ParamEnum.PUMP_LENGTH, n_pumps, lo, hi))

    n_tanks = len(wn.tanks)
    if n_tanks and cfg.has_section("tank"):
        if opts.gen_tank_level:
            lo, hi = rng_of("tank", "level_lo", "level_hi")
            specs.append(FeatureSpec(ParamEnum.TANK_LEVEL, n_tanks, lo, hi))
        if opts.gen_tank_elevation:
            lo, hi = rng_of("tank", "ele_lo", "ele_hi")
            specs.append(FeatureSpec(ParamEnum.TANK_ELEVATION, n_tanks, lo, hi))
        if opts.gen_tank_diameter:
            lo, hi = rng_of("tank", "dia_lo", "dia_hi")
            specs.append(FeatureSpec(ParamEnum.TANK_DIAMETER, n_tanks, lo, hi))

    n_valves = len(wn.valves)
    if n_valves and cfg.has_section("valve"):
        if opts.gen_valve_init_status:
            p = cfg.getfloat("valve", "open_prob")
            specs.append(FeatureSpec(ParamEnum.VALVE_STATUS, n_valves, p, p, "bool"))
        if opts.gen_valve_setting:
            elem_lo = np.zeros(n_valves)
            elem_hi = np.zeros(n_valves)
            for i, v in enumerate(wn.valves):
                key = v.valve_type.lower()
                elem_lo[i] = cfg.getfloat("valve", f"setting_{key}_lo")
                elem_hi[i] = cfg.getfloat("valve", f"setting_{key}_hi")
            specs.append(FeatureSpec(ParamEnum.VALVE_SETTING, n_valves, 0.0, 0.0,
                                     "range", elem_lo=elem_lo, elem_hi=elem_hi))
        if opts.gen_valve_diameter:
            lo, hi = rng_of("valve", "dia_lo", "dia_hi")
            specs.append(FeatureSpec(ParamEnum.VALVE_DIAMETER, n_valves, lo, hi))

    n_res = len(wn.reservoirs)
    if n_res and cfg.has_section("reservoir") and opts.gen_res_total_head:
        lo, hi = rng_of("reservoir", "head_lo", "head_hi")
        specs.append(FeatureSpec(ParamEnum.RESERVOIR_TOTALHEAD, n_res, lo, hi,
                                 coords=coords[nj : nj + n_res]))

    junc_ids = tuple(j.id for j in wn.junctions)
    uid_map = {
        ParamEnum.JUNC_DEMAND: junc_ids,
        ParamEnum.JUNC_ELEVATION: junc_ids,
        ParamEnum.PIPE_ROUGHNESS: tuple(p.id for p in wn.pipes),
        ParamEnum.PIPE_DIAMETER: tuple(p.id for p in wn.pipes),
        ParamEnum.PIPE_LENGTH: tuple(p.id for p in wn.pipes),
        ParamEnum.PIPE_MINORLOSS: tuple(p.id for p in wn.pipes),
        ParamEnum.PUMP_STATUS: tuple(p.id for p in wn.pumps),
        ParamEnum.PUMP_SPEED: tuple(p.id for p in wn.pumps),
        ParamEnum.PUMP_LENGTH: tuple(p.id for p in wn.pumps),
        ParamEnum.TANK_LEVEL: tuple(t.id for t in wn.tanks),
        ParamEnum.TANK_ELEVATION: tuple(t.id for t in wn.tanks),
        ParamEnum.TANK_DIAMETER: tuple(t.id for t in wn.tanks),
        ParamEnum.VALVE_STATUS: tuple(v.id for v in wn.valves),
        ParamEnum.VALVE_SETTING: tuple(v.id for v in wn.valves),
        ParamEnum.VALVE_DIAMETER: tuple(v.id for v in wn.valves),
        ParamEnum.RESERVOIR_TOTALHEAD: tuple(r.id for r in wn.reservoirs),
    }
    return [dataclasses.replace(s, uids=uid_map[s.key]) for s in specs]


def featlen_dict(specs: list[FeatureSpec]) -> dict[str, int]:
    return {str(s.key.value): s.length for s in specs}


# GenOptions field carrying the user-value injection for each parameter key
# (reference scenegenv7.py's update_*_json argument family, :78-261)
UPDATE_JSON_FIELD: dict[ParamEnum, str] = {
    ParamEnum.JUNC_DEMAND: "update_demand_json",
    ParamEnum.JUNC_ELEVATION: "update_elevation_json",
    ParamEnum.PIPE_ROUGHNESS: "update_pipe_roughness_json",
    ParamEnum.PIPE_DIAMETER: "update_pipe_diameter_json",
    ParamEnum.PIPE_LENGTH: "update_pipe_length_json",
    ParamEnum.PIPE_MINORLOSS: "update_pipe_minorloss_json",
    ParamEnum.PUMP_STATUS: "update_pump_init_status_json",
    ParamEnum.PUMP_SPEED: "update_pump_speed_json",
    ParamEnum.PUMP_LENGTH: "update_pump_length_json",
    ParamEnum.TANK_LEVEL: "update_tank_level_json",
    ParamEnum.TANK_ELEVATION: "update_tank_elevation_json",
    ParamEnum.TANK_DIAMETER: "update_tank_diameter_json",
    ParamEnum.VALVE_STATUS: "update_valve_init_status_json",
    ParamEnum.VALVE_SETTING: "update_valve_setting_json",
    ParamEnum.VALVE_DIAMETER: "update_valve_diameter_json",
    ParamEnum.RESERVOIR_TOTALHEAD: "update_res_total_head_json",
}


def parse_injection(json_string: str, uids, length: int):
    """User-value injection: ``{"uid": value}`` JSON (string or ``@file``).

    Returns ``(mask[length], values[length])``: elements named in the JSON
    get the fixed value on every scenario; the rest keep their sampled
    values. This *fixes* the reference's semantics
    (TokenGeneratorByRange.py:50-72), which replaces the whole block and
    zero-fills any uid the JSON omits (with only a printed warning) —
    partial override is what the flag is for.

    Unknown uids raise — a typo should not silently sample instead.
    """
    import json as _json

    text = json_string
    if text.startswith("@"):
        with open(text[1:]) as f:
            text = f.read()
    value_dict = _json.loads(text)
    index = {u: i for i, u in enumerate(uids)}
    unknown = [u for u in value_dict if u not in index]
    if unknown:
        raise ValueError(f"update_*_json uids not in the network: {unknown}")
    mask = np.zeros(length, bool)
    values = np.zeros(length, np.float64)
    for uid, v in value_dict.items():
        mask[index[uid]] = True
        values[index[uid]] = float(v)
    return mask, values


def build_injections(specs: list[FeatureSpec], opts) -> list:
    """Per-spec (mask, values) overrides from the opts.update_*_json family
    (None where no injection is configured)."""
    out = []
    for s in specs:
        field = UPDATE_JSON_FIELD.get(s.key)
        js = getattr(opts, field, None) if field else None
        out.append(parse_injection(js, s.uids, s.length) if js else None)
    return out


def sample_params(
    specs: list[FeatureSpec],
    chunk_size: int,
    rng: np.random.Generator,
    injections: Optional[list] = None,
) -> np.ndarray:
    """Uniform tokens → parameter values, concatenated in spec order
    (reference batch_update, TokenGeneratorByRange.py:238-562).

    ``injections`` (from :func:`build_injections`) pins user-supplied values
    for named elements after sampling.
    """
    out = []
    for si, s in enumerate(specs):
        tokens = rng.random((chunk_size, s.length))
        if s.elem_lo is not None:  # per-element ranges (valve settings)
            vals = s.elem_lo[None, :] + tokens * (s.elem_hi - s.elem_lo)[None, :]
        elif s.formula == "bool":
            vals = boolean_values(tokens, s.lo)
        else:
            fn = FORMULAS[s.formula]
            vals = fn(tokens, s.lo, s.hi, ori_vals=s.ori_vals, coords=s.coords,
                      rng=rng)
        inj = injections[si] if injections else None
        if inj is not None:
            mask, fixed = inj
            vals = np.where(mask[None, :], fixed[None, :], vals)
        out.append(vals)
    if not out:
        return np.zeros((chunk_size, 0))
    return np.concatenate(out, axis=-1)


def apply_injections(specs: list[FeatureSpec], params: np.ndarray,
                     injections: Optional[list]) -> np.ndarray:
    """Pin user-supplied values onto existing parameter rows (the
    ``--load_params`` + ``update_*_json`` combination: regenerate from a
    prior store's rows, with the named elements overridden)."""
    if not injections or all(i is None for i in injections):
        return params
    params = np.array(params, copy=True)
    start = 0
    for si, s in enumerate(specs):
        inj = injections[si]
        if inj is not None:
            mask, fixed = inj
            block = params[:, start : start + s.length]
            params[:, start : start + s.length] = np.where(
                mask[None, :], fixed[None, :], block
            )
        start += s.length
    return params


def split_params(specs: list[FeatureSpec], params: np.ndarray) -> dict[str, np.ndarray]:
    """Stacked parameter row(s) → per-key arrays (RaggedArrayDict analog,
    epynet_utils.py:425+)."""
    out = {}
    start = 0
    for s in specs:
        out[str(s.key.value)] = params[..., start : start + s.length]
        start += s.length
    return out
