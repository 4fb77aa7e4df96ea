"""EPANET INP file parser and writer ↔ :class:`WaterNetwork` (numpy only).

A copy of ``gnn_pressure_estimation_tpu/data/inp.py`` (``parse_inp``,
``write_inp`` and the network classes), kept here so the PyTorch package
imports nothing of the JAX package.

Replaces the reference's dependence on ``wntr.network.WaterNetworkModel`` /
``epynet.Network`` for topology + attribute access (DataLoader.py:216,
TokenGeneratorByRange.py:250, Executorv7.py:86). Parses the subset of the INP
format a single-period hydraulic snapshot needs: junctions, reservoirs,
tanks, pipes, pumps, valves, demand categories, patterns, curves, status,
options (units / headloss), coordinates.

Canonical node order (the dataset/zarr contract): junctions in file order,
then reservoirs, then tanks — matching EPANET's index assignment for INPs
with standard section order. Link order: pipes, pumps, valves in file order.

Units: quantities are kept in INP units here; conversion to SI happens in the
JAX package's ``simgen.units`` at solve time (mirrors the reference's pint usage,
epynet_utils.py:256-323).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np

# node type codes
JUNCTION, RESERVOIR, TANK = 0, 1, 2
# link type codes
PIPE, PUMP, VALVE = 0, 1, 2

VALVE_TYPES = ("PRV", "PSV", "PBV", "FCV", "TCV", "GPV")


@dataclasses.dataclass
class Junction:
    id: str
    elevation: float = 0.0
    base_demand: float = 0.0
    pattern: Optional[str] = None
    # extra demand categories from [DEMANDS]: list of (base, pattern)
    demand_categories: list = dataclasses.field(default_factory=list)
    emitter: float = 0.0


@dataclasses.dataclass
class Reservoir:
    id: str
    head: float = 0.0
    pattern: Optional[str] = None


@dataclasses.dataclass
class Tank:
    id: str
    elevation: float = 0.0
    init_level: float = 0.0
    min_level: float = 0.0
    max_level: float = 0.0
    diameter: float = 0.0
    min_vol: float = 0.0
    vol_curve: Optional[str] = None


@dataclasses.dataclass
class Pipe:
    id: str
    node1: str
    node2: str
    length: float = 100.0
    diameter: float = 100.0
    roughness: float = 100.0
    minor_loss: float = 0.0
    status: str = "OPEN"  # OPEN | CLOSED | CV


@dataclasses.dataclass
class Pump:
    id: str
    node1: str
    node2: str
    head_curve: Optional[str] = None
    power: Optional[float] = None
    speed: float = 1.0
    pattern: Optional[str] = None
    status: str = "OPEN"


@dataclasses.dataclass
class Valve:
    id: str
    node1: str
    node2: str
    diameter: float = 100.0
    valve_type: str = "PRV"
    setting: float = 0.0
    minor_loss: float = 0.0
    status: str = "ACTIVE"  # ACTIVE | OPEN | CLOSED


@dataclasses.dataclass
class Options:
    units: str = "GPM"
    headloss: str = "H-W"  # H-W | D-W | C-M
    specific_gravity: float = 1.0
    viscosity: float = 1.0
    trials: int = 200
    accuracy: float = 0.001
    demand_multiplier: float = 1.0
    pattern: str = "1"


class WaterNetwork:
    """Parsed network with canonical node/link ordering and numpy views."""

    def __init__(self):
        self.title: list[str] = []
        self.junctions: list[Junction] = []
        self.reservoirs: list[Reservoir] = []
        self.tanks: list[Tank] = []
        self.pipes: list[Pipe] = []
        self.pumps: list[Pump] = []
        self.valves: list[Valve] = []
        self.patterns: dict[str, list[float]] = {}
        self.curves: dict[str, list[tuple[float, float]]] = {}
        self.options = Options()
        self.coordinates: dict[str, tuple[float, float]] = {}
        self.times: dict[str, str] = {}

    # ---- ordering contracts ---------------------------------------------
    @property
    def node_names(self) -> list[str]:
        return (
            [j.id for j in self.junctions]
            + [r.id for r in self.reservoirs]
            + [t.id for t in self.tanks]
        )

    @property
    def junction_names(self) -> list[str]:
        return [j.id for j in self.junctions]

    @property
    def reservoir_names(self) -> list[str]:
        return [r.id for r in self.reservoirs]

    @property
    def tank_names(self) -> list[str]:
        return [t.id for t in self.tanks]

    @property
    def link_names(self) -> list[str]:
        return (
            [p.id for p in self.pipes]
            + [p.id for p in self.pumps]
            + [v.id for v in self.valves]
        )

    @property
    def links(self) -> list:
        return list(self.pipes) + list(self.pumps) + list(self.valves)

    @property
    def n_nodes(self) -> int:
        return len(self.junctions) + len(self.reservoirs) + len(self.tanks)

    @property
    def n_links(self) -> int:
        return len(self.pipes) + len(self.pumps) + len(self.valves)

    def node_index(self) -> dict[str, int]:
        return {n: i for i, n in enumerate(self.node_names)}

    def node_type_codes(self) -> np.ndarray:
        return np.concatenate([
            np.full(len(self.junctions), JUNCTION, np.int32),
            np.full(len(self.reservoirs), RESERVOIR, np.int32),
            np.full(len(self.tanks), TANK, np.int32),
        ]) if self.n_nodes else np.zeros(0, np.int32)

    def link_endpoints(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(node1_idx, node2_idx, link_type) arrays in canonical link order."""
        idx = self.node_index()
        n1, n2, lt = [], [], []
        for p in self.pipes:
            n1.append(idx[p.node1]); n2.append(idx[p.node2]); lt.append(PIPE)
        for p in self.pumps:
            n1.append(idx[p.node1]); n2.append(idx[p.node2]); lt.append(PUMP)
        for v in self.valves:
            n1.append(idx[v.node1]); n2.append(idx[v.node2]); lt.append(VALVE)
        return (np.array(n1, np.int32), np.array(n2, np.int32), np.array(lt, np.int32))

    def link_attribute(self, attr: str) -> np.ndarray:
        """Per-link attribute in canonical order; 0 where undefined
        (reference DataLoader.py:219-228 fills missing link weights with 0)."""
        out = []
        for link in self.links:
            out.append(float(getattr(link, attr, 0.0) or 0.0))
        return np.array(out, np.float64)

    def to_edges(self, keep_nodes: Optional[list[str]] = None):
        """Undirected-as-bidirected edge list over (optionally) a node subset,
        with per-directed-edge attributes. Returns (n_kept, senders, receivers,
        kept_names, link_ids_per_directed_edge)."""
        names = self.node_names
        if keep_nodes is None:
            kept = names
        else:
            keep = set(keep_nodes)
            kept = [n for n in names if n in keep]
        kidx = {n: i for i, n in enumerate(kept)}
        s, r, lid = [], [], []
        for li, link in enumerate(self.links):
            a, b = link.node1, link.node2
            if a in kidx and b in kidx:
                s += [kidx[a], kidx[b]]
                r += [kidx[b], kidx[a]]
                lid += [li, li]
        return (
            len(kept),
            np.array(s, np.int32),
            np.array(r, np.int32),
            kept,
            np.array(lid, np.int32),
        )

    def get_pattern(self, pid: Optional[str]) -> list[float]:
        if pid is None or pid not in self.patterns:
            return [1.0]
        return self.patterns[pid]


def _tokens(line: str) -> list[str]:
    line = line.split(";", 1)[0].strip()
    if not line:
        return []
    return re.split(r"[\s\t]+", line)


def parse_inp(path_or_text: str) -> WaterNetwork:
    """Parse an INP file path or raw INP text."""
    if "\n" in path_or_text or "[" == path_or_text.lstrip()[:1]:
        text = path_or_text
    else:
        with open(path_or_text, "r", errors="replace") as f:
            text = f.read()
        if text.startswith("version https://git-lfs"):
            raise ValueError(
                f"{path_or_text} is a git-LFS pointer, not a real INP file"
            )

    wn = WaterNetwork()
    section = None
    pattern_acc: dict[str, list[float]] = {}
    curve_acc: dict[str, list[tuple[float, float]]] = {}

    for raw in text.splitlines():
        stripped = raw.split(";", 1)[0].strip()
        if not stripped:
            continue
        m = re.match(r"\[(.+?)\]", stripped)
        if m:
            section = m.group(1).upper().strip()
            continue
        toks = _tokens(raw)
        if not toks or section is None:
            continue

        if section == "TITLE":
            wn.title.append(stripped)
        elif section == "JUNCTIONS":
            j = Junction(id=toks[0])
            if len(toks) > 1: j.elevation = float(toks[1])
            if len(toks) > 2: j.base_demand = float(toks[2])
            if len(toks) > 3: j.pattern = toks[3]
            wn.junctions.append(j)
        elif section == "RESERVOIRS":
            r = Reservoir(id=toks[0])
            if len(toks) > 1: r.head = float(toks[1])
            if len(toks) > 2: r.pattern = toks[2]
            wn.reservoirs.append(r)
        elif section == "TANKS":
            t = Tank(id=toks[0])
            vals = toks[1:]
            fields = ["elevation", "init_level", "min_level", "max_level",
                      "diameter", "min_vol"]
            for f_, v in zip(fields, vals):
                setattr(t, f_, float(v))
            if len(vals) > 6 and vals[6] != "*":
                t.vol_curve = vals[6]
            wn.tanks.append(t)
        elif section == "PIPES":
            p = Pipe(id=toks[0], node1=toks[1], node2=toks[2])
            vals = toks[3:]
            fields = ["length", "diameter", "roughness", "minor_loss"]
            for f_, v in zip(fields, vals):
                setattr(p, f_, float(v))
            if len(vals) > 4:
                p.status = vals[4].upper()
            wn.pipes.append(p)
        elif section == "PUMPS":
            p = Pump(id=toks[0], node1=toks[1], node2=toks[2])
            i = 3
            while i + 1 < len(toks) + 1 and i < len(toks):
                kw = toks[i].upper()
                if kw == "HEAD" and i + 1 < len(toks):
                    p.head_curve = toks[i + 1]; i += 2
                elif kw == "POWER" and i + 1 < len(toks):
                    p.power = float(toks[i + 1]); i += 2
                elif kw == "SPEED" and i + 1 < len(toks):
                    p.speed = float(toks[i + 1]); i += 2
                elif kw == "PATTERN" and i + 1 < len(toks):
                    p.pattern = toks[i + 1]; i += 2
                else:
                    i += 1
            wn.pumps.append(p)
        elif section == "VALVES":
            v = Valve(id=toks[0], node1=toks[1], node2=toks[2])
            if len(toks) > 3: v.diameter = float(toks[3])
            if len(toks) > 4: v.valve_type = toks[4].upper()
            if len(toks) > 5:
                try:
                    v.setting = float(toks[5])
                except ValueError:
                    v.setting = 0.0  # GPV curve id — not numeric
            if len(toks) > 6: v.minor_loss = float(toks[6])
            wn.valves.append(v)
        elif section == "DEMANDS":
            jid = toks[0]
            base = float(toks[1]) if len(toks) > 1 else 0.0
            pat = toks[2] if len(toks) > 2 else None
            for j in wn.junctions:
                if j.id == jid:
                    j.demand_categories.append((base, pat))
                    break
        elif section == "EMITTERS":
            jid = toks[0]
            coeff = float(toks[1]) if len(toks) > 1 else 0.0
            for j in wn.junctions:
                if j.id == jid:
                    j.emitter = coeff
                    break
        elif section == "PATTERNS":
            pattern_acc.setdefault(toks[0], []).extend(float(t) for t in toks[1:])
        elif section == "CURVES":
            if len(toks) >= 3:
                curve_acc.setdefault(toks[0], []).append(
                    (float(toks[1]), float(toks[2]))
                )
        elif section == "STATUS":
            lid, val = toks[0], toks[1].upper() if len(toks) > 1 else "OPEN"
            for link in wn.links:
                if link.id == lid:
                    if val in ("OPEN", "CLOSED"):
                        link.status = val
                    else:  # numeric → setting (pump speed / valve setting)
                        if isinstance(link, Pump):
                            link.speed = float(val)
                        elif isinstance(link, Valve):
                            link.setting = float(val)
                    break
        elif section == "OPTIONS":
            kw = toks[0].upper()
            if kw == "UNITS" and len(toks) > 1:
                wn.options.units = toks[1].upper()
            elif kw == "HEADLOSS" and len(toks) > 1:
                wn.options.headloss = toks[1].upper()
            elif kw == "TRIALS" and len(toks) > 1:
                wn.options.trials = int(float(toks[1]))
            elif kw == "ACCURACY" and len(toks) > 1:
                wn.options.accuracy = float(toks[1])
            elif kw == "VISCOSITY" and len(toks) > 1:
                wn.options.viscosity = float(toks[1])
            elif kw == "SPECIFIC" and len(toks) > 2:  # SPECIFIC GRAVITY x
                wn.options.specific_gravity = float(toks[2])
            elif kw == "DEMAND" and len(toks) > 2:  # DEMAND MULTIPLIER x
                wn.options.demand_multiplier = float(toks[2])
        elif section == "TIMES":
            wn.times[" ".join(toks[:-1]).upper()] = toks[-1]
        elif section == "COORDINATES":
            if len(toks) >= 3:
                wn.coordinates[toks[0]] = (float(toks[1]), float(toks[2]))

    wn.patterns = pattern_acc
    wn.curves = curve_acc
    return wn


def write_inp(wn: WaterNetwork, path: Optional[str] = None) -> str:
    """Serialize a WaterNetwork back to INP text (round-trip support for the
    config-creator and synthetic network generator)."""
    L = ["[TITLE]"] + (wn.title or ["generated"])
    L.append("")
    L.append("[JUNCTIONS]")
    L.append(";ID Elev Demand Pattern")
    for j in wn.junctions:
        L.append(f" {j.id} {j.elevation:.6g} {j.base_demand:.10g} {j.pattern or ''}".rstrip())
    L.append("")
    L.append("[RESERVOIRS]")
    for r in wn.reservoirs:
        L.append(f" {r.id} {r.head:.6g} {r.pattern or ''}".rstrip())
    L.append("")
    L.append("[TANKS]")
    for t in wn.tanks:
        L.append(
            f" {t.id} {t.elevation:.6g} {t.init_level:.6g} {t.min_level:.6g} "
            f"{t.max_level:.6g} {t.diameter:.6g} {t.min_vol:.6g}"
        )
    L.append("")
    L.append("[PIPES]")
    L.append(";ID Node1 Node2 Length Diameter Roughness MinorLoss Status")
    for p in wn.pipes:
        L.append(
            f" {p.id} {p.node1} {p.node2} {p.length:.6g} {p.diameter:.6g} "
            f"{p.roughness:.6g} {p.minor_loss:.6g} {p.status}"
        )
    L.append("")
    L.append("[PUMPS]")
    for p in wn.pumps:
        spec = ""
        if p.head_curve: spec += f" HEAD {p.head_curve}"
        if p.power is not None: spec += f" POWER {p.power:.6g}"
        if p.speed != 1.0: spec += f" SPEED {p.speed:.6g}"
        if p.pattern: spec += f" PATTERN {p.pattern}"
        L.append(f" {p.id} {p.node1} {p.node2}{spec}")
    L.append("")
    L.append("[VALVES]")
    for v in wn.valves:
        L.append(
            f" {v.id} {v.node1} {v.node2} {v.diameter:.6g} {v.valve_type} "
            f"{v.setting:.6g} {v.minor_loss:.6g}"
        )
    L.append("")
    L.append("[DEMANDS]")
    for j in wn.junctions:
        for base, pat in j.demand_categories:
            L.append(f" {j.id} {base:.10g} {pat or ''}".rstrip())
    L.append("")
    L.append("[PATTERNS]")
    for pid, vals in wn.patterns.items():
        for i in range(0, len(vals), 6):
            chunk = " ".join(f"{v:.6g}" for v in vals[i : i + 6])
            L.append(f" {pid} {chunk}")
    L.append("")
    L.append("[CURVES]")
    for cid, pts in wn.curves.items():
        for x, y in pts:
            L.append(f" {cid} {x:.6g} {y:.6g}")
    L.append("")
    L.append("[STATUS]")
    for p in wn.pipes:
        if p.status == "CLOSED":
            L.append(f" {p.id} CLOSED")
    for p in wn.pumps:
        if p.status == "CLOSED":
            L.append(f" {p.id} CLOSED")
    L.append("")
    L.append("[OPTIONS]")
    o = wn.options
    L.append(f" UNITS {o.units}")
    L.append(f" HEADLOSS {o.headloss}")
    L.append(f" TRIALS {o.trials}")
    L.append(f" ACCURACY {o.accuracy:.6g}")
    L.append(f" DEMAND MULTIPLIER {o.demand_multiplier:.6g}")
    L.append("")
    L.append("[TIMES]")
    L.append(" DURATION 0")
    L.append("")
    L.append("[COORDINATES]")
    for nid, (x, y) in wn.coordinates.items():
        L.append(f" {nid} {x:.6g} {y:.6g}")
    L.append("")
    L.append("[END]")
    text = "\n".join(L) + "\n"
    if path:
        with open(path, "w") as f:
            f.write(text)
    return text
