"""Synthetic water-distribution-network generator (numpy only).

A copy of ``gnn_pressure_estimation_tpu/simgen/netgen.py``, kept here so the
PyTorch package imports nothing of the JAX package; the same seed gives the
same network through either.

The reference benchmarks on C-Town (inputs/ctown.inp), which ships only as a
git-LFS pointer in the snapshot (inputs/ctown.inp:1-3) — the real file is not
available here. This module synthesizes realistic WDN topologies at arbitrary
scale so the full pipeline (generation → training → evaluation → scaling
benchmarks) runs end-to-end: jittered street grids with loops and pruned
edges, a smooth elevation field, edge reservoirs feeding through pump
stations, tanks on high points, PRV-regulated pressure zones.

``make_ctown_like(n≈388)`` approximates C-Town's scale (388 junctions,
429 pipes, 1 reservoir, 7 tanks, 11 pumps, 4 valves); larger calls stress
SpMM at Oosterbeek-like scale.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from gnn_pressure_estimation_tpu_torch.data.inp import (
    Junction,
    Pipe,
    Pump,
    Reservoir,
    Tank,
    Valve,
    WaterNetwork,
    write_inp,
)


def make_wdn(
    n_junctions: int = 388,
    n_reservoirs: int = 1,
    n_tanks: int = 7,
    n_pumps: int = 11,
    n_valves: int = 4,
    seed: int = 0,
    units: str = "LPS",
    prune: float = 0.25,
    name: str = "synthtown",
) -> WaterNetwork:
    rng = np.random.default_rng(seed)
    wn = WaterNetwork()
    wn.title = [f"{name}: synthetic WDN ({n_junctions} junctions, seed {seed})"]
    wn.options.units = units
    wn.options.headloss = "H-W"

    side = int(math.ceil(math.sqrt(n_junctions)))
    spacing = 120.0  # m between blocks

    # smooth elevation field: sum of a few random low-frequency bumps
    kx = rng.uniform(0.2, 1.2, 4)
    ky = rng.uniform(0.2, 1.2, 4)
    ph = rng.uniform(0, 2 * np.pi, 4)
    amp = rng.uniform(5, 25, 4)

    def elev(x, y):
        u, v = x / (side * spacing), y / (side * spacing)
        return 20.0 + sum(
            a * np.sin(2 * np.pi * (k1 * u + k2 * v) + p)
            for a, k1, k2, p in zip(amp, kx, ky, ph)
        )

    # junction grid with jitter, trimmed to n_junctions. Demands shrink with
    # network size (large systems have lower per-node draw once the same
    # city is modeled at finer granularity) so total demand stays servable.
    dmd_scale = min(1.0, (600.0 / max(n_junctions, 1)) ** 0.5)
    coords = {}
    jids = []
    for i in range(n_junctions):
        r, c = divmod(i, side)
        x = c * spacing + rng.uniform(-0.25, 0.25) * spacing
        y = r * spacing + rng.uniform(-0.25, 0.25) * spacing
        jid = f"J{i}"
        e = float(elev(x, y))
        base = float(rng.uniform(0.1, 2.0)) * dmd_scale  # LPS-ish demands
        wn.junctions.append(Junction(id=jid, elevation=round(e, 2),
                                     base_demand=round(base, 4)))
        coords[jid] = (round(x, 1), round(y, 1))
        jids.append(jid)
    wn.coordinates.update(coords)
    total_dmd = float(sum(j.base_demand for j in wn.junctions))

    # grid edges + some diagonals; prune a fraction while keeping connectivity
    edges = []
    def jidx(r, c):
        i = r * side + c
        return i if i < n_junctions else None
    for r in range(side):
        for c in range(side):
            i = jidx(r, c)
            if i is None:
                continue
            for dr, dc in ((0, 1), (1, 0)):
                j = jidx(r + dr, c + dc)
                if j is not None:
                    edges.append((i, j))
            if rng.random() < 0.08:
                j = jidx(r + 1, c + 1)
                if j is not None:
                    edges.append((i, j))

    # spanning tree first (kept), prune some of the rest
    parent = list(range(n_junctions))
    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a
    rng.shuffle(edges)
    kept = []
    extra = []
    for (a, b) in edges:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb
            kept.append((a, b))
        else:
            extra.append((a, b))
    for e in extra:
        if rng.random() > prune:
            kept.append(e)

    def dist(a, b):
        xa, ya = coords[jids[a]]
        xb, yb = coords[jids[b]]
        return math.hypot(xa - xb, ya - yb)

    # distribution pipes, with a trunk-main hierarchy on every
    # (side//12)-th grid line (min every 4th) so large networks have the
    # transmission capacity to carry their aggregate demand (uniform small
    # mains collapse pressure at >5k nodes)
    trunk_every = max(side // 12, 4)

    def on_trunk(i):
        r, c = divmod(i, side)
        return r % trunk_every == 0 or c % trunk_every == 0

    for pid, (a, b) in enumerate(kept):
        if on_trunk(a) and on_trunk(b):
            dia = float(rng.choice([610, 762, 914, 1067]))
        else:
            dia = float(rng.choice([102, 152, 203, 254, 305, 406, 508, 610]))
        wn.pipes.append(Pipe(
            id=f"P{pid}", node1=jids[a], node2=jids[b],
            length=round(max(dist(a, b), 10.0) * rng.uniform(0.95, 1.3), 1),
            diameter=round(dia, 1),
            roughness=round(float(rng.uniform(70, 140)), 1),
            minor_loss=0.0,
        ))

    elevations = np.array([j.elevation for j in wn.junctions])
    max_ele = float(elevations.max())

    # reservoirs at the lowest corner(s), feeding through pump stations.
    # Station pumps are sized to the network: collectively ~1.4× the total
    # base demand, so generation-time demand perturbations stay servable.
    low_order = np.argsort(elevations)
    pump_per_res = max(n_pumps // max(n_reservoirs, 1), 1)
    n_station = min(n_pumps, pump_per_res * max(n_reservoirs, 1))
    q_design = 1.4 * total_dmd / max(n_station, 1)
    curve_i = 0
    pump_i = 0
    for ri in range(n_reservoirs):
        rid = f"R{ri + 1}"
        head = round(float(elevations.min() - rng.uniform(5, 15)), 2)
        wn.reservoirs.append(Reservoir(id=rid, head=head))
        anchor = jids[int(low_order[ri])]
        ax, ay = coords[anchor]
        wn.coordinates[rid] = (ax - spacing, ay - spacing)
        # pump station: parallel pumps from reservoir into nearby junctions
        targets = [int(low_order[(ri + k) % n_junctions]) for k in range(pump_per_res)]
        for t in targets:
            if pump_i >= n_pumps:
                break
            cid = f"PC{curve_i}"
            q1 = q_design * rng.uniform(0.8, 1.2)   # LPS design flow
            h1 = (max_ele - head) * rng.uniform(1.1, 1.4)
            wn.curves[cid] = [
                (0.0, round(1.4 * h1, 1)),
                (round(q1, 1), round(h1, 1)),
                (round(2 * q1, 1), round(0.25 * h1, 1)),
            ]
            wn.pumps.append(Pump(id=f"PU{pump_i}", node1=rid,
                                 node2=jids[t], head_curve=cid))
            curve_i += 1
            pump_i += 1
    # remaining pumps as in-network boosters
    while pump_i < n_pumps:
        a, b = rng.integers(0, n_junctions, 2)
        if a == b:
            continue
        cid = f"PC{curve_i}"
        q1 = rng.uniform(20, 80)
        h1 = rng.uniform(15, 40)
        wn.curves[cid] = [
            (0.0, round(1.4 * h1, 1)),
            (round(q1, 1), round(h1, 1)),
            (round(2 * q1, 1), round(0.25 * h1, 1)),
        ]
        wn.pumps.append(Pump(id=f"PU{pump_i}", node1=jids[int(a)],
                             node2=jids[int(b)], head_curve=cid))
        curve_i += 1
        pump_i += 1

    # tanks on high points, linked by a short pipe
    high_order = np.argsort(-elevations)
    pid = len(wn.pipes)
    for ti in range(n_tanks):
        tid = f"T{ti + 1}"
        anchor_i = int(high_order[ti * 3 % n_junctions])
        anchor = jids[anchor_i]
        te = elevations[anchor_i] + rng.uniform(10, 30)
        wn.tanks.append(Tank(
            id=tid, elevation=round(float(te), 2),
            init_level=round(float(rng.uniform(1.5, 4.5)), 2),
            min_level=0.0, max_level=round(float(rng.uniform(5, 8)), 2),
            diameter=round(float(rng.uniform(8, 30)), 2), min_vol=0.0,
        ))
        ax, ay = coords[anchor]
        wn.coordinates[tid] = (ax + 0.3 * spacing, ay + 0.3 * spacing)
        wn.pipes.append(Pipe(
            id=f"P{pid}", node1=tid, node2=anchor,
            length=round(rng.uniform(20, 80), 1),
            diameter=round(float(rng.choice([203, 254, 305])), 1),
            roughness=120.0,
        ))
        pid += 1

    # valves: PRVs into lower-elevation zones + one TCV
    for vi in range(n_valves):
        a, b = None, None
        for _ in range(50):
            ca, cb = rng.integers(0, n_junctions, 2)
            if ca != cb and elevations[ca] > elevations[cb] + 5:
                a, b = int(ca), int(cb)
                break
        if a is None:
            a, b = 0, 1
        vt = "PRV" if vi % 4 != 3 else "TCV"
        setting = round(float(rng.uniform(25, 45)), 1) if vt == "PRV" else round(float(rng.uniform(2, 30)), 1)
        wn.valves.append(Valve(
            id=f"V{vi}", node1=jids[a], node2=jids[b],
            diameter=round(float(rng.choice([152, 203, 254])), 1),
            valve_type=vt, setting=setting,
        ))

    return wn


def make_ctown_like(seed: int = 0) -> WaterNetwork:
    """C-Town scale: 388 junctions / 429 pipes-ish / 1 reservoir / 7 tanks /
    11 pumps / 4 valves (reference benchmark network, README.md:24)."""
    return make_wdn(388, 1, 7, 11, 4, seed=seed, name="synthctown")


def make_minitown(seed: int = 1) -> WaterNetwork:
    """Tiny fixture for tests: 25 junctions."""
    return make_wdn(25, 1, 1, 1, 1, seed=seed, prune=0.1, name="minitown")


def make_large(n_junctions: int = 5800, seed: int = 2) -> WaterNetwork:
    """Oosterbeek-scale (~5.8k nodes, reference GraphModels.py:140 constant)
    for SpMM stress benchmarks."""
    return make_wdn(n_junctions, 3, 18, 24, 12, seed=seed, name="bigtown")


def make_mega(n_junctions: int = 23000, seed: int = 7) -> WaterNetwork:
    """4× Oosterbeek (~23k junctions, ~41.5k links): the scale-stress network
    for the banded/halo paths beyond anything the reference handles (its max
    is the 5,855-node Oosterbeek constant, GraphModels.py:140). Deterministic
    — synthesize on demand rather than committing the ~2.7 MB INP
    (``write_inp(make_mega(), path)`` writes it)."""
    return make_wdn(n_junctions, 6, 40, 48, 24, seed=seed, name="meganet")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="Generate synthetic WDN INP files")
    ap.add_argument("--out", required=True)
    ap.add_argument("--junctions", type=int, default=388)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    wn = make_wdn(args.junctions, seed=args.seed)
    write_inp(wn, args.out)
    print(f"wrote {args.out}: {wn.n_nodes} nodes, {wn.n_links} links")
