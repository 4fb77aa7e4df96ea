"""The benchmark's own reading of a network file: the junctions and the links
between them, for the plain reference.

An EPANET INP file, gzipped or not: the junctions of ``[JUNCTIONS]`` in the
file's order, and every pipe, pump and valve whose two ends are junctions,
as two directed edges. That is the graph the program builds with its
``keep_junction`` removal, read here without any of the program's code.
"""

from __future__ import annotations

import gzip
from pathlib import Path

import numpy as np

LINK_SECTIONS = ("PIPES", "PUMPS", "VALVES")


def read_text(path) -> str:
    path = Path(path)
    if path.suffix == ".gz":
        with gzip.open(path, "rt") as f:
            return f.read()
    return path.read_text()


def junction_graph(text: str):
    """``(names, senders, receivers)``: junction names in file order and the
    directed edges between junctions (each link in both directions)."""
    section, names, links = None, [], []
    for raw in text.splitlines():
        line = raw.split(";", 1)[0].strip()
        if not line:
            continue
        if line.startswith("["):
            section = line.strip("[]").upper()
            continue
        toks = line.split()
        if section == "JUNCTIONS":
            names.append(toks[0])
        elif section in LINK_SECTIONS:
            links.append((toks[1], toks[2]))
    index = {nm: i for i, nm in enumerate(names)}
    pairs = np.array([(index[a], index[b]) for a, b in links if a in index and b in index],
                     np.int64).reshape(-1, 2)
    senders = np.concatenate([pairs[:, 0], pairs[:, 1]])
    receivers = np.concatenate([pairs[:, 1], pairs[:, 0]])
    return names, senders, receivers
