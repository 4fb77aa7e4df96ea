"""The bodies of the per-layer metrics read from the program's own spans
(``gnn_pressure_estimation_tpu_torch.utils.tracing``), which it keeps in
memory: set-up spans always, the entries' spans while a profiler records,
as in the traced window.

A program without that module reads as nothing (None), so each metric is
left out of its line there, not raised.
"""

from __future__ import annotations

import importlib
import statistics

TRACING = "gnn_pressure_estimation_tpu_torch.utils.tracing"
GRAPH_LAYOUT = ("inp.parse", "template.build", "graph.batch", "graph.band_layout",
                "graph.band_index")


def program_tracing():
    """The program's span recorder, or None where it has none."""
    try:
        return importlib.import_module(TRACING)
    except ModuleNotFoundError:
        return None


def program_spans():
    """The program's stored spans, or None where it records none."""
    tracing = program_tracing()
    return None if tracing is None else tracing.spans()


def outermost_s(names) -> float:
    """Host seconds in the spans named ``names`` that run inside none of
    them (a nested one is counted once, in its outermost)."""
    spans = program_spans()
    if spans is None:
        return None
    names = set(names)
    by_id = {s.span_id: s for s in spans}

    def inside(s) -> bool:
        p = by_id.get(s.parent_id)
        while p is not None:
            if p.name in names:
                return True
            p = by_id.get(p.parent_id)
        return False
    return 1e-9 * sum(s.duration_ns for s in spans if s.name in names and not inside(s))


def window_median_ms(ctx, root: str, parts) -> float:
    """The median over the traced window's requests or steps (the last
    ``iters`` root spans named ``root``) of the host milliseconds in their
    child spans named ``parts``, each less the spans inside it (its own
    time: ``train.prepare`` without its ``train.upload``)."""
    tracing = program_tracing()
    if tracing is None:
        return None
    spans = tracing.spans()
    roots = [s for s in spans if s.name == root and s.parent_id is None][-ctx["trace"]["iters"]:]
    if not roots:
        return None
    parts, ids = set(parts), {s.span_id for s in roots}
    own = tracing.self_ns(spans)
    per_root = dict.fromkeys(ids, 0)
    for s in spans:
        if s.parent_id in ids and s.name in parts:
            per_root[s.parent_id] += own[s.span_id]
    return 1e-6 * statistics.median(per_root.values())
