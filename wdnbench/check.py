"""The numbers that decide ``correct``: the program's outputs against the plain
reference's, each beside its limit (``limits/<cell>.json``).

Leaf norms are compared as the gap of the two norms, not the norm of the
difference, against the reference leaf's norm or the median leaf's,
whichever is larger, so that an all-but-zero leaf does not read as large.
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch


def leaf_norms(leaves: dict) -> dict:
    return {name: float(t.detach().double().norm()) for name, t in leaves.items()}


def leaf_gaps(prog: dict, ref: dict, names=None) -> dict:
    """Per leaf ``|‖prog‖ - ‖ref‖| / max(‖ref‖, median leaf ‖ref‖)`` over
    ``names`` (every leaf if None)."""
    names = list(ref) if names is None else list(names)
    np_, nr = leaf_norms({n: prog[n] for n in names}), leaf_norms({n: ref[n] for n in names})
    med = statistics.median(nr.values())
    return {n: abs(np_[n] - nr[n]) / max(nr[n], med) if max(nr[n], med) > 0 else math.inf
            for n in names}


def moving_leaves(grad1_ref: dict, share: float = 1e-3) -> list:
    """The leaves whose reference gradient is not nought to rounding: a norm
    at least ``share`` of the median leaf's. Adam moves the others by
    round-off alone."""
    norms = leaf_norms(grad1_ref)
    med = statistics.median(norms.values())
    return [n for n, v in norms.items() if v >= share * med]


def worst(gaps: dict) -> tuple:
    name = max(gaps, key=lambda n: gaps[n])
    return gaps[name], name


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: ``losses`` (a step each), ``grad1`` (the first
    gradient as Adam receives it), ``params0`` and ``params`` (the weights
    before the first step and after the last), and, where the window ran,
    ``wgrad``: the gradient Adam received in a step from the state the
    window left, at the same weights on both sides.

    Held: the first step's loss, the first gradient by the worst leaf, the
    change of the weights by the median leaf, the window's end gradient by
    the worst leaf. Adam's first steps move every
    entry by lr times the sign of its gradient, so an entry whose gradient is
    round-off moves by lr either way, and the steps after the first carry
    that: the later losses and the worst leaf's change swing from seed to
    seed as far as the control reads. They are reported, not limited."""
    lp, lr = prog["losses"], ref["losses"]
    gaps = [abs(a - b) / abs(b) if b and math.isfinite(a) else math.inf for a, b in zip(lp, lr)]
    g_gap, g_leaf = worst(leaf_gaps(prog["grad1"], ref["grad1"]))
    keep = moving_leaves(ref["grad1"])
    d_prog = {n: prog["params"][n] - prog["params0"][n] for n in keep}
    d_ref = {n: ref["params"][n] - ref["params0"][n] for n in keep}
    c_gaps = leaf_gaps(d_prog, d_ref)
    c_gap, c_leaf = worst(c_gaps)
    out = {"loss1_gap": gaps[0], "grad1_gap": g_gap,
           "change3_median_gap": statistics.median(c_gaps.values())}
    if "wgrad" in ref:
        out["wgrad_gap"], out["_wgrad_leaf"] = worst(leaf_gaps(prog["wgrad"], ref["wgrad"]))
    return {**out, "_loss_gaps": gaps, "_grad1_leaf": g_leaf, "_change3_worst_gap": c_gap,
            "_change3_worst_leaf": c_leaf, "_leaves_left_out": len(ref["grad1"]) - len(keep)}


def serve_numbers(pred: np.ndarray, ref: np.ndarray, readings: np.ndarray,
                  observed: np.ndarray, mean: float) -> dict:
    """``pred`` and ``ref`` [S, n] served fields in metres; ``readings``
    [S, k] at ``observed``. ``field_gap``: the widest gap, as a share of the
    widest departure of the reference's field from the scaling mean;
    ``observed_gap``: the served readings against the readings given."""
    if not np.isfinite(pred).all():
        return {"field_gap": math.inf, "observed_gap": math.inf}
    scale = float(np.abs(ref - mean).max())
    return {"field_gap": float(np.abs(pred - ref).max()) / scale,
            "observed_gap": float(np.abs(pred[:, observed] - readings).max())}


def judge(numbers: dict, limits: dict) -> tuple:
    """``(correct, checks)``: every limited number at or under its limit.
    Keys that start with ``_`` are reported and not limited."""
    checks, ok = {}, True
    for name, value in numbers.items():
        if name.startswith("_"):
            continue
        limit = limits.get(name)
        good = limit is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def to_host(leaves: dict) -> dict:
    return {n: t.detach().to("cpu", torch.float32).clone() for n, t in leaves.items()}
