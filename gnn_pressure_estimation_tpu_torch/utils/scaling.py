"""Normalization: znorm / minmax scale + descale, with a typed stats carrier.

Mirrors reference utils/auxil.py:18-64 but fixes its zero-stat failure mode:
the reference ``assert mean and std`` / ``assert min and max`` crash whenever a
statistic is exactly 0.0 (SURVEY.md §2 quirks). Here everything is eps-guarded
and works for scalars, NumPy arrays or torch tensors.

A copy of ``gnn_pressure_estimation_tpu/utils/scaling.py``, kept here so the
PyTorch package imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class NormStats:
    """The normalization contract carried through datasets and checkpoints
    (reference saves mean/std/min/max + edge stats + norm_type in every
    checkpoint — train.py:433-451, auxil.py:223-233)."""

    norm_type: str = "znorm"  # znorm | minmax | unused
    mean: float = 0.0
    std: float = 1.0
    min: float = 0.0
    max: float = 1.0
    edge_mean: Optional[Any] = None
    edge_std: Optional[Any] = None
    edge_min: Optional[Any] = None
    edge_max: Optional[Any] = None

    @staticmethod
    def from_array(arr, norm_type: str = "znorm") -> "NormStats":
        flat = np.asarray(arr, dtype=np.float64).ravel()
        return NormStats(norm_type=norm_type, mean=float(flat.mean()), std=float(flat.std()),
                         min=float(flat.min()), max=float(flat.max()))

    def with_edge_stats(self, edge_arr) -> "NormStats":
        ea = np.asarray(edge_arr, dtype=np.float64)
        return dataclasses.replace(self, edge_mean=ea.mean(axis=0), edge_std=ea.std(axis=0),
                                   edge_min=ea.min(axis=0), edge_max=ea.max(axis=0))

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        for k, v in d.items():
            if isinstance(v, np.ndarray):
                d[k] = v.tolist()
        return d

    @staticmethod
    def from_dict(d: dict) -> "NormStats":
        """The inverse of :meth:`to_dict`; reads the JAX package's dict too."""
        d = dict(d)
        for k in ("edge_mean", "edge_std", "edge_min", "edge_max"):
            if d.get(k) is not None:
                d[k] = np.asarray(d[k], dtype=np.float64)
        return NormStats(**d)


def scale(data, norm_type: str = "znorm", mean=None, std=None, min=None, max=None):
    """Normalize ``data``. eps-guarded; ``unused`` passes through."""
    if norm_type == "minmax":
        rng = max - min
        denom = rng + (rng == 0) * EPS  # eps only where the range collapses
        return (data - min) / denom
    if norm_type == "znorm":
        return (data - mean) / (std + EPS)
    return data


def descale(scaled, norm_type: str = "znorm", mean=None, std=None, min=None, max=None):
    """Invert :func:`scale` (reference auxil.py:42-64; note the reference
    descale omits the +eps the forward scale applies — replicated here so the
    round-trip matches reference numerics)."""
    if norm_type == "minmax":
        return scaled * (max - min) + min
    if norm_type == "znorm":
        return scaled * std + mean
    return scaled


def scale_with(data, stats: NormStats):
    return scale(data, stats.norm_type, stats.mean, stats.std, stats.min, stats.max)


def descale_with(scaled, stats: NormStats):
    return descale(scaled, stats.norm_type, stats.mean, stats.std, stats.min, stats.max)


def scale_edges_with(edge_attr, stats: NormStats):
    return scale(edge_attr, stats.norm_type, stats.edge_mean, stats.edge_std,
                 stats.edge_min, stats.edge_max)
