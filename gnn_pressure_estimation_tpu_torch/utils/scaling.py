"""Normalization: znorm / minmax scale + descale, with a typed stats carrier.

Mirrors reference utils/auxil.py:18-64 but fixes its zero-stat failure mode:
the reference ``assert mean and std`` / ``assert min and max`` crash whenever a
statistic is exactly 0.0 (SURVEY.md §2 quirks). Here everything is eps-guarded
and works for scalars, NumPy arrays or torch tensors.

A copy of ``gnn_pressure_estimation_tpu/utils/scaling.py`` without the edge
statistics (GATRes takes no edge attributes), kept here so the PyTorch
package imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses

EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class NormStats:
    """The normalization contract a model was trained under (reference
    train.py:433-451, auxil.py:223-233); the JAX package's edge statistics
    are left out, since GATRes takes no edge attributes."""

    norm_type: str = "znorm"  # znorm | minmax | unused
    mean: float = 0.0
    std: float = 1.0
    min: float = 0.0
    max: float = 1.0


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

