"""Evaluation metrics on descaled (physical-unit) masked pressures.

The counterpart of ``gnn_pressure_estimation_tpu/utils/metrics.py``, with
its definitions: rel_error (|y| > 0.01 guard), acc@threshold, Pearson corr
(clamped to [-1, 1]), r², MAE, RMSE, NSE. All functions take tensors of one
shape and return 0-d tensors.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import torch


def nse(y_pred, y_true, exponent: int = 2):
    """Nash–Sutcliffe efficiency."""
    p, t = y_pred.reshape(-1), y_true.reshape(-1)
    num = torch.sum((p - t) ** exponent)
    den = torch.sum((t - t.mean()) ** exponent) + 1e-12
    return 1.0 - num / den


def rmse(y_pred, y_true):
    return torch.sqrt(torch.mean((y_pred - y_true) ** 2))


def mae(y_pred, y_true):
    return torch.mean(torch.abs(y_pred - y_true))


def rel_error(y_pred, y_true):
    """Mean |err / y_true| over entries with |y_true| > 0.01."""
    err = torch.abs(y_true - y_pred)
    valid = torch.abs(y_true) > 0.01
    rel = torch.where(valid, torch.abs(err / torch.where(valid, y_true, 1.0)), 0.0)
    return rel.sum() / valid.sum().clamp(min=1)


def accuracy(y_pred, y_true, threshold: float = 0.1):
    """Fraction with |err| <= y_true * threshold. The bound is the *signed*
    ``y_true * threshold``, as in the reference and the JAX package, so a
    negative truth always counts as a miss."""
    err = torch.abs(y_true - y_pred)
    return (err <= y_true * threshold).to(torch.float32).mean()


def correlation(y_pred, y_true):
    vx = y_pred - y_pred.mean()
    vy = y_true - y_true.mean()
    denom = torch.sqrt(torch.sum(vx ** 2)) * torch.sqrt(torch.sum(vy ** 2))
    return torch.clamp(torch.sum(vx * vy) / denom, -1.0, 1.0)


def r2(y_pred, y_true):
    return correlation(y_pred, y_true) ** 2


def metric_collection(prefix: str) -> dict[str, Callable]:
    """Name → callable registry (the reference's naming)."""
    return {
        f"{prefix}_error": rel_error,
        f"{prefix}_0.1": partial(accuracy, threshold=0.1),
        f"{prefix}_corr": correlation,
        f"{prefix}_r2": r2,
        f"{prefix}_mae": mae,
        f"{prefix}_rmse": rmse,
        f"{prefix}_mynse": partial(nse, exponent=2),
    }


def compute_all(y_pred, y_true, prefix: str) -> dict[str, torch.Tensor]:
    return {k: fn(y_pred, y_true) for k, fn in metric_collection(prefix).items()}


# ---- moment-based variants ---------------------------------------------------
# The masked loss path keeps no gather: the metrics come from sums over the
# mask-weighted arrays, which also add up across shards.

def masked_moments(y_pred, y_true, mask) -> dict[str, torch.Tensor]:
    """Sufficient statistics over the masked nodes (``mask``: 0/1 floats or
    bool, same shape as the values)."""
    m = mask.to(torch.float32).reshape(-1)
    on = m > 0
    p = y_pred.reshape(-1) * m
    t = y_true.reshape(-1) * m
    err = p - t
    valid = (torch.abs(t) > 0.01) & on
    rel = torch.where(valid, torch.abs(err / torch.where(valid, t, 1.0)), 0.0)
    acc = (torch.abs(err) <= t * 0.1) & on
    return {
        "count": m.sum(),
        "sum_p": p.sum(),
        "sum_t": t.sum(),
        "sum_pp": (p * p).sum(),
        "sum_tt": (t * t).sum(),
        "sum_pt": (p * t).sum(),
        "sum_abs_err": torch.abs(err).sum(),
        "sum_sq_err": (err * err).sum(),
        "sum_rel": rel.sum(),
        "count_rel": valid.to(torch.float32).sum(),
        "sum_acc": acc.to(torch.float32).sum(),
    }


def metrics_from_moments(mo: dict, prefix: str) -> dict[str, torch.Tensor]:
    """The seven metrics from (summed) moments: algebraically the direct
    formulas of this module."""
    n = mo["count"].clamp(min=1.0)
    mean_p = mo["sum_p"] / n
    mean_t = mo["sum_t"] / n
    var_p = mo["sum_pp"] / n - mean_p ** 2
    var_t = mo["sum_tt"] / n - mean_t ** 2
    cov = mo["sum_pt"] / n - mean_p * mean_t
    corr = torch.clamp(cov / torch.sqrt((var_p * var_t).clamp(min=1e-24)), -1.0, 1.0)
    sst = mo["sum_tt"] - mo["sum_t"] ** 2 / n
    return {
        f"{prefix}_error": mo["sum_rel"] / mo["count_rel"].clamp(min=1.0),
        f"{prefix}_0.1": mo["sum_acc"] / n,
        f"{prefix}_corr": corr,
        f"{prefix}_r2": corr ** 2,
        f"{prefix}_mae": mo["sum_abs_err"] / n,
        f"{prefix}_rmse": torch.sqrt(mo["sum_sq_err"] / n),
        f"{prefix}_mynse": 1.0 - mo["sum_sq_err"] / (sst + 1e-12),
    }
