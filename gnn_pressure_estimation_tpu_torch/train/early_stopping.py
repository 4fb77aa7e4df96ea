"""Patience-based early stopping: min/max mode, absolute or percentage
delta, a NaN metric stops at once, patience 0 disables.

A copy of ``gnn_pressure_estimation_tpu/train/early_stopping.py`` (pure
Python), kept here so the PyTorch package imports nothing of the JAX package.
"""

from __future__ import annotations

import math


class EarlyStopping:
    def __init__(self, mode: str = "min", min_delta: float = 0.0,
                 patience: int = 10, percentage: bool = False):
        if mode not in ("min", "max"):
            raise ValueError(f"mode {mode!r} is unknown")
        self.mode = mode
        self.min_delta = min_delta
        self.patience = patience
        self.percentage = percentage
        self.best: float | None = None
        self.num_bad_epochs = 0

    def _is_better(self, a: float, best: float) -> bool:
        delta = (abs(best) * self.min_delta / 100) if self.percentage else self.min_delta
        if self.mode == "min":
            return a < best - delta
        return a > best + delta

    def state_dict(self) -> dict:
        return {"best": self.best, "num_bad_epochs": self.num_bad_epochs}

    def load_state_dict(self, state: dict):
        self.best = state.get("best")
        self.num_bad_epochs = int(state.get("num_bad_epochs", 0))

    def step(self, metric: float) -> bool:
        """Returns True when training should stop."""
        if self.patience == 0:
            return False
        metric = float(metric)
        if self.best is None:
            self.best = metric
            return False
        if math.isnan(metric):
            return True
        if self._is_better(metric, self.best):
            self.num_bad_epochs = 0
            self.best = metric
        else:
            self.num_bad_epochs += 1
        return self.num_bad_epochs >= self.patience
