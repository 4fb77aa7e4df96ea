"""AutoClip — adaptive percentile gradient clipping (Seetharaman et al. 2020).

The counterpart of ``gnn_pressure_estimation_tpu/train/autoclip.py``: keep a
ring buffer of the last ``history_len`` global gradient norms and clip each
step's gradients to the p-th percentile (linear interpolation) of the norms
seen so far, this step's included. The buffer lives on the gradients' device
and the step makes no host sync.
"""

from __future__ import annotations

from typing import Iterable

import torch


def percentile_of_filled(history: torch.Tensor, count: torch.Tensor, pct: float) -> torch.Tensor:
    """``np.percentile(history[:count], pct)`` with linear interpolation,
    without leaving the device: unfilled slots sort last as +inf and are
    never picked (the rank stays below ``count``)."""
    idx = torch.arange(history.shape[0], device=history.device)
    vals = torch.where(idx < count, history, torch.full_like(history, float("inf")))
    s = torch.sort(vals).values
    rank = (count - 1).to(torch.float32) * (pct / 100.0)
    lo = torch.floor(rank).long()
    hi = torch.ceil(rank).long()
    frac = rank - lo.to(torch.float32)
    return s[lo] * (1.0 - frac) + s[hi] * frac


class AutoClip:
    """``clip_(parameters)`` scales the ``.grad``s in place by
    ``min(1, clip / (norm + 1e-6))`` (``torch.nn.utils.clip_grad_norm_``'s
    rule), ``clip`` being the running percentile of the global norms."""

    def __init__(self, percentile: float = 10.0, history_len: int = 1024, device="cpu"):
        self.percentile = percentile
        self.history = torch.zeros(history_len, dtype=torch.float32, device=device)
        self.count = torch.zeros((), dtype=torch.int64, device=device)   # norms written so far
        self.last_clip_value: torch.Tensor | None = None

    @torch.no_grad()
    def clip_(self, parameters: Iterable[torch.Tensor]) -> torch.Tensor:
        """Returns the global gradient norm before clipping (0-d tensor)."""
        grads = [p.grad for p in parameters if p.grad is not None]
        norm = torch.sqrt(sum((g.to(torch.float32) ** 2).sum() for g in grads))
        n = self.history.shape[0]
        self.history[self.count % n] = norm
        self.count += 1
        clip_value = percentile_of_filled(self.history, self.count.clamp(max=n), self.percentile)
        scale = torch.clamp(clip_value / (norm + 1e-6), max=1.0)
        for g in grads:
            g.mul_(scale)
        self.last_clip_value = clip_value
        return norm

    def state_dict(self) -> dict[str, torch.Tensor]:
        return {"history": self.history.clone(), "count": self.count.clone()}

    def load_state_dict(self, state: dict):
        self.history.copy_(state["history"])
        self.count.copy_(state["count"])
