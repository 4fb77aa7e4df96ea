"""Checkpointing: parameters + optimizer state + the normalization contract.

The counterpart of ``gnn_pressure_estimation_tpu/train/checkpoint.py`` with
the same arguments and the same ``meta`` (epoch, loss, metrics,
``stats.to_dict()``, ``extra``). A checkpoint is one ``torch.save`` file that
holds tensors and one JSON string only, so it loads with
``weights_only=True`` and unpickles no code. Checkpoints of the JAX package
(flax msgpack) are not read here.
"""

from __future__ import annotations

import json
import os
from typing import Mapping, Optional

import torch

from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats


def _cpu_tensors(d: Mapping[str, torch.Tensor], what: str) -> dict[str, torch.Tensor]:
    out = {}
    for k, v in d.items():
        if not isinstance(v, torch.Tensor):
            raise TypeError(f"{what}[{k!r}] is {type(v).__name__}, not a tensor")
        out[k] = v.detach().cpu()
    return out


def save_checkpoint(
    path: str,
    params: Mapping[str, torch.Tensor],
    opt_state: Optional[Mapping[str, torch.Tensor]] = None,
    epoch: int = 0,
    loss: float = 0.0,
    metrics: Optional[dict] = None,
    stats: Optional[NormStats] = None,
    extra: Optional[dict] = None,
) -> str:
    """``params``: a ``state_dict``; ``opt_state``: a flat name → tensor dict
    (``Trainer.opt_state_dict()``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    meta = {
        "epoch": int(epoch),
        "loss": float(loss),
        "metrics": {k: float(v) for k, v in (metrics or {}).items()},
        "stats": stats.to_dict() if stats is not None else None,
        "extra": extra or {},
    }
    payload = {
        "params": _cpu_tensors(params, "params"),
        "opt_state": _cpu_tensors(opt_state, "opt_state") if opt_state is not None else {},
        "meta_json": json.dumps(meta),
    }
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)       # a run cut mid-write leaves the old file whole
    return path


def _like(got: dict, template: Mapping[str, torch.Tensor], what: str) -> dict:
    if got.keys() != template.keys():
        diff = sorted(set(got) ^ set(template))
        raise ValueError(f"checkpoint {what} does not fit the template; differing keys: {diff[:6]}")
    out = {}
    for k, t in template.items():
        if got[k].shape != t.shape:
            raise ValueError(f"checkpoint {what}[{k!r}] has shape {tuple(got[k].shape)}, "
                             f"template {tuple(t.shape)}")
        out[k] = got[k].to(t.dtype)
    return out


def load_checkpoint(path: str, params_template: Optional[Mapping] = None,
                    opt_state_template: Optional[Mapping] = None):
    """Returns ``(params, opt_state_or_None, meta)``, tensors on the CPU. A
    template (a dict of tensors with the expected names) makes the load check
    names and shapes and take the template's dtypes."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    meta = json.loads(payload["meta_json"])
    if meta.get("stats") is not None:
        meta["stats"] = NormStats.from_dict(meta["stats"])
    params = payload["params"]
    if params_template is not None:
        params = _like(params, params_template, "params")
    opt_state = payload.get("opt_state") or None
    if opt_state is not None and opt_state_template is not None:
        opt_state = _like(opt_state, opt_state_template, "opt_state")
    return params, opt_state, meta
