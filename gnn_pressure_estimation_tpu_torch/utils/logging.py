"""Experiment tracking — wandb-optional logging shim.

Reference parity: train.py:329-336 / auxil.py:316-331 push run config and
per-epoch metrics to wandb. wandb is optional here (not installed in minimal
environments); without it a JSONL file under the save path records the same
stream so runs stay auditable offline.

A copy of ``gnn_pressure_estimation_tpu/utils/logging.py``: wandb is imported
only when ``make_logger("wandb", ...)`` asks for it, and its absence falls
back to the JSONL file with the same message.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class _NullLogger:
    def log_epoch(self, epoch: int, metrics: dict):
        pass

    def finish(self):
        pass


class _JsonlLogger:
    def __init__(self, path: str, run_name: str, config: dict):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")
        self._f.write(json.dumps({
            "event": "start", "run": run_name, "time": time.time(),
            "config": {k: str(v) for k, v in config.items()},
        }) + "\n")

    def log_epoch(self, epoch: int, metrics: dict):
        self._f.write(json.dumps({
            "event": "epoch", "epoch": epoch,
            **{k: float(v) for k, v in metrics.items()},
        }) + "\n")
        self._f.flush()

    def finish(self):
        self._f.write(json.dumps({"event": "finish", "time": time.time()}) + "\n")
        self._f.close()


class _WandbLogger:
    def __init__(self, project: str, run_name: str, config: dict):
        import wandb

        self._wandb = wandb
        wandb.init(project=project, name=run_name, config=config)

    def log_epoch(self, epoch: int, metrics: dict):
        self._wandb.log({**metrics, "epoch": epoch})

    def finish(self):
        self._wandb.finish()


def make_logger(method: Optional[str], project: str, run_name: str, config: dict):
    if method == "wandb":
        try:
            return _WandbLogger(project, run_name, config)
        except ImportError:
            print("wandb not installed — falling back to JSONL logging")
    if method in ("wandb", "jsonl"):
        path = os.path.join(
            config.get("save_path", "experiments_logs"), f"{run_name}.jsonl"
        )
        return _JsonlLogger(path, run_name, config)
    return _NullLogger()
