"""Inference latency/throughput measurement (reference utils/timer.py:12-66).

The counterpart of ``gnn_pressure_estimation_tpu/evaluation/timer.py``. On
the card it follows the reference's protocol: warm-up calls, then each timed
call between two CUDA events, read once the second has completed. On the CPU
it times with ``time.perf_counter``. ``compute_time`` / ``compute_throughput``
replicate the reference formulas (ms·graphs dot-product normalized by
dataset length)."""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch


class Timer:
    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self.reset()

    def reset(self):
        self.timings: list[float] = []    # ms per measured call
        self.num_graphs: list[int] = []
        self.finished_warmup = False

    def _time_call(self, fn, *args, **kwargs):
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            result = fn(*args, **kwargs)
            end.record()
            end.synchronize()
            return result, start.elapsed_time(end)
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        return result, (time.perf_counter() - t0) * 1e3

    def auto_measure(self, inference_func: Callable, num_graphs_per_batch: int,
                     warmup_times: int = 10) -> Callable:
        def inference(*args, **kwargs):
            if warmup_times > 0 and not self.finished_warmup:
                for _ in range(warmup_times):
                    inference_func(*args, **kwargs)
                self.finished_warmup = True
            result, ms = self._time_call(inference_func, *args, **kwargs)
            self.timings.append(ms)
            self.num_graphs.append(num_graphs_per_batch)
            return result

        return inference

    def compute_time(self, len_dataset: int) -> float:
        """Mean ms per snapshot (reference timer.py:43-51)."""
        assert len(self.timings) == len(self.num_graphs)
        assert len_dataset > 0
        total = float(np.dot(self.timings, self.num_graphs))
        return total / len_dataset

    def compute_throughput(self, len_dataset: int) -> float:
        """Snapshots per second (reference timer.py:53-66)."""
        assert len(self.timings) == len(self.num_graphs)
        assert len_dataset > 0
        totals = np.array(self.timings) * np.array(self.num_graphs) / len_dataset
        total_s = float(np.sum(totals)) / 1000.0
        return float(len(self.timings) * max(self.num_graphs)) / total_s
