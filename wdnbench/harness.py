"""Finds a cell's files by name, drives the program through it, and builds the
result line.

``BENCHMARK.json`` names the cells. Each cell's pieces sit in files of their
own under ``wdnbench/``, found by the names the entry gives:

- ``configs/<config>.json``: the model, the network file, the dtypes;
- ``workloads/<traffic>.json``: the traffic mix, whose ``kind`` (``serve``
  or ``train``) picks the generator in ``traffic.py``;
- ``limits/<cell>.json``: the limit of each number that decides ``correct``;
- ``metrics/<metric>.py``: one reader a per-layer metric, ``read(ctx)``.

Adding a configuration, a mix, a cell or a per-layer metric adds files and
entries; no file here changes.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gnn_pressure_estimation_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot), compared
    whole, is JAX's or the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A cell's entries and files, read from ``root`` (the checkout) and
    ``bench_dir`` (where its files live)."""

    def __init__(self, name: str, root: Path = ROOT, bench_dir: Path = HERE):
        self.root, self.bench_dir = Path(root), Path(bench_dir)
        self.bench = load_json(self.root / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
        self.name, self.entry = name, cells[name]
        cfg_entry = {c["name"]: c for c in self.bench["configs"]}[self.entry["config"]]
        self.config = load_json(self.root / cfg_entry["file"])
        self.traffic = load_json(self.bench_dir / "workloads" / f"{self.entry['traffic']}.json")
        self.limits = load_json(self.bench_dir / "limits" / f"{name}.json")

    def _applies(self, metric: dict) -> bool:
        return self.name in metric.get("workloads", [self.name])

    def end_to_end(self) -> list:
        return [m for m in self.bench["end_to_end"] if self._applies(m)]

    def per_layer(self) -> list:
        return [m for m in self.bench["per_layer"] if self._applies(m)]

    def reader(self, metric: str):
        path = self.bench_dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "wdnbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.strip().splitlines()[0] if out.strip() else "unknown"


def profile_window(cell_run, iters: int, own: dict) -> dict:
    """``iters`` iterations of the cell timed by the host clock alone, then
    ``iters`` more under ``torch.profiler`` (device activity and the host's
    operators, without shapes, stacks or memory), each from a drained device
    to a drained device, and the trace read. The untraced window gives the
    rate the profiler's own host work would slow; the trace gives device
    times, which it does not."""
    from torch.profiler import ProfilerActivity, profile

    from wdnbench import trace

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cell_run.dev.type == "cuda"
                                     else [])
    light = dict(activities=acts, record_shapes=False, profile_memory=False, with_stack=False,
                 with_flops=False, with_modules=False)
    with profile(**light):                 # the profiler's own first start, untimed
        cell_run.iteration()
        cell_run.sync()
    cell_run.settle()
    cell_run.sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        cell_run.iteration()
    cell_run.sync()
    untraced_s = time.perf_counter() - t0
    cell_run.settle()
    with tempfile.TemporaryDirectory() as tmp:
        cell_run.sync()
        with profile(**light) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                cell_run.iteration()
            cell_run.sync()
            window_s = time.perf_counter() - t0
        cell_run.settle()
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        summary = trace.summarize(path, own)
    return {"window_s": window_s, "untraced_s": untraced_s, "iters": iters, **summary}


def run(name: str, seed: int, seconds: float, traced: bool, device: str = "cuda",
        root: Path = ROOT, bench_dir: Path = HERE, t_start: float = None, inspect=None):
    """One run of cell ``name``: set-up, the measured (or traced) window, the
    check against the reference. Returns the result line's object and every
    number the check read, and under ``_notes`` the set-up's phases and
    what the window saw, for the log. ``inspect``, if given, is called with the cell's
    runner before the program's state is freed (a diagnostic's hook).
    ``t_start`` is when the process started, from which set-up is timed."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    from wdnbench import traffic
    from wdnbench.check import judge
    from wdnbench.trace import kernel_groups

    cell = Cell(name, root, bench_dir)
    dev = torch.device(device)
    t0 = time.perf_counter()
    if dev.type == "cuda":
        torch.ones(1, device=dev).sum().item()          # the context, before any timed layer
    cuda_init_s = time.perf_counter() - t0
    runner = traffic.KINDS[cell.traffic["kind"]](cell, seed, dev)
    runner.setup_times.update(before_setup_s=time.perf_counter() - t_start,
                              cuda_init_s=cuda_init_s)
    runner.setup()
    runner.sync()
    setup_s = time.perf_counter() - t_start
    metrics, dev_info, breakdown = {}, {}, None
    notes = {"setup": runner.setup_times}
    if traced:
        own = kernel_groups(traffic.program_dir() / "csrc")
        tr = profile_window(runner, int(cell.traffic["trace_iters"]), own)
        ctx = {"kind": cell.traffic["kind"], "setup": runner.setup_times, "trace": tr,
               "shapes": runner.shapes, "config": cell.config, "traffic": cell.traffic}
        for m in cell.per_layer():
            value = cell.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_info = {"busy_s": tr["busy_s"], "window_s": tr["window_s"]}
        notes["traced"] = {k: tr[k] for k in ("kernels", "kernels_unlinked",
                                             "untraced_s", "span_s", "glue_launchers")}
        breakdown = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    else:
        measured = runner.window(seconds)
        notes["window"] = measured.pop("_window")
        measured["setup_s"] = setup_s
        for m in cell.end_to_end():
            metrics[m["name"]] = {"value": measured[m["name"]], "unit": m["unit"]}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    attempted, failed = runner.attempted, runner.failed
    runner.finish()
    if inspect is not None:
        inspect(runner)
    runner.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = runner.check()
    numbers["_notes"] = notes
    correct, checks = judge(numbers, cell.limits)
    result = {
        "correct": bool(correct and failed == 0),
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": int(cell.entry["chips"]), "memory_peak_bytes": int(peak),
                   **dev_info},
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result, numbers
