"""A checkout of the benchmark cut to a size the CPU runs in seconds: the
same files and cells, with GATRes-small on a synthetic network of 1,100
junctions (banded, as the cells' networks are) and small batches."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
REPO = BENCH.parent
SERVE, TRAIN = "bigtown-large-serve-b32", "meganet-large-train-b8"


def make_checkout(root: Path) -> Path:
    """``root`` with ``BENCHMARK.json`` and a cut copy of ``wdnbench/``; returns root."""
    from gnn_pressure_estimation_tpu_torch.data.inp import write_inp
    from gnn_pressure_estimation_tpu_torch.simgen.netgen import make_wdn

    bd = root / "wdnbench"
    shutil.copytree(BENCH, bd, ignore=shutil.ignore_patterns("__pycache__", "networks", "tests"))
    (bd / "networks").mkdir()
    (bd / "networks" / "tiny.inp").write_text(write_inp(make_wdn(1100, seed=3, name="tiny")))
    for cfg in (bd / "configs").glob("*.json"):
        c = json.loads(cfg.read_text())
        c["model"].update(preset="gatres_small", blocks=15, channels=32)
        c["network"].update(name="tiny", file="wdnbench/networks/tiny.inp")
        cfg.write_text(json.dumps(c))
    for name, cut in (("serve-b32", {"batch": 4, "check_batches": 2, "trace_iters": 2}),
                      ("train-b8", {"batch": 2, "pool_snapshots": 16, "pool_masks": 4,
                                    "trace_iters": 2})):
        path = bd / "workloads" / f"{name}.json"
        path.write_text(json.dumps({**json.loads(path.read_text()), **cut}))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def run(root: Path, cell: str, seed: int = 2**31 + 5, traced: bool = False, seconds=0.5):
    from wdnbench import harness

    return harness.run(cell, seed, seconds, traced, device="cpu", root=root,
                       bench_dir=root / "wdnbench")
