"""PyTorch port: it imports nothing of JAX or of the JAX package, and its
entry points run on the card unless the caller asks for the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gnn_pressure_estimation_tpu_torch.core.graph import GraphTemplate
from gnn_pressure_estimation_tpu_torch.evaluation import EvalConfig, Evaluator
from gnn_pressure_estimation_tpu_torch.evaluation.infer import Inferencer
from gnn_pressure_estimation_tpu_torch.models.gatres import GATRes
from gnn_pressure_estimation_tpu_torch.models.presets import select_model
from gnn_pressure_estimation_tpu_torch.train import TrainConfig, Trainer
from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "gnn_pressure_estimation_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "gnn_pressure_estimation_tpu")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    """The port, ``chip_smoke.py`` and the tests' rank jobs (which the
    spawned ranks import) import no JAX."""
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "tests/torch_rank_jobs.py"]
    assert len(files) > 10
    scanned = {str(f.relative_to(PORT)) for f in files[:-2]}
    assert {"train/loop.py", "train/checkpoint.py", "train/autoclip.py", "utils/masking.py",
            "utils/metrics.py", "data/dataset.py", "ops/band_spmm.py", "simgen/netgen.py",
            "simgen/__init__.py", "ops/band_attention.py", "ops/padded.py",
            "ops/window_gather.py", "data/codecs.py", "data/zarrzip.py", "data/noisy.py",
            "simgen/units.py", "simgen/network_state.py", "simgen/solver_py.py",
            "simgen/solver_cpp.py", "simgen/solver_api.py", "evaluation/timer.py",
            "evaluation/harness.py", "cli.py", "utils/logging.py", "simgen/config.py",
            "simgen/tokens.py", "simgen/executor.py", "simgen/runner.py", "ops/segment.py",
            "models/zoo.py", "models/remask.py", "models/presets.py", "models/__init__.py",
            "weights.py", "parallel/__init__.py", "parallel/mesh.py", "parallel/launch.py",
            "parallel/halo.py", "parallel/edgepart.py", "parallel/distributed.py",
            "parallel/trainer.py", "parallel/eval_forward.py", "train/precision.py",
            "simgen/solver_certify.py", "simgen/solver_root.py", "native_build.py"} <= scanned
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in FORBIDDEN]
    assert bad == []


ALLOWED = {"torch", "numpy", "scipy", "gnn_pressure_estimation_tpu_torch"} | set(sys.stdlib_module_names)
# optional packages, imported only inside the functions that need them, as in
# the JAX package: the zstd codec, the 'ran_cluster' formula, the wandb
# logger and the generation's debug figure
LAZY = {"data/codecs.py": {"zstandard"}, "simgen/tokens.py": {"sklearn"},
        "utils/logging.py": {"wandb"}, "simgen/runner.py": {"matplotlib"}}


def _top_level_modules(path: Path):
    """Modules imported by the module's own statements, outside any function."""
    for node in ast.parse(path.read_text(), str(path)).body:
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("rel", ["simgen/netgen.py", "data/inp.py", "ops/band_attention.py",
                                 "ops/banded.py", "ops/_build.py", "core/graph.py",
                                 "ops/padded.py", "ops/window_gather.py", "models/layers.py",
                                 "data/codecs.py", "data/zarrzip.py", "data/dataset.py",
                                 "data/noisy.py", "simgen/units.py", "simgen/network_state.py",
                                 "simgen/solver_py.py", "simgen/solver_cpp.py",
                                 "simgen/solver_api.py", "evaluation/timer.py",
                                 "evaluation/harness.py", "cli.py", "utils/logging.py",
                                 "simgen/config.py", "simgen/tokens.py", "simgen/executor.py",
                                 "simgen/runner.py", "ops/segment.py", "models/zoo.py",
                                 "models/remask.py", "models/presets.py", "models/__init__.py",
                                 "weights.py", "parallel/__init__.py", "parallel/mesh.py",
                                 "parallel/launch.py", "parallel/halo.py", "parallel/edgepart.py",
                                 "parallel/distributed.py", "parallel/trainer.py",
                                 "parallel/eval_forward.py", "train/loop.py",
                                 "train/precision.py", "models/gatres.py", "ops/graph_attention.py",
                                 "simgen/solver_certify.py", "simgen/solver_root.py",
                                 "native_build.py"])
def test_module_imports_only_what_the_port_may(rel):
    """The modules this slice added or extended import torch, numpy, scipy,
    the standard library and the port itself, nothing else."""
    mods = {m.split(".")[0] for m in _imported_modules(PORT / rel)}
    lazy = LAZY.get(rel, set())
    assert not lazy & set(_top_level_modules(PORT / rel))
    mods -= lazy
    assert mods <= ALLOWED, mods - ALLOWED
    if rel.startswith(("simgen/", "data/")):
        assert "torch" not in mods                      # numpy only, as in the JAX package


def test_port_imports_with_jax_poisoned():
    """Every module of the port, the new ones included, imports in a process
    where ``jax``, ``flax``, ``optax`` and the JAX package cannot be
    imported; ``make_minitown`` and the routing rule then run."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'gnn_pressure_estimation_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import importlib, pkgutil\n"
        "import gnn_pressure_estimation_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "from gnn_pressure_estimation_tpu_torch.simgen.netgen import make_minitown\n"
        "from gnn_pressure_estimation_tpu_torch.ops.banded import band_attention_route\n"
        "assert len(make_minitown().junctions) == 25\n"
        "assert band_attention_route(256, 1920) == 'flash'\n"
        "print(len(names), 'simgen.netgen' in ' '.join(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    count, has_netgen = proc.stdout.split()
    assert int(count) > 25 and has_netgen == "True"


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tpl = GraphTemplate(3, np.array([0, 1, 1, 2]), np.array([1, 0, 2, 1]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpl.batch(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpl.batch(2, mode="padded")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpl.batch(2, mode="banded", band_block=2, band_attn="acc")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Inferencer(GATRes(1, 4), NormStats(), agg_mode="padded")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(GATRes(1, 4), TrainConfig(agg_mode="padded"), NormStats(), tpl)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(GATRes(1, 4), TrainConfig(band_attn="acc"), NormStats(), tpl)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(GATRes(1, 4, dtype=torch.bfloat16),
                TrainConfig(epochs_per_dispatch=2, matmul_precision="bfloat16"), NormStats(), tpl)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        select_model("gatres_small", dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        select_model("gatres_small")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Inferencer(GATRes(1, 4), NormStats())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(GATRes(1, 4), TrainConfig(), NormStats(), tpl)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Evaluator(GATRes(1, 4), EvalConfig(), NormStats())
    assert Evaluator(GATRes(1, 4), EvalConfig(), NormStats(), device="cpu").device.type == "cpu"
    # asking for the CPU works
    assert tpl.batch(2, device="cpu").dense
    assert tpl.batch(2, mode="padded", device="cpu").padded
    assert next(select_model("gatres_small", device="cpu")[0].parameters()).device.type == "cpu"


@pytest.mark.parametrize("name", ["gin", "gat", "chebnet"])
def test_unported_presets_raise(name):
    """These presets were refused until the model zoo was ported; the test
    keeps its name and now holds that they build on the CPU at the preset's
    size, their weights drawn from the seed, and raise without a card."""
    model, preset = select_model(name, device="cpu", seed=1)
    assert preset.name == name and next(model.parameters()).device.type == "cpu"
    again, _ = select_model(name, device="cpu", seed=1)
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            select_model(name)


def test_chip_smoke_refuses_without_card_or_repo(tmp_path):
    """With no card (as here), and from a directory that holds only the
    script, ``chip_smoke.py`` exits non-zero and prints no result line."""
    script = tmp_path / "chip_smoke.py"
    script.write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
