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
from gnn_pressure_estimation_tpu_torch.evaluation.infer import Inferencer
from gnn_pressure_estimation_tpu_torch.models.gatres import GATRes
from gnn_pressure_estimation_tpu_torch.models.presets import select_model
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
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tpl = GraphTemplate(3, np.array([0, 1, 1, 2]), np.array([1, 0, 2, 1]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpl.batch(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        select_model("gatres_small")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Inferencer(GATRes(1, 4), NormStats())
    # asking for the CPU works
    assert tpl.batch(2, device="cpu").dense
    assert next(select_model("gatres_small", device="cpu")[0].parameters()).device.type == "cpu"


@pytest.mark.parametrize("name", ["gin", "gat", "chebnet"])
def test_unported_presets_raise(name):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        select_model(name, device="cpu")


def test_chip_smoke_refuses_without_card_or_repo(tmp_path):
    """With no card (as here), and from a directory that holds only the
    script, ``chip_smoke.py`` exits non-zero and prints no result line."""
    script = tmp_path / "chip_smoke.py"
    script.write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
