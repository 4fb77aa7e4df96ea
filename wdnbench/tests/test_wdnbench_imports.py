"""The import rule: nothing the benchmark runs loads JAX or the JAX package
(top-level module names compared whole), and the reference loads nothing of
the program either."""

import ast
import subprocess
import sys
import types
from pathlib import Path

import pytest

from wdnbench import harness

BENCH = Path(harness.__file__).resolve().parent
PROGRAM = "gnn_pressure_estimation_tpu_torch"
# the yardstick: what decides correct and what the counts are, apart from the program
YARDSTICK = ("reference.py", "network.py", "inputs.py", "counts.py", "check.py", "trace.py")


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


def test_names_are_compared_whole():
    found = harness.forbidden_modules(["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
                                       "gnn_pressure_estimation_tpu", "gnn_pressure_estimation_tpu.ops",
                                       PROGRAM, PROGRAM + ".ops", "jaxtyping", "flaxen"])
    assert found == ["flax.linen", "gnn_pressure_estimation_tpu", "gnn_pressure_estimation_tpu.ops",
                     "jax", "jax.numpy", "jaxlib.xla_client"]


def test_no_file_of_the_benchmark_imports_jax_and_the_yardstick_not_the_program():
    for path in sorted(BENCH.rglob("*.py")):
        names = top_level_imports(path)
        assert not names & set(harness.FORBIDDEN), path
        if path.name in YARDSTICK:
            assert PROGRAM not in names, path


def test_run_refuses_a_loaded_jax(monkeypatch):
    sys.path.insert(0, str(BENCH))
    import run

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(SystemExit) as exc:
        run.refuse_forbidden("in a test")
    assert exc.value.code != 0


def test_a_whole_cpu_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    """A run of both tiny cells in a fresh process, program and reference
    included, then ``sys.modules`` read by the harness's own rule."""
    code = f"""
import sys
sys.path.insert(0, {str(BENCH.parent)!r})
from pathlib import Path
from wdnbench import harness
from wdnbench.tests import tiny
root = tiny.make_checkout(Path({str(tmp_path)!r}))
for cell in (tiny.SERVE, tiny.TRAIN):
    tiny.run(root, cell)
print("FOUND", harness.forbidden_modules())
print("PROGRAM", "{PROGRAM}" in sys.modules)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout and "PROGRAM True" in out.stdout


def test_the_reference_loads_nothing_of_the_program():
    code = f"""
import sys
sys.path.insert(0, {str(BENCH.parent)!r})
import wdnbench.reference, wdnbench.network, wdnbench.inputs, wdnbench.check, wdnbench.counts
print(sorted({{m.split('.')[0] for m in sys.modules}} & {{"{PROGRAM}", "jax", "flax", "jaxlib",
      "gnn_pressure_estimation_tpu"}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
