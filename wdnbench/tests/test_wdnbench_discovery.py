"""A configuration, a traffic mix, a cell and a per-layer metric added as new
files and entries alone are found and run, with no file of the harness
edited."""

import json
import shutil

from wdnbench.tests import tiny


def test_new_files_alone_add_a_cell_and_a_metric(tmp_path):
    root = tiny.make_checkout(tmp_path)
    bd = root / "wdnbench"
    before = {p: p.read_bytes() for p in bd.rglob("*") if p.is_file()}
    # a configuration: the tiny network under another name
    cfg = json.loads((bd / "configs" / "gatres_large-bigtown.json").read_text())
    cfg["name"] = "gatres_small-tiny"
    (bd / "configs" / "gatres_small-tiny.json").write_text(json.dumps(cfg))
    # a traffic mix: serving at batch 2
    mix = json.loads((bd / "workloads" / "serve-b32.json").read_text())
    (bd / "workloads" / "serve-b2.json").write_text(json.dumps({**mix, "batch": 2}))
    # the cell's limits, and a per-layer metric reader
    shutil.copy(bd / "limits" / f"{tiny.SERVE}.json", bd / "limits" / "tiny-small-serve-b2.json")
    (bd / "metrics" / "traced_batches.serve.py").write_text(
        'UNIT = "batches"\nMOVES = "serve_snapshots_per_s"\n\n\n'
        'def read(ctx):\n    return ctx["trace"]["iters"] if ctx["kind"] == "serve" else None\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "gatres_small-tiny", "source": "https://example.org/tiny",
                             "file": "wdnbench/configs/gatres_small-tiny.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "tiny-small-serve-b2", "config": "gatres_small-tiny",
                               "traffic": "serve-b2", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"].startswith("serve_"):
            m["workloads"].append("tiny-small-serve-b2")
    bench["per_layer"].append({"name": "traced_batches.serve", "unit": "batches",
                               "better": "higher", "source": "program_counter",
                               "layer": "serving entry", "moves": "serve_snapshots_per_s",
                               "workloads": ["tiny-small-serve-b2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    result, _ = tiny.run(root, "tiny-small-serve-b2", traced=True)
    assert result["metrics"]["traced_batches.serve"]["value"] == 2
    assert result["correct"], result["checks"]
    result, _ = tiny.run(root, "tiny-small-serve-b2")
    assert set(result["metrics"]) == {"serve_snapshots_per_s", "serve_batch_p95_ms", "setup_s"}
    assert all(p.read_bytes() == b for p, b in before.items())


def test_readers_state_the_unit_and_metric_of_their_entries():
    from wdnbench import harness

    bench = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    cell = harness.Cell(tiny.SERVE)
    for m in bench["per_layer"]:
        mod = cell.reader(m["name"])
        assert (mod.UNIT, mod.MOVES) == (m["unit"], m["moves"]), m["name"]
    names = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in names
