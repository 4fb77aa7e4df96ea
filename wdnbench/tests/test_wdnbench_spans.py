"""The metrics read from the program's own spans: traced runs of both cells
on the CPU at a small size report them, and a program that records no spans
leaves them out of the line instead of failing."""

import math

import pytest

from wdnbench import spans
from wdnbench.tests import tiny

SPAN_METRICS = {tiny.SERVE: ("infer_host_ms.serve", "graph_layout_s", "kernel_open_s"),
                tiny.TRAIN: ("prepare_ms.train", "graph_layout_s", "kernel_open_s")}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_checkout(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", [tiny.SERVE, tiny.TRAIN])
def test_a_traced_run_reports_the_span_metrics(root, cell):
    result, _ = tiny.run(root, cell, traced=True)
    assert result["correct"], result["checks"]
    for name in SPAN_METRICS[cell]:
        value = result["metrics"][name]["value"]
        assert math.isfinite(value) and value >= 0, (name, value)
    assert result["metrics"]["graph_layout_s"]["value"] > 0
    # the host phases are part of the requests or steps the window timed
    window_ms = 1e3 * result["device"]["window_s"] / 2      # the tiny mixes' trace_iters
    entry = "infer_host_ms.serve" if cell == tiny.SERVE else "prepare_ms.train"
    assert 0 < result["metrics"][entry]["value"] < window_ms


@pytest.mark.parametrize("cell", [tiny.SERVE, tiny.TRAIN])
def test_a_program_without_spans_leaves_them_out(root, cell, monkeypatch):
    monkeypatch.setattr(spans, "TRACING", "gnn_pressure_estimation_tpu_torch.utils.no_such_module")
    result, _ = tiny.run(root, cell, traced=True)
    assert result["correct"], result["checks"]
    assert not set(SPAN_METRICS[cell]) & set(result["metrics"])
    assert "graph_build_s" in result["metrics"]


def test_the_step_reader_leaves_the_upload_out():
    """``prepare_ms.train`` is ``train.prepare``'s own time: its child
    ``train.upload``, where the host waits for the stream, is left out."""
    from gnn_pressure_estimation_tpu_torch.utils import tracing

    tracing.clear()
    with tracing.recording():
        for _ in range(3):
            with tracing.span("train_step"), tracing.span("train.prepare"):
                with tracing.span("train.upload"):
                    sum(range(20_000))
                sum(range(2_000))
    records = tracing.spans()
    try:
        value = spans.window_median_ms({"trace": {"iters": 3}}, "train_step", ("train.prepare",))
    finally:
        tracing.clear()
    prep = [s for s in records if s.name == "train.prepare"]
    upload = [s for s in records if s.name == "train.upload"]
    own = sorted(1e-6 * (p.duration_ns - u.duration_ns) for p, u in zip(prep, upload))
    assert value == pytest.approx(own[1])
    assert value < 1e-6 * sorted(p.duration_ns for p in prep)[1]
