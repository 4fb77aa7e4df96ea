"""PyTorch port: the span and counter recorder (``utils.tracing``) and the
spans of the serving and training entries, the graph layout and the kernel
loader, on a small banded CPU graph."""

import ctypes
import json
import re
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gnn_pressure_estimation_tpu_torch.data.dataset import build_template, get_keep_list
from gnn_pressure_estimation_tpu_torch.data.inp import parse_inp, write_inp
from gnn_pressure_estimation_tpu_torch.evaluation.infer import Inferencer
from gnn_pressure_estimation_tpu_torch.models.gatres import GATRes
from gnn_pressure_estimation_tpu_torch.ops import _build
from gnn_pressure_estimation_tpu_torch.simgen.netgen import make_wdn
from gnn_pressure_estimation_tpu_torch.train import TrainConfig, Trainer
from gnn_pressure_estimation_tpu_torch.utils import tracing
from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats

torch.set_num_threads(1)
INFER = ("infer", "infer.scale", "infer.upload", "infer.forward", "infer.readback", "infer.serve")
STEP = ("train_step", "train.prepare", "train.zero_grad", "train.forward", "train.loss",
        "train.backward", "train.optimizer")
UPLOAD = "train.upload"                     # inside train.prepare
SETUP = ("inp.parse", "template.build", "graph.band_layout", "graph.band_index", "graph.batch")


@pytest.fixture
def fresh():
    tracing.clear()
    yield
    tracing.clear()


def _template():
    wn = parse_inp(write_inp(make_wdn(60, seed=1)))
    tpl, _ = build_template(wn, get_keep_list(wn, "keep_junction", None, "pressure"), None)
    tpl.band_layout(block=16)
    return tpl


def _inferencer():
    return Inferencer(GATRes(1, 16), NormStats(norm_type="znorm", mean=50.0, std=10.0),
                      agg_mode="banded", device="cpu")


def _serve(inf, tpl, S=5, batch_size=2):
    obs = np.arange(0, tpl.n_node, 4)
    vals = (50 + np.random.default_rng(0).standard_normal((S, obs.size))).astype(np.float32)
    return inf.infer(tpl, vals, obs, batch_size=batch_size), obs


def _step(tpl, mask_kind="array"):
    """A trainer and a step on it, the mask handed in as a numpy array, as a
    CPU tensor, or drawn (``None``)."""
    tr = Trainer(GATRes(1, 16), TrainConfig(batch_size=2, agg_mode="banded", band_block=16),
                 NormStats(norm_type="znorm"), tpl, device="cpu")
    xb = np.random.default_rng(1).standard_normal((2, tpl.n_node)).astype(np.float32)
    mask = np.zeros(2 * tpl.n_node, bool)
    mask[::3] = True
    if mask_kind is None:
        return tr, lambda: tr.train_step(tpl, xb, generator=torch.Generator().manual_seed(0)), xb, None
    if mask_kind == "tensor":
        mask = torch.from_numpy(mask)
    return tr, lambda: tr.train_step(tpl, xb, mask=mask), xb, mask


def _refuse_record_function(monkeypatch):
    """The recorder's ``torch.profiler.record_function`` raises (Adam's step
    enters ``torch.autograd.profiler``'s of its own, which stays)."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with tracing off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)


def test_off_by_default_records_set_up_only(fresh, monkeypatch):
    _refuse_record_function(monkeypatch)
    tpl = _template()
    names = [s.name for s in tracing.spans()]
    assert names[:2] == ["inp.parse", "template.build"] and "graph.band_layout" in names
    inf = _inferencer()
    tr, step, _, _ = _step(tpl)
    tracing.clear()
    _serve(inf, tpl)
    step()
    # only the batches the entries built on their first calls, no hot-path span
    assert {s.name for s in tracing.spans()} <= set(SETUP)
    assert not {s.name for s in tracing.spans()} & set(INFER + STEP + (UPLOAD,))
    _serve(inf, tpl)
    step()
    assert not {s.name for s in tracing.spans()} & set(INFER + STEP + (UPLOAD,))


def _tree_holds(records, root_name):
    roots = [s for s in records if s.parent_id is None]
    assert [r.name for r in roots] == [root_name]
    root = roots[0]
    assert {s.request_id for s in records} == {root.span_id}
    by_id = {s.span_id: s for s in records}
    for s in records:
        if s.parent_id is not None:
            p = by_id[s.parent_id]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns, (s, p)
    own = tracing.self_ns(records)
    for s in records:
        children = sum(c.duration_ns for c in records if c.parent_id == s.span_id)
        assert own[s.span_id] == s.duration_ns - children >= 0
    return root


@pytest.mark.parametrize("S, batch_size", [(5, 2), (4, 4)])
def test_a_request_is_one_tree_with_its_bytes(fresh, S, batch_size):
    tpl = _template()
    inf = _inferencer()
    _serve(inf, tpl, S, batch_size)          # builds the graphs
    tracing.clear()
    with tracing.recording():
        res, obs = _serve(inf, tpl, S, batch_size)
    records = tracing.spans()
    root = _tree_holds(records, "infer")
    assert root.attrs == {"S": S, "batch_size": batch_size, "observed": obs.size}
    chunks = -(-S // batch_size)
    names = [s.name for s in records if s.parent_id == root.span_id]
    assert names == (["infer.scale"] + ["infer.upload", "infer.forward", "infer.readback"] * chunks
                     + ["infer.serve"])
    sizes = [min(batch_size, S - lo) for lo in range(0, S, batch_size)]
    moved = 4 * tpl.n_node                   # one float32 snapshot
    assert [s.attrs["h2d_bytes"] for s in records if s.name == "infer.upload"] == \
        [moved * b for b in sizes]
    assert [s.attrs["d2h_bytes"] for s in records if s.name == "infer.readback"] == \
        [moved * b for b in sizes]
    assert res.pred.shape == (S, tpl.n_node)


@pytest.mark.parametrize("mask_kind", ["array", "tensor", None])
def test_a_train_step_is_one_tree_with_its_bytes(fresh, mask_kind):
    tpl = _template()
    tr, step, xb, mask = _step(tpl, mask_kind)
    step()
    tracing.clear()
    with tracing.recording():
        loss, _ = step()
    records = tracing.spans()
    root = _tree_holds(records, "train_step")
    assert [s.name for s in records if s.parent_id == root.span_id] == list(STEP[1:])
    prep, = [s for s in records if s.name == "train.prepare"]
    upload, = [s for s in records if s.name == "train.upload"]
    assert upload.parent_id == prep.span_id
    # the snapshots, and the mask handed in or drawn on the CPU generator (one byte a node)
    assert upload.attrs["h2d_bytes"] == xb.size * xb.itemsize + 2 * tpl.n_node
    assert torch.isfinite(loss)


def test_the_profiler_sees_the_spans_on_its_own_clock(fresh, tmp_path):
    tpl = _template()
    inf = _inferencer()
    _serve(inf, tpl)
    model = inf.model

    class Probe(torch.nn.Module):
        """The model, inside a range of the profiler's own."""
        def __init__(self):
            super().__init__()
            self.inner = model

        def forward(self, *args, **kwargs):
            with torch.profiler.record_function("model.probe"):
                return self.inner(*args, **kwargs)
    inf.model = Probe()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(inf, tpl)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    ann = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            ann.setdefault(e["name"], []).append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    assert set(INFER) <= set(ann)
    forwards, probes = ann["infer.forward"], ann["model.probe"]
    assert len(forwards) == len(probes) == 3

    def inside(iv, spans):
        return any(s <= iv[0] and iv[1] <= e for s, e in spans)
    assert all(inside(p, forwards) for p in probes)
    ops = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
           if e.get("cat") == "cpu_op" and e["name"].startswith("aten::") and inside(
               (float(e["ts"]), float(e["ts"]) + float(e["dur"])), probes)]
    assert ops and all(inside(op, forwards) for op in ops)
    # and the spans were recorded, with no recording() asked for
    assert [s.name for s in tracing.spans()].count("infer") == 1


def test_a_cached_batch_counts_a_hit_and_records_no_span(fresh):
    tpl = _template()
    tracing.clear()
    g = tpl.batch(3, mode="banded", device="cpu")
    batch, = [s for s in tracing.spans() if s.name == "graph.batch"]
    assert batch.attrs == {"B": 3, "mode": "banded", "route": "dma"}
    tracing.clear()
    assert tpl.batch(3, mode="banded", device="cpu") is g
    assert tracing.spans() == []


@pytest.mark.parametrize("built_before", [True, False])
def test_the_kernel_loader_counts_and_spans_only_its_opens(fresh, monkeypatch, tmp_path,
                                                            built_before):
    so = tmp_path / "fake-0.so"
    if built_before:
        so.write_bytes(b"")
    opened, builds = [], []
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_target", lambda name: so)
    monkeypatch.setattr(_build, "build_all", lambda names: builds.append(names) or so.write_bytes(b""))
    monkeypatch.setattr(ctypes, "CDLL", lambda path: opened.append(path) or object())
    lib = _build.load("fake")
    for _ in range(5):
        assert _build.load("fake") is lib
    assert opened == [str(so)] and builds == ([] if built_before else [("fake",)])
    # one open, so one span; its ``built`` counts the compilations
    span, = tracing.spans()
    assert span.name == "kernels.open" and span.parent_id is None
    assert span.attrs == {"kernel": "fake", "built": 0 if built_before else 1}


def test_a_batch_built_inside_a_request_shows_in_its_tree(fresh):
    """A ragged last chunk builds its graph on the hot path: the batch's span
    lies inside the request's upload, so it is seen and counted there."""
    tpl = _template()
    inf = _inferencer()
    with tracing.recording():
        _serve(inf, tpl, S=5, batch_size=2)
    records = tracing.spans()
    root, = [s for s in records if s.name == "infer"]
    by_id = {s.span_id: s for s in records}
    batches = [s for s in records if s.name == "graph.batch"]
    assert [b.attrs["B"] for b in batches] == [2, 1]
    assert all(by_id[b.parent_id].name == "infer.upload" and b.request_id == root.span_id
               for b in batches)
    tracing.clear()
    with tracing.recording():
        _serve(inf, tpl, S=5, batch_size=2)
    assert "graph.batch" not in {s.name for s in tracing.spans()}


def test_the_store_keeps_the_last_spans_only(fresh):
    with tracing.recording():
        for i in range(tracing.STORE_SPANS + 10):
            with tracing.span("t.empty", i=i):
                pass
    records = tracing.spans()
    assert len(records) == tracing.STORE_SPANS
    assert records[0].attrs["i"] == 10 and records[-1].attrs["i"] == tracing.STORE_SPANS + 9


def test_each_thread_has_its_own_parents(fresh):
    done = threading.Event()

    def other():
        with tracing.span("t.other"):
            pass
        done.set()
    with tracing.recording(), tracing.span("t.main") as main:
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
    assert done.is_set() and not t.is_alive()
    other_span, = [s for s in tracing.spans() if s.name == "t.other"]
    assert other_span.parent_id is None and other_span.request_id == other_span.span_id
    assert main.parent_id is None


def test_every_span_name_keeps_its_characters(fresh):
    tpl = _template()
    inf = _inferencer()
    _, step, _, _ = _step(tpl)
    with tracing.recording():
        _serve(inf, tpl)
        step()
    names = {s.name for s in tracing.spans()}
    assert set(INFER + STEP + SETUP + (UPLOAD,)) <= names
    assert all(re.fullmatch(r"[a-z0-9_.]+", n) for n in names)


def test_the_command_lines_epoch_profiler_carries_the_spans(fresh, tmp_path):
    from gnn_pressure_estimation_tpu_torch.cli import _EpochProfiler

    tpl = _template()
    _, step, _, _ = _step(tpl)
    step()
    prof = _EpochProfiler(str(tmp_path), 2, "run", torch.device("cpu"))
    prof.epoch_end(1)
    step()
    prof.stop()
    events = json.loads((tmp_path / "run.trace.json").read_text())["traceEvents"]
    annotated = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert set(STEP + (UPLOAD,)) <= annotated
