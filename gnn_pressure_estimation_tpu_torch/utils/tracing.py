"""Spans of the port, on the profiler's clock.

A span is a named interval of host time at a layer's boundary: the serving
and training entries and their phases (``infer``, ``infer.forward``,
``train_step``, ``train.backward``, ...), the graph layout (``inp.parse``,
``template.build``, ``graph.batch``, ``graph.band_layout``,
``graph.band_index``) and the opening of a kernel library (``kernels.open``).
Each record holds its name, its id, its parent's id, the id of the root span
it runs under (one request or step), its start and end in
``time.perf_counter_ns()`` and a few attributes. The records of the last
:data:`STORE_SPANS` spans are kept in memory; nothing is written out.

- :func:`span` is for the hot path, per request or step. It records only
  inside :func:`recording` or while a ``torch.profiler`` records; otherwise
  it is one flag check, one profiler check and a shared null context, and
  makes no record.
- :func:`setup_span` is for work done once a process or a cache miss, and
  always records.

While a profiler records, each span also enters
``torch.profiler.record_function`` under its own name, so the trace shows it
as a ``user_annotation`` range on the timeline of the kernels it launched.
Names are lower-case letters, digits, dots and underscores, which tools that
rewrite other characters keep whole. The module imports no torch (the
numpy-only parsers use it): no profiler records before torch is loaded.

Counts are read from the spans: the ``graph.batch`` spans are the batches
built, the ``kernels.open`` spans with ``built=1`` the libraries compiled.
Kernel launches are counted by the kernel wrappers themselves
(``band_attention_fwd.launches``, ...).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import sys
import threading
import time

STORE_SPANS = 65536

_store: collections.deque = collections.deque(maxlen=STORE_SPANS)
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()
_on = 0


class Span:
    """One span's record: ``name``, ``span_id``, ``parent_id`` (None at a
    root), ``request_id`` (the root's ``span_id``), ``start_ns`` and
    ``end_ns`` (``time.perf_counter_ns()``) and ``attrs``. Truthy, unlike the
    null span that :func:`span` returns when it does not record."""

    __slots__ = ("name", "span_id", "parent_id", "request_id", "start_ns", "end_ns", "attrs",
                 "_rf")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.end_ns = None

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns

    def set(self, **attrs):
        """Add attributes to the span."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = _stack()
        parent = stack[-1] if stack else None
        self.span_id = next(_ids)
        self.parent_id = parent.span_id if parent is not None else None
        self.request_id = parent.request_id if parent is not None else self.span_id
        self._rf = None
        if _profiling():
            from torch.profiler import record_function

            self._rf = record_function(self.name)
            self._rf.__enter__()
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        _stack().pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        _store.append(self)
        return False

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.span_id}, parent={self.parent_id}, "
                f"request={self.request_id}, {self.duration_ns} ns, {self.attrs})")


class _NullSpan:
    """What :func:`span` returns when it does not record: a context that
    does nothing and drops attributes."""

    __slots__ = ()

    def __bool__(self):
        return False

    def set(self, **attrs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


def _profiling() -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd._profiler_enabled()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, **attrs):
    """A hot-path span: recorded inside :func:`recording` or while a
    profiler records, else the shared null span."""
    if _on or _profiling():
        return Span(name, attrs)
    return _NULL


def setup_span(name: str, **attrs) -> Span:
    """A span of set-up work (once a process or a cache miss), always recorded."""
    return Span(name, attrs)


@contextlib.contextmanager
def recording():
    """Record hot-path spans inside this block, in every thread."""
    global _on
    with _lock:
        _on += 1
    try:
        yield
    finally:
        with _lock:
            _on -= 1


def spans() -> list:
    """The stored spans, oldest first, each added when it ended (a child
    before its parent)."""
    return list(_store)


def self_ns(records) -> dict:
    """``{span_id: ns}``: each span's duration less its children's, over
    ``records`` (a :func:`spans` snapshot)."""
    out = {s.span_id: s.duration_ns for s in records}
    for s in records:
        if s.parent_id in out:
            out[s.parent_id] -= s.duration_ns
    return out


def clear():
    """Empty the span store."""
    _store.clear()
