"""Reading a ``torch.profiler`` trace (Chrome trace JSON) into device times.

Kernels are put in four groups: the program's band attention and its band
SpMM, by name (the ``__global__`` entries of its CUDA sources, the SpMM's
being those defined in ``band_spmm*.cu``); GEMMs, by the operator that
launched them (the innermost host operator around the launch that the
kernel's correlation id names, a matrix product); and the rest, the glue.
Copies and memsets are device work outside the groups. Busy time is the union
of every device interval, not their sum, and the span runs from the first
device interval's start to the last one's end; the idle gaps between them
are named by what the host was doing at the time.
"""

from __future__ import annotations

import bisect
import json
import re
from collections import defaultdict
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
GEMM_OPS = frozenset((
    "aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm", "aten::addbmm", "aten::mv",
    "aten::addmv", "aten::dot", "aten::vdot", "aten::matmul", "aten::linear",
    "aten::_addmm_activation", "aten::_scaled_mm"))


def base_name(name: str) -> str:
    """``void (anonymous namespace)::rows_kernel<2, true>(float const*, ...)``
    -> ``rows_kernel``."""
    s = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return s.split("(")[0].split("<")[0].split("::")[-1].strip()


def global_names(source: str) -> list:
    """The names of the ``__global__`` functions of a CUDA source: the word
    before the parameter list, past ``void`` and a ``__launch_bounds__(...)``
    whose arguments may hold parentheses of their own."""
    names = []
    for m in re.finditer(r"__global__\s+void\s+", source):
        at = m.end()
        if source.startswith("__launch_bounds__", at):
            depth, at = 0, source.index("(", at)
            while True:
                depth += {"(": 1, ")": -1}.get(source[at], 0)
                at += 1
                if depth == 0:
                    break
        word = re.match(r"\s*(\w+)\s*\(", source[at:])
        if word:
            names.append(word.group(1))
    return names


def kernel_groups(csrc: Path) -> dict:
    """``{kernel name: "spmm" | "attn"}`` over the program's CUDA sources."""
    groups = {}
    for path in sorted(csrc.glob("*.cu*")):
        for name in global_names(path.read_text()):
            group = "spmm" if path.name.startswith("band_spmm") else "attn"
            groups[name] = "spmm" if groups.get(name) == "spmm" else group
    return groups


def group_of(name: str, launcher, own: dict) -> str:
    """A kernel's group from its name and ``launcher``, the host operator
    that launched it (None where the trace links it to none)."""
    base = base_name(name)
    if base in own:
        return own[base]
    return "gemm" if launcher in GEMM_OPS else "glue"


def launchers(host) -> dict:
    """``{correlation id: innermost host operator around the launch}``: for
    each runtime or driver call that carries a correlation id, the operator
    of the same thread that started last among those still running."""
    ops = defaultdict(list)
    for h in host:
        if h.get("cat") == "cpu_op":
            t = float(h["ts"])
            ops[(h.get("pid"), h.get("tid"))].append((t, t + float(h["dur"]), h.get("name", "")))
    starts = {}
    for key, iv in ops.items():
        iv.sort()
        starts[key] = [h[0] for h in iv]
    out = {}
    for h in host:
        corr = (h.get("args") or {}).get("correlation")
        key = (h.get("pid"), h.get("tid"))
        if h.get("cat") not in LAUNCH_CATS or corr is None or key not in ops:
            continue
        label = _innermost(ops[key], starts[key], float(h["ts"]))
        if label is not None:
            out[corr] = label
    return out


def summarize(trace_path: Path, own: dict, top: int = 10) -> dict:
    """Device seconds by group, the busy union and the span, the top device
    operations, the longest idle gaps by host activity, and the glue's
    device seconds by launching operator and kernel."""
    events = json.loads(Path(trace_path).read_text()).get("traceEvents", [])
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append(e)
        elif cat in HOST_CATS:
            host.append(e)
    launched_by = launchers(host)
    by_group = defaultdict(float)
    by_op = defaultdict(float)
    glue_by_launcher = defaultdict(float)
    intervals = []
    unlinked = 0
    for e in dev:
        t, d = float(e["ts"]), float(e["dur"])
        intervals.append((t, t + d))
        name = e.get("name", "")
        if e["cat"] == "kernel":
            launcher = launched_by.get((e.get("args") or {}).get("correlation"))
            unlinked += launcher is None
            group = group_of(name, launcher, own)
            by_group[group] += d * 1e-6
            by_op[base_name(name)] += d * 1e-6
            if group == "glue":
                glue_by_launcher[f"{launcher} > {base_name(name)}"] += d * 1e-6
        else:
            by_group["copy"] += d * 1e-6
            by_op[e["cat"]] += d * 1e-6
    merged = merge(intervals)
    busy_s = sum(e - s for s, e in merged) * 1e-6
    span_s = (merged[-1][1] - merged[0][0]) * 1e-6 if merged else 0.0
    gaps = defaultdict(float)
    host_iv = sorted((float(h["ts"]), float(h["ts"]) + float(h["dur"]), h.get("name", ""))
                     for h in host)
    starts = [h[0] for h in host_iv]
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        if s1 > e0:
            label = _innermost(host_iv, starts, 0.5 * (e0 + s1))
            gaps[label or "host: Python, no profiled op"] += (s1 - e0) * 1e-6
    return {
        "groups": dict(by_group),
        "busy_s": busy_s,
        "span_s": span_s,
        "kernels": sum(1 for e in dev if e["cat"] == "kernel"),
        "kernels_unlinked": unlinked,
        "device_ops": sorted(([k, v] for k, v in by_op.items()), key=lambda kv: -kv[1])[:top],
        "idle_gaps": sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])[:top],
        "glue_launchers": sorted(([k, v] for k, v in glue_by_launcher.items()),
                                 key=lambda kv: -kv[1])[:top],
    }


def merge(intervals) -> list:
    """The union of ``(start, end)`` intervals as disjoint sorted ``[start, end]``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(host_iv, starts, t: float, reach: int = 512):
    """The name of the innermost of the sorted ``(start, end, name)``
    intervals running at ``t`` (the one that started last among those that
    cover it, looking back ``reach`` intervals), or None."""
    i = bisect.bisect_right(starts, t) - 1
    for s, e, name in reversed(host_iv[max(0, i - reach):i + 1]):
        if e >= t:
            return name
    return None
