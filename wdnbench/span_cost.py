"""What the program's spans cost, and what they read, in one cell.

    python3 wdnbench/span_cost.py --workload <name> --seed <n> --iters <k> --rounds <r>

Sets the cell up as a run does, then times ``r`` rounds of two windows of
``k`` iterations each, in turns (off, on, on, off, ...): spans off, and spans
recorded by ``utils.tracing.recording()`` with no profiler. Each window runs
from a drained device to a drained device. Prints one JSON object: the card,
each window's milliseconds an iteration, the on windows' median host
milliseconds an iteration in each span, a span's own cost off and on (a loop
of empty spans), and the set-up spans. Runs on the card only.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from wdnbench import harness  # noqa: E402


def window_ms(runner, iters: int) -> float:
    runner.sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        runner.iteration()
    runner.sync()
    return 1e3 * (time.perf_counter() - t0) / iters


def span_ns(tracing, n: int = 200_000) -> float:
    """Nanoseconds a span, entered and left with nothing inside."""
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with tracing.span("cost.empty"):
            pass
    return (time.perf_counter_ns() - t0) / n


def per_iteration_ms(tracing, spans, root: str) -> dict:
    """Median host ms an iteration in each span name under the roots ``root``,
    and in the roots' own time outside their children (``<root>.self``)."""
    roots = {s.span_id for s in spans if s.name == root and s.parent_id is None}
    own = tracing.self_ns(spans)
    sums = defaultdict(lambda: defaultdict(int))
    for s in spans:
        if s.request_id in roots:
            sums[s.name][s.request_id] += s.duration_ns
        if s.span_id in roots:
            sums[root + ".self"][s.span_id] = own[s.span_id]
    return {name: 1e-6 * statistics.median(v.values()) for name, v in sums.items()}


def measure(cell, seed: int, dev, iters: int, rounds: int) -> dict:
    from gnn_pressure_estimation_tpu_torch.utils import tracing
    from wdnbench import traffic

    runner = traffic.KINDS[cell.traffic["kind"]](cell, seed, dev)
    runner.setup()
    runner.sync()
    setup = {"setup_s": time.perf_counter() - T_START, **runner.setup_times,
             "spans": [[s.name, s.parent_id is None, 1e-9 * s.duration_ns, s.attrs]
                       for s in tracing.spans()]}
    root = "infer" if cell.traffic["kind"] == "serve" else "train_step"
    off, on = [], []
    for r in range(rounds):
        for mode in (("off", "on") if r % 2 == 0 else ("on", "off")):
            if mode == "on":
                tracing.clear()
                with tracing.recording():
                    on.append(window_ms(runner, iters))
                phases = per_iteration_ms(tracing, tracing.spans(), root)
            else:
                off.append(window_ms(runner, iters))
        runner.settle()
    tracing.clear()
    empty_off = span_ns(tracing)
    with tracing.recording():
        empty_on = span_ns(tracing)
    tracing.clear()
    return {"workload": cell.name, "seed": seed, "iters": iters, "off_ms": off, "on_ms": on,
            "on_cost": statistics.median(on) / statistics.median(off) - 1,
            "phases_ms": phases, "empty_span_ns": {"off": empty_off, "on": empty_on},
            "setup": setup}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--iters", type=int, required=True)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    out = {"card": harness.power_limit(), "torch": torch.__version__,
           **measure(harness.Cell(args.workload), args.seed, torch.device("cuda"), args.iters,
                     args.rounds)}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
