"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 wdnbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its limit,
which also end standard error. Exits non-zero, printing no result, without
enough CUDA devices, or if JAX or the JAX package is loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from wdnbench import harness  # noqa: E402


def refuse_forbidden(when: str):
    found = harness.forbidden_modules()
    if found:
        print(f"refused {when}: loaded {', '.join(found)}; the benchmark imports neither JAX "
              "nor the JAX package", file=sys.stderr)
        raise SystemExit(3)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    refuse_forbidden("at start")

    import torch

    torch_s = time.perf_counter() - T_START
    chips = int(harness.Cell(args.workload).entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        raise SystemExit(2)
    result, numbers = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                                  t_start=T_START)
    refuse_forbidden("after the window")
    result["device"]["power_limit"] = harness.power_limit()
    notes = numbers.pop("_notes")
    notes["setup"] = {"torch_imported_s": torch_s, **notes["setup"]}
    extra = {k: v for k, v in numbers.items() if k.startswith("_")}
    print(f"card: {result['device']['power_limit']}", file=sys.stderr)
    for name, note in notes.items():
        print(f"{name}: {json.dumps(note)}", file=sys.stderr)
    print(f"not limited: {json.dumps(extra)}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
