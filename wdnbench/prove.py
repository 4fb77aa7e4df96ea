"""Readings that set and prove the limits of ``correct``, on the card.

    python3 wdnbench/prove.py --workload <cell> --seeds 1,2,3 --seconds 5 \
        [--traced-seeds 4,5] [--control-seeds 6,7,8] [--diagnose] [--out FILE]

For each seed of ``--seeds`` (untraced) and ``--traced-seeds`` (traced), one
whole run of the cell in this process, as ``run.py`` makes it, and every
number its check reads. For each seed of ``--control-seeds``, the control:
the reference put in the program's place and computed with TF32 GEMMs, the
precision below the configuration's float32, read by the same check at the
cell's own sizes. ``--diagnose`` (a training cell) also holds the program's
gradient at the state its window leaves against the reference's and the
port's plain versions'. One JSON line a run goes
to ``--out``; a table to standard output.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from wdnbench import check, harness, reference, traffic  # noqa: E402


def control(cell, seed: int, dev) -> dict:
    """The control's numbers for one seed: the reference computed with TF32
    GEMMs in the program's place, fed as the cell feeds the program, read
    by the cell's own check against the float32 reference."""
    runner = traffic.KINDS[cell.traffic["kind"]](cell, seed, dev)
    mix = cell.traffic
    g = runner._reference_graph()
    runner.feed(g.n)
    rows = int(mix["reference_rows"])
    if mix["kind"] == "serve":
        n_req = int(mix["check_batches"])
        readings = np.concatenate([runner._readings(i) for i in range(n_req)])
        with reference.precision("tf32"):
            low = reference.serve(runner.weights0, torch.as_tensor(readings, device=dev),
                                  runner.observed, runner.mean, runner.std, g,
                                  runner.model_dims, rows).cpu().numpy()
        runner.preds = list(low.reshape(n_req, runner.batch, g.n))
        return runner.check()
    steps = int(mix["checked_steps"])
    with reference.precision("tf32"):
        low = reference.train(runner.weights0, runner.reference_batches(0, steps), runner.hidden,
                              g, runner.model_dims, mix["optimizer"], rows)
        # the window's end: the next batch's gradient at the weights the steps left
        wgrad = runner.reference_grad(low["params"], steps, g)
    runner.prog = {"losses": low["losses"], "grad1": check.to_host(low["grad1"]),
                   "params": check.to_host(low["params"]),
                   "params0": check.to_host(runner.weights0),
                   "wparams": check.to_host(low["params"]), "wgrad": wgrad}
    runner.wstep = steps
    return runner.check()


def plant(fault: str):
    """Break the timed path underneath, in the program: ``unchanged`` (the
    optimizer's step leaves the state as it was), ``half`` (half of each batch
    left out, the mean taken over the rest), ``altered`` (one served value
    moved by 1% of its size). Returns a function that takes the fault out."""
    from gnn_pressure_estimation_tpu_torch.evaluation.infer import Inferencer
    from gnn_pressure_estimation_tpu_torch.train.loop import Trainer

    saved = [(torch.optim.Adam, "step", torch.optim.Adam.step),
             (Trainer, "train_step", Trainer.train_step),
             (Inferencer, "infer", Inferencer.infer)]
    step, infer = Trainer.train_step, Inferencer.infer
    if fault == "unchanged":
        torch.optim.Adam.step = lambda self, closure=None: None
    elif fault == "half":
        def half_step(self, template, xb, mask=None, generator=None):
            h = xb.shape[0] // 2
            return step(self, template, xb[:h], mask=mask[:h * xb.shape[1]], generator=generator)

        def half_infer(self, template, values, observed_idx, **kwargs):
            res = infer(self, template, values[:values.shape[0] // 2], observed_idx, **kwargs)
            res.pred = np.concatenate([res.pred, res.pred])
            return res
        Trainer.train_step, Inferencer.infer = half_step, half_infer
    elif fault == "altered":
        def altered(self, *args, **kwargs):
            res = infer(self, *args, **kwargs)
            j = np.flatnonzero(~res.observed)[0]
            res.pred[min(1, len(res.pred) - 1), j] += 0.01 * (abs(res.pred[0, j]) + 1.0)
            return res
        Inferencer.infer = altered
    else:
        raise ValueError(f"unknown fault {fault!r}")

    def remove():
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
    return remove


def diagnose(runner, out: dict):
    """The gradient at the state the window left, three ways, leaf by leaf:
    the kernels', the port's plain versions' and the reference's (the run's
    own check reads the one Adam received, ``wgrad_gap``)."""
    from gnn_pressure_estimation_tpu_torch.ops import banded as bops

    tr, model = runner.trainer, runner.model
    xb, mask = runner.batch_of(runner.step)
    names = [n for n, _ in model.named_parameters()]

    def program_grad(graphs):
        """The loss and gradient of the batch, summed over ``graphs`` graphs at
        a time (the loss divided by the whole batch's hidden count)."""
        total, grads = 0.0, None
        n_masked = runner.batch * runner.hidden
        n = runner.n
        for lo in range(0, runner.batch, graphs):
            g, x, m, _ = tr._prepare(runner.template, xb[lo:lo + graphs],
                                     mask[lo * n:(lo + graphs) * n], None, None)
            model.train()
            loss, _, _ = tr._masked_loss_and_metrics(g, x, x, m, n_masked, "train")
            part = torch.autograd.grad(loss, list(model.parameters()))
            grads = part if grads is None else [a + b for a, b in zip(grads, part)]
            total += float(loss.detach())
        return total, dict(zip(names, grads))

    lk, gk = program_grad(runner.batch)
    try:
        with bops.plain_versions():
            lp, gp = program_grad(1)
    except torch.OutOfMemoryError:
        lp, gp = float("nan"), None
        torch.cuda.empty_cache()
    p = {n: t.detach().clone() for n, t in model.named_parameters()}
    xr, mr = runner.reference_batches(runner.step, 1)[0]
    with reference.precision("highest"):
        lr_, gr = reference.loss_and_grad(p, xr, mr, runner.hidden, runner._reference_graph(),
                                          runner.model_dims, int(runner.mix["reference_rows"]))

    def gaps(a, b):
        g = check.leaf_gaps(a, b)
        worst, leaf = check.worst(g)
        diff = {n: float((a[n] - b[n]).double().norm() / max(float(b[n].double().norm()), 1e-30))
                for n in b}
        dleaf = max(diff, key=diff.get)
        return {"worst": worst, "leaf": leaf, "median": float(np.median(list(g.values()))),
                "diff_worst": diff[dleaf], "diff_leaf": dleaf}

    out["diag"] = {
        "steps_before": runner.step,
        "loss": {"kernels": lk, "plain": lp, "reference": lr_},
        "kernels_vs_reference": gaps(gk, gr),
        "plain_vs_reference": gaps(gp, gr) if gp else "out of memory",
        "kernels_vs_plain": gaps(gk, gp) if gp else "out of memory",
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--traced-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--diagnose", action="store_true")
    ap.add_argument("--fault", default=None, help="unchanged | half | altered (see plant)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(harness.ROOT), help="a checkout (rehearsals)")
    args = ap.parse_args()
    dev = torch.device(args.device)
    root = Path(args.root)

    def seeds(s):
        return [int(v) for v in s.split(",") if v]

    rows = []
    role = "program" if args.fault is None else "fault:" + args.fault
    plan = ([(role, s, False) for s in seeds(args.seeds)]
            + [("program", s, True) for s in seeds(args.traced_seeds)]
            + [("control", s, False) for s in seeds(args.control_seeds)])
    for role, seed, traced in plan:
        t0 = time.perf_counter()
        row = {"workload": args.workload, "role": role, "seed": seed, "traced": traced}
        try:
            if role == "control":
                row["numbers"] = control(harness.Cell(args.workload, root, root / "wdnbench"),
                                         seed, dev)
            else:
                if dev.type == "cuda":
                    torch.cuda.reset_peak_memory_stats()
                hook = (lambda r: diagnose(r, row)) if args.diagnose else None
                remove = plant(args.fault) if args.fault else (lambda: None)
                try:
                    result, numbers = harness.run(args.workload, seed, args.seconds, traced,
                                                  device=args.device, root=root,
                                                  bench_dir=root / "wdnbench", t_start=t0,
                                                  inspect=hook)
                finally:
                    remove()
                row.update(result=result, numbers=numbers)
        except Exception as exc:          # a failed run is a reading too: record it, go on
            import traceback
            row["error"] = traceback.format_exc()[-3000:]
            print(f"{role} seed {seed}: {exc!r}", file=sys.stderr)
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row, default=str), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row, default=str) + "\n")
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    print("\nrole            seed        traced  " + "  ".join(f"{k:>12}" for k in _keys(rows)))
    for r in rows:
        nums = r.get("numbers", {})
        print(f"{r['role']:15} {r['seed']:<11} {str(r['traced']):6} " + "  ".join(
            f"{nums.get(k, float('nan')):12.4e}" for k in _keys(rows)))


def _keys(rows):
    keys = []
    for r in rows:
        for k in r.get("numbers", {}):
            if not k.startswith("_") and k not in keys:
                keys.append(k)
    return keys


if __name__ == "__main__":
    main()
