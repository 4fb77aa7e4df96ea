"""Evaluation parity fixture: the JAX ``Evaluator`` on a bigtown test split.

    python tools/eval_parity_export.py > artifacts/eval_bigtown.log
        [--scenarios 80] [--batch 16] [--trials 2] [--scenes 4] [--sensors 20] [--seed 1234]

Runs on the CPU through the JAX package (its Pallas band kernels in
interpret mode, as ``GraphTemplate.batch`` attaches them) and writes two
files:

``artifacts/eval_bigtown.zip`` — a bigtown pressure store. Its snapshots are
made by the JAX generator (``simgen.runner.generate``) from
``configs/bigtown.ini`` with the README's generation flags (``gen_demand``,
``gen_res_total_head``, ``update_totalhead_method add_max_elevation``, warning
codes accepted, pressures within [-5, 500]) at ``--scenarios`` scenarios, in
one process so that the rows come in the same order on every run,
split train 0.5 / valid 0.1 / test 0.4 (32 test snapshots at the default),
and the ``pressure`` group is then written again with
``ZarrZipWriter(compressor="blosc")``, so a reader of the store decodes
Blosc-lz4 frames, the reference's own chunk encoding. The train split gives
the normalization statistics.

``artifacts/parity_eval_bigtown.npz`` holds the SHA-256 of every array the
JAX reader gives for the store's splits (``sha_raw_<split>``) and of the
scaled train and test arrays of its ``WDNDataset``s (``sha_train``,
``sha_test``: bytes, dtype and shape), which a reader of the store must match
bit for bit, and the trained GATRes-large of
``artifacts/parity_r5_trained.npz`` evaluated by the JAX ``Evaluator``
(banded, BLK 256, mse, mask_rate 0.95, ``--sensors`` junctions drawn with
numpy from ``--seed`` as ``sensor_names``):

* ``clean``: ``--trials`` mask redraws over the test split at ``--batch``;
* ``noisy11`` and ``noisyNN``: ``--scenes`` noise scenes from
  ``make_noisy_scenes`` (mean_dmd 0.05, std_dmd 0.2, ``backend="cpp"``,
  scene t seeded ``--seed`` + t), on the scene-batched path (all scenes on
  the batch axis), 1 and ``--scenes`` mask draws.

For each it stores every mask the harness drew, in order (``<type>_masks``,
bit-packed rows of ``<type>_mask_width`` nodes, original node order), the
per-call values (``<type>_values``: one row per ``run_trial`` call or scene
row, the loss then the metrics in ``metric_names`` order; the sensor pass's
in ``<type>_sensor_values``) and the aggregated dicts (``<type>_agg_<key>``,
timing keys left out). It also stores the statistics (``stats_*``), the
sensor names, the configuration, and for each scene the demand the solver
was handed (``scene_demand``, cfs, after the noise) and the pressures it
returned (``scene_pressure``, m, every node).
"""

from __future__ import annotations

import argparse
import configparser
import hashlib
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INP = os.path.join(ROOT, "inputs", "bigtown.inp")
TIMING = ("test_time", "test_throughput")


def digest(a) -> str:
    """SHA-256 of an array's bytes, dtype and shape."""
    a = np.ascontiguousarray(a)
    return hashlib.sha256(a.tobytes() + f"{a.dtype.str}{a.shape}".encode()).hexdigest()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenarios", type=int, default=80)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--trials", type=int, default=2)
    ap.add_argument("--scenes", type=int, default=4)
    ap.add_argument("--sensors", type=int, default=20)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--zip", default=os.path.join(ROOT, "artifacts", "eval_bigtown.zip"))
    ap.add_argument("--out", default=os.path.join(ROOT, "artifacts", "parity_eval_bigtown.npz"))
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import jax.numpy as jnp

    from gnn_pressure_estimation_tpu.data import noisy
    from gnn_pressure_estimation_tpu.data.dataset import WDNDataset
    from gnn_pressure_estimation_tpu.data.zarrzip import ZarrZipReader, ZarrZipWriter
    from gnn_pressure_estimation_tpu.evaluation import harness
    from gnn_pressure_estimation_tpu.evaluation.harness import EvalConfig, Evaluator
    from gnn_pressure_estimation_tpu.models.gatres import GATRes
    from gnn_pressure_estimation_tpu.simgen.config import GenOptions
    from gnn_pressure_estimation_tpu.simgen.runner import generate
    from parity_train_export import flax_tree_from_npz

    t_all = time.time()
    print(f"eval parity export, {time.strftime('%a %b %d %H:%M:%S UTC %Y', time.gmtime())}")

    # ---- the store: generate, then write the pressure group blosc-compressed
    with tempfile.TemporaryDirectory() as tmp:
        cfg = configparser.ConfigParser()
        cfg.read(os.path.join(ROOT, "configs", "bigtown.ini"))
        cfg.set("general", "wn_inp_path", INP)
        cfg.set("general", "storage_dir", os.path.join(tmp, "bigtown"))
        cfg.set("general", "num_scenarios", str(args.scenarios))
        ini = os.path.join(tmp, "bigtown.ini")
        with open(ini, "w") as f:
            cfg.write(f)
        opts = GenOptions(
            config=ini, gen_demand=True, gen_res_total_head=True,
            update_totalhead_method="add_max_elevation", accept_warning_code=True,
            pressure_lowerbound=-5.0, pressure_upperbound=500.0, att="pressure",
            batch_size=10, executors=1, train_ratio=0.5, valid_ratio=0.1, seed=args.seed,
            save_params=False, backend="cpp")
        t0 = time.time()
        gen_zip = generate(ini, opts, log_fn=lambda m: print("  " + m.replace(tmp, "<tmp>")))
        print(f"generated {args.scenarios} scenarios in {time.time() - t0:.1f} s")
        with ZarrZipReader(gen_zip) as r:
            root = r.root()
            attrs = root.attrs
            grp = root["pressure"]
            splits = {s: grp[s] for s in ("train", "valid", "test")}
            grp_attrs = grp.attrs
        os.makedirs(os.path.dirname(args.zip), exist_ok=True)
        with ZarrZipWriter(args.zip, compressor="blosc") as w:
            w.set_attrs("", {"config": attrs["config"],
                             "ordered_names_by_attr": {"pressure": attrs["ordered_names_by_attr"]["pressure"]}})
            w.create_group("pressure")
            w.set_attrs("pressure", grp_attrs)
            for s, a in splits.items():
                w.write_array(f"pressure/{s}", a, chunks=(opts.batch_size, a.shape[-1]))
    print(f"wrote {os.path.relpath(args.zip, ROOT)} ({os.path.getsize(args.zip) / 1e6:.2f} MB, blosc-lz4): "
          + ", ".join(f"{s} {a.shape} {a.dtype}" for s, a in splits.items()))

    train = WDNDataset([args.zip], [INP], from_set="train")
    test = WDNDataset([args.zip], [INP], from_set="test", stats=train.stats)
    stats = train.stats
    tpl = test.members[0].template
    print(f"stats {stats}; test {len(test)} snapshots of {tpl.n_node} nodes")

    d = dict(np.load(os.path.join(ROOT, "artifacts", "parity_r5_trained.npz")))
    model = GATRes(num_blocks=int(d["num_blocks"]), channels=int(d["nc"]))
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), flax_tree_from_npz(d))
    g = tpl.batch(args.batch)
    print(f"banded {g.banded}, v2 band attention {g.band_attn_dma is not None}, "
          f"band SpMM {g.band_spmm_dma is not None} (Pallas, interpret mode on the CPU)")
    sensor_names = sorted(np.random.default_rng(args.seed).choice(
        np.asarray(tpl.node_names), args.sensors, replace=False).tolist())

    # ---- spies: the masks drawn, the per-call values, the scenes' solves
    masks, calls = [], []
    draw = harness.batch_node_mask

    def recording_draw(*a, **kw):
        m = draw(*a, **kw)
        masks.append(np.asarray(m, bool))
        return m

    harness.batch_node_mask = recording_draw
    run_trial = Evaluator.run_trial

    def recording_trial(self, *a, **kw):
        loss, mets = run_trial(self, *a, **kw)
        calls.append((loss, dict(mets)))
        return loss, mets

    Evaluator.run_trial = recording_trial
    run_scenes = Evaluator.run_scene_trials

    def recording_scenes(self, *a, **kw):
        rows = run_scenes(self, *a, **kw)
        calls.extend(rows)
        return rows

    Evaluator.run_scene_trials = recording_scenes
    solves = []
    solve = noisy.solve

    def recording_solve(ns, backend=None):
        res = solve(ns, backend=backend)
        solves.append((ns.demand.copy(), res.pressure.copy()))
        return res

    noisy.solve = recording_solve

    payload = {"sensor_names": np.asarray(sensor_names), "seed": np.int64(args.seed),
               "batch_size": np.int64(args.batch), "num_trials": np.int64(args.trials),
               "num_scenes": np.int64(args.scenes), "mask_rate": np.float64(0.95),
               "mean_dmd": np.float64(0.05), "std_dmd": np.float64(0.2),
               "n_node": np.int64(tpl.n_node),
               "sha_train": np.bytes_(digest(train.members[0].array).encode()),
               "sha_test": np.bytes_(digest(test.members[0].array).encode())}
    with ZarrZipReader(args.zip) as r:
        for split in ("train", "valid", "test"):
            payload[f"sha_raw_{split}"] = np.bytes_(digest(r.read_array(f"pressure/{split}")).encode())
    for k in ("mean", "std", "min", "max"):
        payload[f"stats_{k}"] = np.float64(getattr(stats, k))
    common = dict(mask_rate=0.95, gpu_warmup_times=0, seed=args.seed, sensor_names=sensor_names)

    def record(kind, ecfg, datasets):
        masks.clear()
        calls.clear()
        t0 = time.time()
        loss_d, met_d, sen_d = Evaluator(model, ecfg, stats).evaluate(
            params, datasets, log_fn=lambda m: print("  " + m.strip()))
        first = calls[0]
        names = list(first["mets"] if isinstance(first, dict) else first[1])
        if isinstance(first, dict):        # scene rows: all-nodes and sensor values in each
            vals = [[r["loss"], *(r["mets"][k] for k in names)] for r in calls]
            svals = [[r["s_loss"], *(r["s_mets"][k] for k in names)] for r in calls]
        else:                                 # run_trial calls: all-nodes, then sensors
            rows = [[loss, *(mets[k] for k in names)] for loss, mets in calls]
            vals, svals = rows[0::2], rows[1::2]
        payload["metric_names"] = np.asarray(names)
        payload[f"{kind}_values"] = np.asarray(vals, np.float64)
        payload[f"{kind}_sensor_values"] = np.asarray(svals, np.float64)
        payload[f"{kind}_mask_width"] = np.int64(masks[0].size)
        payload[f"{kind}_masks"] = np.stack([np.packbits(m.reshape(-1)) for m in masks])
        for key, v in {**loss_d, **met_d, **sen_d}.items():
            if not key.startswith(TIMING):
                payload[f"{kind}_agg_{key}"] = np.float64(v)
        print(f"{kind}: {len(masks)} masks, {len(vals)} trials, loss {loss_d['test_loss_mean']:.6g}, "
              f"MAE {met_d['test_mae_mean']:.6g} m, sensors MAE {sen_d['test_mae_sensor_mean']:.6g} m; "
              f"{time.time() - t0:.1f} s")

    record("clean", EvalConfig(test_type="clean", num_test_trials=args.trials,
                               batch_size=args.batch, **common), test)
    ncfg = dict(num_test_trials=args.scenes, batch_size=args.batch, mean_dmd=0.05, std_dmd=0.2,
                **common)
    t0 = time.time()
    scenes = harness.make_noisy_scenes([INP], EvalConfig(test_type="noisy11", **ncfg), stats,
                                       backend="cpp")
    print(f"{len(scenes)} noise scenes solved in {time.time() - t0:.1f} s (cpp); shared template "
          f"{len({id(s.members[0].template) for s in scenes}) == 1}")
    payload["scene_demand"] = np.stack([dm for dm, _ in solves])
    payload["scene_pressure"] = np.stack([p for _, p in solves])
    record("noisy11", EvalConfig(test_type="noisy11", **ncfg), scenes)
    record("noisyNN", EvalConfig(test_type="noisyNN", **ncfg), scenes)

    np.savez_compressed(args.out, **payload)
    print(f"wrote {os.path.relpath(args.out, ROOT)} ({os.path.getsize(args.out) / 1e6:.2f} MB) "
          f"in {time.time() - t_all:.1f} s")


if __name__ == "__main__":
    main()
