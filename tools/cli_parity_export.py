"""Serving parity fixture: the JAX ``cli infer`` on the trained GATRes-large.

    python tools/cli_parity_export.py > artifacts/parity_infer_bigtown.log
        [--num-snapshots 8] [--batch 8] [--seed 1234] [--mask-rate 0.95]

Runs on the CPU through the JAX package (its Pallas band kernels in
interpret mode, matmul precision ``highest``):

1. a flax checkpoint is written with the JAX ``save_checkpoint``: the weights
   of ``artifacts/parity_r5_trained.npz`` and the normalization statistics of
   the train split of ``artifacts/eval_bigtown.zip`` (the JAX
   ``WDNDataset``), with the JAX ``Trainer``'s default layout in ``extra``;
2. ``tools/flax_ckpt_to_torch.py`` converts it, and the port's parameters
   must equal ``weights.params_from_parity_npz`` of the same npz bit for bit,
   and its statistics the JAX ones (or the tool exits non-zero);
3. the JAX ``cli infer`` runs on the flax checkpoint:
   ``--from_set test --observed random --seed 1234 --mask_rate 0.95
   --num_snapshots 8 --batch_size 8`` on ``eval_bigtown.zip`` (banded, BLK
   256, the v2 band attention and the band SpMM).

It writes ``artifacts/parity_infer_bigtown.npz``: the exported fields
(``pred``, ``true``, ``observed``, ``node_names``: ``InferenceResult.save_npz``)
and the argv, which ``chip_smoke.py`` phase 36 replays through the port's
``cli infer`` on a checkpoint it builds on the card.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# relative to the repository's root, where the tool runs
INP = "inputs/bigtown.inp"
ZIP = "artifacts/eval_bigtown.zip"
NPZ = "artifacts/parity_r5_trained.npz"


def infer_flags(args) -> list:
    """The ``infer`` flags, the model and its path and the export apart."""
    return ["--test_data_path", ZIP, "--test_input_path", INP, "--from_set", "test",
            "--observed", "random", "--seed", str(args.seed), "--mask_rate", str(args.mask_rate),
            "--num_snapshots", str(args.num_snapshots), "--batch_size", str(args.batch)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-snapshots", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--mask-rate", type=float, default=0.95)
    ap.add_argument("--out", default=os.path.join(ROOT, "artifacts", "parity_infer_bigtown.npz"))
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    os.chdir(ROOT)
    import torch

    from flax_ckpt_to_torch import convert
    from gnn_pressure_estimation_tpu.cli import main as jax_cli
    from gnn_pressure_estimation_tpu.data.dataset import WDNDataset
    from gnn_pressure_estimation_tpu.train.checkpoint import save_checkpoint
    from gnn_pressure_estimation_tpu_torch.models.presets import select_model
    from gnn_pressure_estimation_tpu_torch.train.checkpoint import load_checkpoint
    from gnn_pressure_estimation_tpu_torch.weights import params_from_parity_npz
    from parity_train_export import flax_tree_from_npz

    t_all = time.time()
    print(f"cli parity export, {time.strftime('%a %b %d %H:%M:%S UTC %Y', time.gmtime())}")
    stats = WDNDataset([ZIP], [INP], from_set="train").stats
    print(f"stats of the train split: {stats}")
    with tempfile.TemporaryDirectory() as tmp:
        flax_ckpt = os.path.join(tmp, "gatres_large.msgpack.ckpt")
        torch_ckpt = os.path.join(tmp, "gatres_large.torch.ckpt")
        save_checkpoint(flax_ckpt, flax_tree_from_npz(dict(np.load(NPZ))), stats=stats,
                        extra={"layout": {"agg_mode": None, "band_block": None}})
        convert(flax_ckpt, torch_ckpt, select_model("gatres_large", device="cpu")[0])
        params, opt_state, meta = load_checkpoint(torch_ckpt)
        ref = params_from_parity_npz(NPZ)
        if params.keys() != ref.keys() or any(not torch.equal(params[k], ref[k]) for k in ref):
            sys.exit("FAIL the converted parameters are not params_from_parity_npz's bit for bit")
        if meta["stats"].to_dict() != stats.to_dict() or opt_state is not None:
            sys.exit(f"FAIL the converted meta: {meta}")
        print(f"converter: {len(params)} tensors bit-equal to params_from_parity_npz, stats equal, "
              f"no optimizer state (a weights-only checkpoint), layout {meta['extra']['layout']}")

        out_npz = os.path.join(tmp, "pred.npz")
        t0 = time.time()
        with contextlib.redirect_stdout(io.StringIO()) as said:
            rc = jax_cli(["infer", "--model", "gatres_large", "--model_path", flax_ckpt,
                          *infer_flags(args), "--device", "cpu", "--out_npz", out_npz])
        print("  " + said.getvalue().strip().replace(tmp, "<tmp>").replace("\n", "\n  "))
        assert rc == 0
        print(f"JAX cli infer --model gatres_large {' '.join(infer_flags(args))} --device cpu: "
              f"{time.time() - t0:.1f} s")
        with np.load(out_npz) as z:
            res = dict(z)
    obs = res["observed"].astype(bool)
    print(f"pred {res['pred'].shape}, {int(obs.sum())} observed; observed nodes served at their "
          f"values: {np.array_equal(res['pred'][:, obs], res['true'][:, obs])}; hidden MAE "
          f"{np.abs(res['pred'][:, ~obs] - res['true'][:, ~obs]).mean():.6f} m")
    np.savez_compressed(args.out, **res, argv=np.asarray(infer_flags(args)))
    print(f"wrote {os.path.relpath(args.out)} ({os.path.getsize(args.out) / 1e6:.2f} MB) "
          f"in {time.time() - t_all:.1f} s")


if __name__ == "__main__":
    main()
