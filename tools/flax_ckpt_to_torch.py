"""Convert a checkpoint of the JAX package (flax msgpack) into the port's format.

    python tools/flax_ckpt_to_torch.py IN.ckpt OUT.ckpt [--model NAME]

Runs on the JAX side, on the CPU: the port cannot read msgpack without flax.
It reads IN with the JAX package's ``load_checkpoint`` (no template, so the
trees come back as nested dicts of numpy arrays) and writes OUT with the
port's ``save_checkpoint`` (one ``torch.save`` file). A JAX checkpoint does
not name its model, so ``--model`` does, as for the JAX ``cli infer``
(default ``gatres_small``); the tree must have that model's structure:

- the parameters through ``weights.params_from_flax`` (kernels transposed
  into ``nn.Linear`` weights);
- the optimizer state as ``Trainer.opt_state_dict()`` lays it out: Adam's
  moments and step count through ``weights.adam_state_from_optax``, the
  learning rate that ``optax.inject_hyperparams`` carries, and AutoClip's
  ring buffer where the run clipped. A weights-only checkpoint stays one;
- ``meta`` as it is: epoch, loss, metrics, the normalization statistics, and
  ``extra`` with the resume state and the layout the model was trained under.

A model trained by the JAX package then serves through the port's
``cli infer`` and resumes through ``cli train --model_path``.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _find(tree, keys: set, out: list):
    """Every dict in ``tree`` that has all of ``keys``, depth first."""
    if isinstance(tree, dict):
        if keys <= set(tree):
            out.append(tree)
        for v in tree.values():
            _find(v, keys, out)
    return out


def opt_state_from_optax(opt_state, model) -> dict:
    """A raw optax state tree (the JAX ``Trainer``'s chain: optional AutoClip,
    weight decay, ``scale_by_adam``, then ``inject_hyperparams``) → the flat
    name → tensor dict of ``Trainer.opt_state_dict()``."""
    import numpy as np
    import torch

    from gnn_pressure_estimation_tpu_torch.weights import adam_state_from_optax

    adam = _find(opt_state, {"count", "mu", "nu"}, [])
    hyper = _find(opt_state, {"hyperparams"}, [])
    clip = _find(opt_state, {"history", "count"}, [])
    if len(adam) != 1 or len(hyper) != 1 or len(clip) > 1:
        raise ValueError(f"not the JAX Trainer's optimizer chain: {len(adam)} Adam states, "
                         f"{len(hyper)} hyperparameter states, {len(clip)} AutoClip states")
    out = {"lr": torch.tensor(float(np.asarray(hyper[0]["hyperparams"]["learning_rate"])),
                              dtype=torch.float64)}
    a = adam[0]
    param_names = [k for k, _ in model.named_parameters()]
    for i, st in adam_state_from_optax(a["mu"], a["nu"], int(np.asarray(a["count"])),
                                       model).items():
        name = param_names[i]
        out[f"adam.step.{name}"] = st["step"]
        out[f"adam.exp_avg.{name}"] = st["exp_avg"]
        out[f"adam.exp_avg_sq.{name}"] = st["exp_avg_sq"]
    if clip:
        out["autoclip.history"] = torch.from_numpy(np.array(clip[0]["history"], np.float32))
        out["autoclip.count"] = torch.tensor(int(np.asarray(clip[0]["count"])), dtype=torch.int64)
    return out


def convert(src: str, dst: str, model) -> dict:
    """Write the port's checkpoint ``dst`` from the JAX checkpoint ``src`` of
    a model with ``model``'s structure (a port ``nn.Module``); returns its
    ``meta``."""
    sys.path.insert(0, ROOT)
    from gnn_pressure_estimation_tpu.train.checkpoint import load_checkpoint
    from gnn_pressure_estimation_tpu_torch.train.checkpoint import save_checkpoint
    from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats
    from gnn_pressure_estimation_tpu_torch.weights import params_from_flax

    params, opt_state, meta = load_checkpoint(src)
    state_dict = params_from_flax(params, model)
    missing = [k for k, _ in model.named_parameters() if k not in state_dict]
    if missing:
        raise ValueError(f"{src} holds no parameters for {missing[:4]}: not a "
                         f"{type(model).__name__} of this depth")
    opt = opt_state_from_optax(opt_state, model) if opt_state else None
    stats = meta.get("stats")
    save_checkpoint(dst, state_dict, opt, epoch=meta.get("epoch", 0), loss=meta.get("loss", 0.0),
                    metrics=meta.get("metrics"),
                    stats=NormStats.from_dict(stats.to_dict()) if stats is not None else None,
                    extra=meta.get("extra"))
    return meta


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", help="a checkpoint written by the JAX package (flax msgpack)")
    ap.add_argument("dst", help="the port's checkpoint to write")
    ap.add_argument("--model", default="gatres_small",
                    help="the preset the checkpoint was trained as (default gatres_small)")
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ROOT)
    from gnn_pressure_estimation_tpu_torch.models.presets import select_model

    meta = convert(args.src, args.dst, select_model(args.model, device="cpu")[0])
    layout = (meta.get("extra") or {}).get("layout")
    print(f"wrote {args.dst}: epoch {meta.get('epoch')}, loss {meta.get('loss')}, layout {layout}")


if __name__ == "__main__":
    main()
