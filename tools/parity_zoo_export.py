"""Parity fixtures of the model zoo: a forward and a masked train step of
each baseline preset through the JAX ``Trainer``, on bigtown.

    python tools/parity_zoo_export.py                 # all six presets
    python tools/parity_zoo_export.py --models gin,mgcn [--seed N] [--out-dir DIR]

Runs on the CPU. For each preset of the registry's zoo (``gin``, ``gat``,
``gcn2``, ``chebnet``, ``graphconvwat``, ``mgcn``) it writes
``artifacts/parity_zoo_<model>.npz``: the model at its preset width and
depth (m_GCN cut to 4 of its 45 aggregations at full width, latent 96 and
edge_dim 2, as the meganet GATRes fixture is cut to 4 blocks) on
``inputs/bigtown.inp`` (5,821 junctions; banded, BLK 256, B 1, the default
layout), with

* ``param/<flax path>``: the weights of the JAX ``Trainer``'s ``model.init``
  (seed ``--seed``), in the flax layout (``weights.params_from_flax`` of the
  port maps them);
* ``x`` [n]: the first snapshot of the test split of
  ``artifacts/eval_bigtown.zip``, scaled by the preset's ``norm_type`` with the
  statistics of its train split (``stats_*``); for m_GCN also the scaled edge
  attributes (diameter, length) of the template in its own edge order
  (``edge_attr``);
* ``mask`` [n] bool: one explicit node mask (mask_rate 0.95, numpy from the
  seed), original node order;
* the serving forward of the masked input: ``out`` [n, 1], and after each
  layer (``act_layers``: the port's module names, ``convs.i`` or ``gcn.i``)
  its output on 256 fixed real rows (``act_rows``, original order;
  ``act/<layer>``) and its largest magnitude over all real rows
  (``act_absmax``);
* through ``Trainer._masked_loss_and_metrics`` with the preset's criterion:
  ``loss``, the train metrics (``metric_<name>``), every gradient
  (``grad/<flax path>``), and after 3 Adam steps at the ``TrainConfig``
  defaults on that batch and mask the step losses, the loss after them and
  the parameters of at most 100,000 values each (``p3/<flax path>``).

On bigtown no zoo layer reaches a Pallas kernel in the JAX package: the
band SpMM takes only widths that are multiples of 128 and the v2 band
attention H·C multiples of 128, so every layer runs its plain XLA band path
(m_GCN its segment ops). Each fixture's log is the script's output.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
MODELS = ("gin", "gat", "gcn2", "chebnet", "graphconvwat", "mgcn")
MGCN_AGGR = 4            # of the preset's 45
ACT_ROWS = 256
P3_MAX = 100_000


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flat(v, path))
        else:
            out[path] = np.asarray(v, np.float32)
    return out


def layer_names(params) -> list[tuple[str, str]]:
    """(flax module, the port's module name) of each layer, in call order."""
    out = []
    for fam in ("GINConv", "GATConv", "GCN2Conv", "ChebConv", "gcn"):
        i = 0
        while f"{fam}_{i}" in params:
            out.append((f"{fam}_{i}", f"{'gcn' if fam == 'gcn' else 'convs'}.{i}"))
            i += 1
    return out


def export(name: str, seed: int, out_dir: str) -> str:
    import jax
    import jax.numpy as jnp
    import optax

    from gnn_pressure_estimation_tpu.data.dataset import WDNDataset
    from gnn_pressure_estimation_tpu.models.presets import MODEL_REGISTRY
    from gnn_pressure_estimation_tpu.train.loop import TrainConfig, Trainer
    from gnn_pressure_estimation_tpu.utils.masking import masked_count

    t0 = time.time()
    preset = MODEL_REGISTRY[name]
    model = preset.make()
    if name == "mgcn":
        model = model.clone(n_aggr=MGCN_AGGR)
    zip_path = os.path.join(ROOT, "artifacts", "eval_bigtown.zip")
    inp = os.path.join(ROOT, "inputs", "bigtown.inp")
    kw = dict(norm_type=preset.norm_type, edge_attrs=preset.edge_attrs)
    train = WDNDataset([zip_path], [inp], from_set="train", **kw)
    test = WDNDataset([zip_path], [inp], from_set="test", stats=train.stats, **kw)
    tpl = test.members[0].template
    n = tpl.n_node
    cfg = TrainConfig(batch_size=1, donate_state=False, seed=seed, criterion=preset.criterion,
                      norm_type=preset.norm_type)
    trainer = Trainer(model, cfg, train.stats, tpl)
    params = trainer.params
    graph = trainer._batched_graph(tpl, 1)
    if not graph.banded or (graph.band_spmm_dma is None) or graph.band_attn_dma is None:
        raise SystemExit("bigtown did not take the banded layout with the Pallas kernels attached")

    k = masked_count(n, cfg.mask_rate)
    mask = np.zeros(n, bool)
    mask[np.random.default_rng(seed).permutation(n)[:k]] = True
    x = np.asarray(test.members[0].array[0], np.float32)
    xp = graph.pack_nodes(jnp.asarray(x)[:, None], n)
    maskp = graph.pack_nodes(jnp.asarray(mask, jnp.float32)[:, None], n)[:, 0] > 0.5

    st = train.stats
    payload = {
        "model": np.bytes_(name.encode()), "criterion": np.bytes_(preset.criterion.encode()),
        "norm_type": np.bytes_(preset.norm_type.encode()),
        "hparams": np.bytes_(json.dumps({"n_aggr": MGCN_AGGR} if name == "mgcn" else {}).encode()),
        "stats_mean": np.float64(st.mean), "stats_std": np.float64(st.std),
        "stats_min": np.float64(st.min), "stats_max": np.float64(st.max),
        "x": x, "mask": mask, "n_masked": np.int64(k), "seed": np.int64(seed),
        "lr": np.float64(cfg.lr), "weight_decay": np.float64(cfg.weight_decay),
    }
    if tpl.edge_attr is not None:
        payload["edge_attr"] = np.asarray(tpl.edge_attr, np.float32)
    for path, a in flat(params["params"]).items():
        payload[f"param/{path}"] = a

    x_in = jnp.where(maskp[:, None], 0.0, xp)
    out, state = jax.jit(lambda p: model.apply(
        p, x_in, graph, capture_intermediates=True, mutable=["intermediates"]))(params)
    payload["out"] = np.asarray(graph.unpack_nodes(out, n))
    rows = np.sort(np.random.default_rng(seed + 1).choice(n, ACT_ROWS, replace=False))
    payload["act_rows"] = rows
    layers = layer_names(params["params"])
    payload["act_layers"] = np.asarray([p for _, p in layers])
    absmax = []
    for flax_name, port_name in layers:
        a = np.asarray(graph.unpack_nodes(state["intermediates"][flax_name]["__call__"][0], n))
        payload[f"act/{port_name}"] = a[rows]
        absmax.append(float(np.abs(a).max()))
    payload["act_absmax"] = np.asarray(absmax, np.float32)
    print(f"{name}: n {n}, {len(layers)} layers, forward output in "
          f"[{float(payload['out'].min()):.5g}, {float(payload['out'].max()):.5g}], "
          f"layer |act| max {np.round(absmax, 4).tolist()}")

    @jax.jit
    def value_and_grad(p):
        def loss_fn(p_):
            loss, mets, _ = trainer._masked_loss_and_metrics(p_, graph, xp, xp, maskp, k, "train")
            return loss, mets
        return jax.value_and_grad(loss_fn, has_aux=True)(p)

    (loss, mets), grads = value_and_grad(params)
    payload["loss"] = np.float64(loss)
    for m, v in mets.items():
        payload[f"metric_{m}"] = np.float64(v)
    g = flat(grads["params"])
    for path, a in g.items():
        payload[f"grad/{path}"] = a
    print(f"  {preset.criterion} loss {float(loss):.8g}; {len(g)} gradients, "
          f"{sum(a.size for a in g.values())} values, largest |g| "
          f"{max(float(np.abs(a).max()) for a in g.values()):.4g}")

    p, opt_state, step_losses = params, trainer.tx.init(params), []
    for _ in range(3):
        (l_, _), gr = value_and_grad(p)
        updates, opt_state = trainer.tx.update(gr, opt_state, p)
        p = optax.apply_updates(p, updates)
        step_losses.append(float(l_))
    (loss_after, _), _ = value_and_grad(p)
    payload["step_losses"] = np.asarray(step_losses, np.float64)
    payload["loss_after"] = np.float64(loss_after)
    kept = {path: a for path, a in flat(p["params"]).items() if a.size <= P3_MAX}
    for path, a in kept.items():
        payload[f"p3/{path}"] = a
    print(f"  3 Adam steps: losses {step_losses}, then {float(loss_after):.8g}; parameters "
          f"after them kept for {len(kept)} of {len(g)}")
    out_path = os.path.join(out_dir, f"parity_zoo_{name}.npz")
    np.savez_compressed(out_path, **payload)
    print(f"wrote {os.path.relpath(out_path, ROOT)} ({os.path.getsize(out_path) / 1e6:.2f} MB) "
          f"in {time.time() - t0:.1f} s")
    return out_path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", default=",".join(MODELS))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-dir", default=os.path.join(ROOT, "artifacts"))
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    sys.path.insert(0, ROOT)
    for name in args.models.split(","):
        if name not in MODELS:
            ap.error(f"unknown model {name!r}: one of {MODELS}")
        export(name, args.seed, args.out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
