"""Training parity fixture: one masked train step of the JAX ``Trainer``.

    python tools/parity_train_export.py [--out artifacts/parity_train_bigtown.npz]
                                        [--path pallas|xla]

Runs on the CPU. GATRes-large with the weights of
``artifacts/parity_r5_trained.npz`` on ``inputs/bigtown.inp`` (banded, BLK
256, batch 1), the snapshot ``x`` of that fixture, one explicit node mask
(mask_rate 0.95, drawn with numpy from ``--seed``), criterion mse,
``NormStats(znorm, mean 50, std 10)``. Through the JAX package's own
``Trainer._masked_loss_and_metrics`` and optimizer it records

* ``mask`` [n] bool (original node order), ``loss``, the seven train
  metrics (``metric_<name>``),
* every parameter's gradient in the PyTorch port's layout and names
  (``grad_<state_dict key>``; kernels transposed as ``weights.py`` does),
* after 3 Adam steps at the ``TrainConfig`` defaults on that same batch and
  mask: the loss at each step (``step_losses``), the loss after the third
  (``loss_after``) and the ``lin0``, ``lin1``, ``blocks.0`` and ``blocks.24``
  parameters (``p3_<state_dict key>``).

``--path pallas`` (default) runs the band kernels as ``template.batch``
attaches them (Pallas, interpret mode on the CPU: the v2 band attention and
the band SpMM, forward and backward); ``--path xla`` strips them so the
plain XLA band ops run. The path taken is stored in the file (``path``) and
printed, so a log beside the fixture says which produced it.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
KEPT_AFTER_3 = ("lin0.", "lin1.", "blocks.0.", "blocks.24.")


def flax_tree_from_npz(d) -> dict:
    """Torch-layout parity npz (``tools/parity_export.py``) → flax tree."""
    p = {
        "lin0": {"kernel": d["w_lin0"].T, "bias": d["b_lin0"]},
        "lin1": {"kernel": d["w_lin1"].T, "bias": d["b_lin1"]},
    }
    for i in range(int(d["num_blocks"])):
        p[f"block_{i}"] = {
            f"GATConv_{j - 1}": {
                "w": d[f"blk{i}_conv{j}_lin_w"].T,
                "att_src": d[f"blk{i}_conv{j}_att_src"],
                "att_dst": d[f"blk{i}_conv{j}_att_dst"],
                "bias": d[f"blk{i}_conv{j}_bias"],
            }
            for j in (1, 2)
        }
    return {"params": p}


def port_layout(tree) -> dict[str, np.ndarray]:
    """Flax tree (parameters or gradients) → {state_dict key: f32 array}."""
    p = tree["params"]
    out = {}
    for lin in ("lin0", "lin1"):
        out[f"{lin}.weight"] = np.asarray(p[lin]["kernel"]).T
        out[f"{lin}.bias"] = np.asarray(p[lin]["bias"])
    i = 0
    while f"block_{i}" in p:
        for j in (1, 2):
            c, pre = p[f"block_{i}"][f"GATConv_{j - 1}"], f"blocks.{i}.conv{j}"
            out[f"{pre}.lin.weight"] = np.asarray(c["w"]).T
            for f in ("att_src", "att_dst", "bias"):
                out[f"{pre}.{f}"] = np.asarray(c[f])
        i += 1
    return {k: np.ascontiguousarray(v, np.float32) for k, v in out.items()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "artifacts", "parity_train_bigtown.npz"))
    ap.add_argument("--weights", default=os.path.join(ROOT, "artifacts", "parity_r5_trained.npz"))
    ap.add_argument("--inp", default=os.path.join(ROOT, "inputs", "bigtown.inp"))
    ap.add_argument("--path", choices=("pallas", "xla"), default="pallas")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    sys.path.insert(0, ROOT)
    import optax

    from gnn_pressure_estimation_tpu.data.dataset import build_template, get_keep_list
    from gnn_pressure_estimation_tpu.data.inp import parse_inp
    from gnn_pressure_estimation_tpu.models.gatres import GATRes
    from gnn_pressure_estimation_tpu.train.loop import TrainConfig, Trainer
    from gnn_pressure_estimation_tpu.utils.masking import masked_count
    from gnn_pressure_estimation_tpu.utils.scaling import NormStats

    d = np.load(args.weights)
    wn = parse_inp(args.inp)
    tpl, _ = build_template(wn, get_keep_list(wn, "keep_junction", None, "pressure"), None,
                            name="bigtown")
    n = tpl.n_node
    cfg = TrainConfig(batch_size=1, donate_state=False)          # the defaults otherwise
    stats = NormStats(norm_type="znorm", mean=50.0, std=10.0)
    trainer = Trainer(GATRes(num_blocks=int(d["num_blocks"]), channels=int(d["nc"])),
                      cfg, stats, tpl)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), flax_tree_from_npz(d))
    graph = trainer._batched_graph(tpl, 1)
    if args.path == "xla":
        graph = dataclasses.replace(graph, band_attn=None, band_attn_dma=None,
                                    band_spmm_dma=None)

    k = masked_count(n, cfg.mask_rate)
    mask = np.zeros(n, bool)
    mask[np.random.default_rng(args.seed).permutation(n)[:k]] = True
    x = jnp.asarray(d["x"], jnp.float32)                          # [n, 1]
    xp = graph.pack_nodes(x, n)
    maskp = graph.pack_nodes(jnp.asarray(mask, jnp.float32)[:, None], n)[:, 0] > 0.5

    @jax.jit
    def value_and_grad(p):
        def loss_fn(p_):
            loss, mets, _ = trainer._masked_loss_and_metrics(p_, graph, xp, xp, maskp, k, "train")
            return loss, mets
        return jax.value_and_grad(loss_fn, has_aux=True)(p)

    t0 = time.time()
    (loss, mets), grads = value_and_grad(params)
    loss = float(loss)
    print(f"path {args.path}: loss {loss:.8g} in {time.time() - t0:.1f} s "
          f"(first call, traced and compiled)")
    payload = {
        "path": np.bytes_(args.path.encode()), "mask": mask, "mask_rate": np.float64(cfg.mask_rate),
        "n_masked": np.int64(k), "loss": np.float64(loss),
        "stats_mean": np.float64(stats.mean), "stats_std": np.float64(stats.std),
        "lr": np.float64(cfg.lr), "weight_decay": np.float64(cfg.weight_decay),
    }
    for name, v in mets.items():
        payload[f"metric_{name}"] = np.float64(v)
        print(f"  {name}: {float(v):.6g}")
    g = port_layout(jax.tree.map(np.asarray, grads))
    for name, v in g.items():
        payload[f"grad_{name}"] = v
    print(f"  {len(g)} gradients, {sum(v.size for v in g.values())} values, "
          f"largest |g| {max(float(np.abs(v).max()) for v in g.values()):.4g}")

    p, opt_state, step_losses = params, trainer.tx.init(params), []
    for _ in range(args.steps):
        (l, _), gr = value_and_grad(p)
        updates, opt_state = trainer.tx.update(gr, opt_state, p)
        p = optax.apply_updates(p, updates)
        step_losses.append(float(l))
    (loss_after, _), _ = value_and_grad(p)
    payload["step_losses"] = np.asarray(step_losses, np.float64)
    payload["loss_after"] = np.float64(loss_after)
    for name, v in port_layout(jax.tree.map(np.asarray, p)).items():
        if name.startswith(KEPT_AFTER_3):
            payload[f"p3_{name}"] = v
    print(f"  {args.steps} Adam steps: losses {step_losses}, then {float(loss_after):.8g}")
    np.savez_compressed(args.out, **payload)
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.2f} MB) in {time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
