"""Parity fixtures of the training knobs: bf16 activations, ``band_factored``
and the multi-epoch block fit, from the JAX package on the CPU.

    python tools/parity_precision_export.py [--only NAME ...] [--seed N]

Writes five files under ``artifacts/``, each beside a ``.log`` of what this
script printed for it:

``parity_train_synthctown_act_bf16.npz``: synthctown (388 nodes, dense
mode), one masked B 1 train step of GATRes with ``dtype=bfloat16`` (the
``--activation_dtype`` of the JAX command), through the JAX layer's XLA
branches (``GNN_TPU_FUSED_*`` unset). Four cases, ``<case>_`` before each key:
``small_factored``, ``small_softmax`` (GATRes-small, 15 blocks, nc 32) and
``large_factored``, ``large_softmax`` (GATRes-large's width, nc 128, cut to
2 blocks so that every gradient fits a small file). Each holds the loss, the
seven metrics, every gradient (``<case>_grad_<state_dict key>``), the serving
forward of the masked input (``<case>_out``) and each block's output
(``<case>_act_block_<i>``), and the f32 model's loss and output on the same
weights (``<case>_f32_loss``, ``<case>_f32_out``). The weights are drawn with
numpy as ``tools/parity_train_export.py`` draws them, stored in its layout
under ``small_`` and ``large_`` (``weights.params_from_parity_npz(path,
prefix=...)`` reads them); ``x`` [n, 1] and ``mask`` [n] are shared.

``parity_train_bigtown_small_act_bf16.npz``: bigtown (banded, BLK 256),
GATRes-small (15 blocks, nc 32) with ``dtype=bfloat16``: its GATConvs
(H·C 64 and 32) are narrower than the JAX layer's Pallas band kernels, so
they run its XLA band ops, as the SimpleMeanConvs do (nc 32). Keys without a
case prefix: the loss, metrics, gradients, the output in the original node
order (``out``), each block's largest magnitude and mean over the real rows
(``block_absmax``, ``block_mean``) and the first two blocks' outputs
(``act_block_0``, ``act_block_1``), and the f32 model's ``f32_loss`` and
``f32_out``.

``parity_train_bigtown_small_band_factored.npz``: the same network, weights
and mask, GATRes-small with ``attn_impl="band_factored"`` (the factored band
attention, ``ops/banded.py``, plain XLA) in f32 (``f32_`` keys) and under
``attn_dtype=bfloat16`` (``bf16_`` keys): loss, metrics, gradients, output,
block statistics; and the softmax model's loss and output (``softmax_loss``,
``softmax_out``), which the factored one equals up to rounding.

``parity_fit_fast_synthctown.npz``: ``Trainer.fit`` with
``epochs_per_dispatch=2`` (the JAX ``_fit_fast``) of GATRes-small on
synthctown for 4 epochs, batch 4, on 10 training snapshots (a tail batch of
2) and 6 validation ones (a tail of 2), drawn standard normal with numpy;
criterion mse, mask rate 0.95, ``seed`` 0 in the ``TrainConfig``. It holds
the snapshots (``train``, ``val``), the initial weights, every mask the run
drew (``masks_train`` [epochs, steps, bs·n] and ``masks_val``, derived from
``fold_in(PRNGKey(seed), epoch)`` as ``_get_epoch_block`` derives them, the
padded graphs' rows zeroed), each epoch's train and validation loss and
metrics (``train_loss``, ``val_loss``, ``val_metric_<name>``), the best
epoch, and the final parameters (``final_<state_dict key>``).

``parity_dist_bigtown_small_act_bf16.npz``: one step of the JAX
``DistributedTrainer`` (the edge partition, ``parallel/distributed.py``) on
a 1×2 mesh (dp 1, gp 2: two host devices, ``XLA_FLAGS`` gets
``--xla_force_host_platform_device_count=2``), B 1, on bigtown with
GATRes-small (15 blocks, nc 32) under ``dtype=bfloat16``: every GATConv
takes the JAX layer's edge-list branch. The weights, ``x`` [1, n] and the
mask [n] (drawn by the step's own ``batch_node_mask`` from
``PRNGKey(seed)``, mask rate 0.95), stats znorm 50 / 10, criterion mse.
Keys: the loss and the train metrics (``metric_<name>``), every gradient
summed over the mesh (``grad_<state_dict key>``, handed back by
``make_distributed_train_step`` itself through an optimizer whose state
is the gradient it was given), the forward's output (``out``) and each
block's output statistics over the real nodes (``block_absmax``,
``block_mean``) and the first two blocks' outputs (``act_block_0``,
``act_block_1``), in the template's node order; and the f32 model's
``f32_loss``.

All on the CPU with ``jax_default_matmul_precision="highest"``; the weights
and snapshots are made from ``--seed`` (default 0).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from parity_train_export import drawn_weights, flax_tree_from_npz, port_layout  # noqa: E402

NAMES = ("train_synthctown_act_bf16", "train_bigtown_small_act_bf16",
         "train_bigtown_small_band_factored", "fit_fast_synthctown",
         "dist_bigtown_small_act_bf16")


class Log:
    """Print and keep the lines, for the ``.log`` beside a fixture."""

    def __init__(self):
        self.lines = []

    def __call__(self, msg: str):
        print(msg, flush=True)
        self.lines.append(msg)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", choices=NAMES, default=list(NAMES))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    for var in ("GNN_TPU_FUSED_FACTORED", "GNN_TPU_FUSED_ATTN", "GNN_TPU_BAND_FLASH",
                "GNN_TPU_BAND_ACC", "GNN_TPU_BAND_DMA", "GNN_TPU_BAND_ATTN"):
        os.environ.pop(var, None)

    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=2"
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    sys.path.insert(0, ROOT)
    from gnn_pressure_estimation_tpu.data.dataset import WDNDataset, _Member
    from gnn_pressure_estimation_tpu.data.dataset import build_template, get_keep_list
    from gnn_pressure_estimation_tpu.data.inp import parse_inp
    from gnn_pressure_estimation_tpu.models.gatres import GATRes
    from gnn_pressure_estimation_tpu.train.loop import TrainConfig, Trainer
    from gnn_pressure_estimation_tpu.utils.masking import batch_node_mask, masked_count
    from gnn_pressure_estimation_tpu.utils.scaling import NormStats

    stats = NormStats(norm_type="znorm", mean=50.0, std=10.0)

    def template(network):
        wn = parse_inp(os.path.join(ROOT, "inputs", f"{network}.inp"))
        tpl, _ = build_template(wn, get_keep_list(wn, "keep_junction", None, "pressure"), None,
                                name=network)
        return tpl

    def prefixed(d, prefix):
        return {prefix + k: v for k, v in d.items()}

    def b1_step(log, tpl, d, x, mask, **knobs):
        """One B 1 masked step of GATRes on the drawn weights ``d``: loss,
        metrics, gradients (port layout), the forward's output and each
        block's output, in the original node order."""
        cfg = TrainConfig(batch_size=1, donate_state=False)
        model = GATRes(num_blocks=int(d["num_blocks"]), channels=int(d["nc"]), **knobs)
        trainer = Trainer(model, cfg, stats, tpl)
        graph = trainer._batched_graph(tpl, 1)
        n = tpl.n_node
        k = masked_count(n, cfg.mask_rate)
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), flax_tree_from_npz(d))
        xj = jnp.asarray(x)
        if graph.banded:
            xp = graph.pack_nodes(xj, n)
            maskp = graph.pack_nodes(jnp.asarray(mask, jnp.float32)[:, None], n)[:, 0] > 0.5
        else:
            xp, maskp = xj, jnp.asarray(mask)

        @jax.jit
        def value_and_grad(p):
            def loss_fn(p_):
                loss, mets, _ = trainer._masked_loss_and_metrics(p_, graph, xp, xp, maskp, k,
                                                                 "train")
                return loss, mets
            return jax.value_and_grad(loss_fn, has_aux=True)(p)

        t0 = time.time()
        (loss, mets), grads = value_and_grad(params)
        x_in = jnp.where(maskp[:, None], 0.0, xp)
        out, state = jax.jit(lambda p: model.apply(
            p, x_in, graph, capture_intermediates=True, mutable=["intermediates"]))(params)
        unpack = (lambda a: np.asarray(graph.unpack_nodes(a, n))) if graph.banded \
            else np.asarray
        acts = [unpack(state["intermediates"][f"block_{i}"]["__call__"][0])
                for i in range(int(d["num_blocks"]))]
        rec = {"loss": np.float64(loss), "out": unpack(out),
               "block_absmax": np.asarray([np.abs(a).max() for a in acts], np.float32),
               "block_mean": np.asarray([a.mean(dtype=np.float64) for a in acts], np.float32)}
        rec.update({f"metric_{mk}": np.float64(mv) for mk, mv in mets.items()})
        rec.update({f"grad_{k_}": v for k_, v in port_layout(jax.tree.map(np.asarray,
                                                                            grads)).items()})
        log(f"  {knobs}: loss {float(loss):.8g}, output in [{rec['out'].min():.5g}, "
            f"{rec['out'].max():.5g}], block |act| max {np.round(rec['block_absmax'], 4)} "
            f"({time.time() - t0:.1f} s)")
        return rec, acts

    def write(name, log, payload):
        path = os.path.join(ROOT, "artifacts", f"parity_{name}.npz")
        np.savez_compressed(path, **payload)
        log(f"wrote {os.path.relpath(path, ROOT)} ({os.path.getsize(path) / 1e6:.2f} MB)")
        with open(path[:-4] + ".log", "w") as f:
            f.write("\n".join(log.lines) + "\n")

    def drawn_x_mask(rng_seed, n, mask_rate=0.95):
        k = masked_count(n, mask_rate)
        mask = np.zeros(n, bool)
        mask[np.random.default_rng(rng_seed).permutation(n)[:k]] = True
        return mask

    for name in args.only:
        log = Log()
        log(f"parity_{name} (seed {args.seed}; jax {jax.__version__}, CPU, matmul precision "
            "highest, XLA branches)")
        if name == "train_synthctown_act_bf16":
            tpl = template("synthctown")
            n = tpl.n_node
            payload, x = {}, None
            for size, shape in (("small", (15, 32)), ("large", (2, 128))):
                rng = np.random.default_rng(args.seed + (1 if size == "small" else 2))
                d = drawn_weights(rng, *shape)
                if x is None:
                    x = rng.standard_normal((n, 1)).astype(np.float32)
                    mask = drawn_x_mask(args.seed, n)
                    payload.update(x=x, mask=mask)
                payload.update(prefixed(d, f"{size}_"))
                for impl in ("factored", "softmax"):
                    case = f"{size}_{impl}_"
                    rec, acts = b1_step(log, tpl, d, x, mask, attn_impl=impl,
                                        dtype=jnp.bfloat16)
                    f32, _ = b1_step(log, tpl, d, x, mask, attn_impl=impl)
                    payload.update(prefixed(rec, case))
                    payload.update({f"{case}act_block_{i}": a for i, a in enumerate(acts)})
                    payload[f"{case}f32_loss"], payload[f"{case}f32_out"] = f32["loss"], f32["out"]
                    log(f"  {case[:-1]}: |bf16 − f32| output {np.abs(rec['out'] - f32['out']).max():.4g}")
            write(name, log, payload)
        elif name in ("train_bigtown_small_act_bf16", "train_bigtown_small_band_factored"):
            tpl = template("bigtown")
            n = tpl.n_node
            rng = np.random.default_rng(args.seed + 1)
            d = drawn_weights(rng, 15, 32)
            x = rng.standard_normal((n, 1)).astype(np.float32)
            mask = drawn_x_mask(args.seed, n)
            payload = {**d, "x": x, "mask": mask}
            bl = tpl.band_layout()
            log(f"  bigtown: n {n}, nB·BLK·W {bl.adj_mask.shape}; GATRes-small's GATConvs (H·C 64, "
                "32) and means (C 32) take the JAX package's XLA band ops")
            if name == "train_bigtown_small_act_bf16":
                rec, acts = b1_step(log, tpl, d, x, mask, attn_impl="factored",
                                    dtype=jnp.bfloat16)
                f32, _ = b1_step(log, tpl, d, x, mask, attn_impl="factored")
                payload.update(rec)
                payload.update(act_block_0=acts[0], act_block_1=acts[1], f32_loss=f32["loss"],
                               f32_out=f32["out"])
            else:
                for tag, knobs in (("f32", {}), ("bf16", {"attn_dtype": jnp.bfloat16})):
                    rec, _ = b1_step(log, tpl, d, x, mask, attn_impl="band_factored", **knobs)
                    payload.update(prefixed(rec, f"{tag}_"))
                soft, _ = b1_step(log, tpl, d, x, mask, attn_impl="softmax")
                payload.update(softmax_loss=soft["loss"], softmax_out=soft["out"])
                log(f"  |band_factored − softmax| output, f32: "
                    f"{np.abs(payload['f32_out'] - soft['out']).max():.4g}")
            write(name, log, payload)
        elif name == "dist_bigtown_small_act_bf16":
            write(name, log, distributed_step(log, template("bigtown"), args.seed, stats))
        else:
            tpl = template("synthctown")
            n = tpl.n_node
            rng = np.random.default_rng(args.seed + 1)
            d = drawn_weights(rng, 15, 32)
            train, val = (rng.standard_normal((S, n)).astype(np.float32) for S in (10, 6))
            bs, epochs, E, seed = 4, 4, 2, 0
            cfg = TrainConfig(epochs=epochs, batch_size=bs, mask_rate=0.95, criterion="mse",
                              donate_state=False, seed=seed, epochs_per_dispatch=E)

            def dataset(a):
                ds = object.__new__(WDNDataset)
                ds.feature, ds.from_set, ds.norm_type, ds.edge_attrs = ("pressure", "train",
                                                                        "znorm", None)
                ds.stats = stats
                ds.members = [_Member(tpl, a, [], None)]
                ds._lengths = [len(a)]
                ds.length = len(a)
                return ds

            trainer = Trainer(GATRes(num_blocks=15, channels=32, attn_impl="factored"), cfg,
                              stats, tpl)
            trainer.params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                                          flax_tree_from_npz(d))
            trainer.opt_state = trainer.tx.init(trainer.params)
            hist = []
            t0 = time.time()
            best = trainer.fit(dataset(train), dataset(val), log_fn=log,
                               on_epoch_end=lambda ep, m: hist.append((ep, m)))
            log(f"  fit: {epochs} epochs at epochs_per_dispatch {E}, best epoch {best['epoch']} "
                f"({time.time() - t0:.1f} s)")
            # the masks _get_epoch_block drew: fold_in(PRNGKey(seed), epoch), split
            # into train and validation keys, one key a step
            masks = {"train": [], "val": []}
            for ep in range(1, epochs + 1):
                ktr, kval = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), ep))
                for split, key, S in (("train", ktr, len(train)), ("val", kval, len(val))):
                    steps, valid = Trainer._block_layout(S, bs)
                    keys = jax.random.split(key, steps)
                    masks[split].append(np.stack([
                        np.asarray(batch_node_mask(keys[s], bs, n, cfg.mask_rate))
                        & np.repeat(valid[s] > 0.5, n) for s in range(steps)]))
            payload = {**d, "train": train, "val": val, "batch_size": np.int64(bs),
                       "epochs": np.int64(epochs), "epochs_per_dispatch": np.int64(E),
                       "seed": np.int64(seed), "mask_rate": np.float64(cfg.mask_rate),
                       "masks_train": np.stack(masks["train"]),
                       "masks_val": np.stack(masks["val"]),
                       "train_loss": np.asarray([m["train_loss"] for _, m in hist]),
                       "val_loss": np.asarray([m["val_loss"] for _, m in hist]),
                       "best_epoch": np.int64(best["epoch"])}
            for mk in hist[0][1]:
                if mk.startswith("val_") and mk != "val_loss":
                    payload[f"val_metric_{mk}"] = np.asarray([m[mk] for _, m in hist])
            for k_, v in port_layout(jax.tree.map(np.asarray, trainer.params)).items():
                payload[f"final_{k_}"] = v
            log(f"  train loss {np.round(payload['train_loss'], 6)}, val loss "
                f"{np.round(payload['val_loss'], 6)}")
            write(name, log, payload)
    return 0


def distributed_step(log, tpl, seed: int, stats) -> dict:
    """One B 1 step of the JAX ``DistributedTrainer`` at dp 1 / gp 2 with
    GATRes-small under ``dtype=bfloat16`` (and the f32 model's loss): the
    payload of ``parity_dist_bigtown_small_act_bf16.npz``."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from gnn_pressure_estimation_tpu.models.gatres import GATRes
    from gnn_pressure_estimation_tpu.parallel import make_mesh
    from gnn_pressure_estimation_tpu.parallel.distributed import (
        DistributedTrainer, _dist_criterion, make_distributed_train_step,
    )
    from gnn_pressure_estimation_tpu.train.loop import TrainConfig
    from gnn_pressure_estimation_tpu.utils.masking import batch_node_mask

    n, nb = tpl.n_node, 15
    rng = np.random.default_rng(seed + 1)
    d = drawn_weights(rng, nb, 32)
    x = rng.standard_normal((1, n)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    cfg = TrainConfig(batch_size=1, mask_rate=0.95, criterion="mse", seed=seed,
                      donate_state=False)
    mask = np.asarray(batch_node_mask(key, 1, n, cfg.mask_rate)).reshape(n)
    mesh = make_mesh(dp=1, gp=2)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), flax_tree_from_npz(d))
    # an optimizer whose state after a step is the gradient it was given
    grads_tx = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    payload = {**d, "x": x, "mask": mask}
    for tag, dt in (("", jnp.bfloat16), ("f32_", None)):
        model = GATRes(num_blocks=nb, channels=32, dtype=dt)
        dtr = DistributedTrainer(model, cfg, stats, tpl, mesh)
        step, pack, part = make_distributed_train_step(
            model, grads_tx, mesh, tpl, dtr.batch_per_shard, cfg.mask_rate, stats,
            _dist_criterion(cfg.criterion))
        t0 = time.time()
        _, grads, loss, mets = step(params, grads_tx.init(params), pack(x), key)
        log(f"  DistributedTrainer 1×2 B 1, dtype {dt}: loss {float(loss):.8g} "
            f"({time.time() - t0:.1f} s, partition block {part.block})")
        if tag:
            payload[f"{tag}loss"] = np.float64(loss)
            continue
        payload["loss"] = np.float64(loss)
        payload.update({f"metric_{k}": np.float64(v) for k, v in mets.items()})
        payload.update({f"grad_{k}": v for k, v in
                        port_layout(jax.tree.map(np.asarray, grads)).items()})
        garr = part.device_arrays()
        xspec = P(("data", "graph"))

        def local_forward(p, xl, ml, arrs, model=model, part=part):
            out, st = model.apply(p, jnp.where(ml[:, None], 0.0, xl), part.local_graph(arrs),
                                  capture_intermediates=True, mutable=["intermediates"])
            return out, [st["intermediates"][f"block_{i}"]["__call__"][0] for i in range(nb)]

        fwd = jax.jit(shard_map(local_forward, mesh=mesh,
                                in_specs=(P(), xspec, xspec, {k: P("graph") for k in garr}),
                                out_specs=(xspec, [xspec] * nb), check_vma=False))
        mk = np.zeros(2 * part.block, bool)
        mk[:n] = mask
        out, acts = fwd(params, pack(x), jnp.asarray(mk), garr)
        acts = [np.asarray(a)[:n] for a in acts]
        payload.update(out=np.asarray(out)[:n], act_block_0=acts[0], act_block_1=acts[1],
                       block_absmax=np.asarray([np.abs(a).max() for a in acts], np.float32),
                       block_mean=np.asarray([a.mean(dtype=np.float64) for a in acts],
                                             np.float32))
        log(f"  block |act| max {np.round(payload['block_absmax'], 4)}")
    return payload


if __name__ == "__main__":
    sys.exit(main())
