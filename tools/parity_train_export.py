"""Training parity fixture: one masked train step of the JAX ``Trainer``.

    python tools/parity_train_export.py                      # bigtown, GATRes-large, banded
    python tools/parity_train_export.py --network synthctown # GATRes-small, dense
    python tools/parity_train_export.py --network meganet --blocks 4   # GATRes-large width, banded
        [--out PATH] [--path pallas|xla] [--preset gatres_small|gatres_large] [--seed N]

Runs on the CPU, batch 1, criterion mse, ``NormStats(znorm, mean 50, std 10)``,
one explicit node mask (mask_rate 0.95, drawn with numpy from ``--seed``).

``--network bigtown`` (default; writes ``artifacts/parity_train_bigtown.npz``):
GATRes-large with the weights and the snapshot ``x`` of
``artifacts/parity_r5_trained.npz`` on ``inputs/bigtown.inp`` (banded, BLK 256).

``--network synthctown`` (writes ``artifacts/parity_train_synthctown.npz``):
the preset named by ``--preset`` (default ``gatres_small``, 15 blocks, nc 32,
``attn_impl="factored"``) on ``inputs/synthctown.inp`` (388 nodes, dense
mode). No trained weights of that network are kept in the repository, so the
weights are drawn with numpy from ``--seed`` at glorot scale (biases uniform
in ±0.1) and stored in the file in ``tools/parity_export.py``'s layout
(``w_lin0``, ``blk{i}_conv{j}_lin_w`` …), as is the scaled snapshot ``x``
[n, 1] (standard normal). The file also holds the serving forward of the
masked input: ``x_in``, the output of every block (``ours_act_block_<i>``)
and the model's (``ours_out``).

``--network meganet`` (writes ``artifacts/parity_train_meganet.npz``): the
23,000-junction network of ``simgen.netgen.make_mega`` (made from its seed,
no INP file), banded at BLK 256, where the v2 band attention refuses the
layout and ``template.batch`` falls back to the streaming-softmax kernel
(``make_band_attention_flash``, v4). GATRes at the width of ``gatres_large``
(nc 128, heads 2/1) and ``--blocks N`` blocks (default 4: every gradient of the
full depth of 25 would make the file four times larger), weights and snapshot drawn as
for synthctown. The file holds the weights, ``x``, the serving forward
(``x_in``, ``ours_out``, both [n, 1] in the original node order) and, instead
of the activations, each block's largest magnitude and mean over the real
rows (``block_absmax``, ``block_mean``).

Through the JAX package's own ``Trainer._masked_loss_and_metrics`` and
optimizer it records

* ``mask`` [n] bool (original node order), ``loss``, the seven train
  metrics (``metric_<name>``),
* every parameter's gradient in the PyTorch port's layout and names
  (``grad_<state_dict key>``; kernels transposed as ``weights.py`` does),
* after 3 Adam steps at the ``TrainConfig`` defaults on that same batch and
  mask: the loss at each step (``step_losses``), the loss after the third
  (``loss_after``) and the parameters of ``lin0``, ``lin1`` and the first and
  last block (``p3_<state_dict key>``).

``--path pallas`` (default) runs the Pallas kernels in interpret mode on the
CPU: on bigtown the v2 band attention and the band SpMM as ``template.batch``
attaches them, on meganet the v4 band attention and the band SpMM, on synthctown the fused factored aggregation
(``GNN_TPU_FUSED_FACTORED=1``), forward and backward. ``--path xla`` runs the
plain XLA ops instead. The path taken is stored in the file (``path``) and
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
PRESETS = {"gatres_small": (15, 32), "gatres_large": (25, 128)}   # blocks, channels


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


def drawn_weights(rng, num_blocks: int, nc: int) -> dict:
    """GATRes weights in ``tools/parity_export.py``'s torch layout, drawn at
    glorot scale; biases uniform in ±0.1 (zero biases would give every
    masked node the same logits)."""
    def glorot(shape, fan_in, fan_out):
        b = np.sqrt(6.0 / (fan_in + fan_out))
        return rng.uniform(-b, b, shape).astype(np.float32)

    def bias(k):
        return rng.uniform(-0.1, 0.1, k).astype(np.float32)

    d = {"num_blocks": np.int64(num_blocks), "nc": np.int64(nc),
         "w_lin0": glorot((nc, 1), 1, nc), "b_lin0": bias(nc),
         "w_lin1": glorot((1, nc), nc, 1), "b_lin1": bias(1)}
    for i in range(num_blocks):
        for j, (cin, H, C, width) in ((1, (nc, 2, nc, 2 * nc)), (2, (2 * nc, 1, nc, nc))):
            d[f"blk{i}_conv{j}_lin_w"] = glorot((H * C, cin), cin, H * C)
            d[f"blk{i}_conv{j}_att_src"] = glorot((1, H, C), H, C)
            d[f"blk{i}_conv{j}_att_dst"] = glorot((1, H, C), H, C)
            d[f"blk{i}_conv{j}_bias"] = bias(width)
    return d


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
    ap.add_argument("--network", choices=("bigtown", "synthctown", "meganet"), default="bigtown")
    ap.add_argument("--blocks", type=int, default=4,
                    help="meganet only: depth of the model (the width is gatres_large's)")
    ap.add_argument("--preset", choices=tuple(PRESETS), default=None,
                    help="synthctown only (default gatres_small); bigtown takes the fixture's model")
    ap.add_argument("--out", default=None)
    ap.add_argument("--weights", default=os.path.join(ROOT, "artifacts", "parity_r5_trained.npz"),
                    help="bigtown only: the parity fixture that holds the weights and x")
    ap.add_argument("--inp", default=None)
    ap.add_argument("--path", choices=("pallas", "xla"), default="pallas")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    dense = args.network == "synthctown"
    mega = args.network == "meganet"
    out_path = args.out or os.path.join(ROOT, "artifacts", f"parity_train_{args.network}.npz")
    inp = args.inp or os.path.join(ROOT, "inputs", f"{args.network}.inp")
    if dense and args.path == "pallas":
        os.environ["GNN_TPU_FUSED_FACTORED"] = "1"      # read by GraphTemplate.batch
    else:
        os.environ.pop("GNN_TPU_FUSED_FACTORED", None)
    os.environ.pop("GNN_TPU_FUSED_ATTN", None)

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

    if mega:
        from gnn_pressure_estimation_tpu.simgen.netgen import make_mega

        wn = make_mega()
    else:
        wn = parse_inp(inp)
    tpl, _ = build_template(wn, get_keep_list(wn, "keep_junction", None, "pressure"), None,
                            name=args.network)
    n = tpl.n_node
    if dense or mega:
        rng = np.random.default_rng(args.seed + 1)
        shape = (args.blocks, PRESETS["gatres_large"][1]) if mega \
            else PRESETS[args.preset or "gatres_small"]
        d = drawn_weights(rng, *shape)
        d["x"] = rng.standard_normal((n, 1)).astype(np.float32)
        attn_impl = "factored"                                   # as both GATRes presets ask
    else:
        d = dict(np.load(args.weights))
        attn_impl = "softmax"                                    # banded: the kernels either way
    last = int(d["num_blocks"]) - 1
    kept_after_3 = ("lin0.", "lin1.", "blocks.0.", f"blocks.{last}.")
    cfg = TrainConfig(batch_size=1, donate_state=False)          # the defaults otherwise
    stats = NormStats(norm_type="znorm", mean=50.0, std=10.0)
    model = GATRes(num_blocks=int(d["num_blocks"]), channels=int(d["nc"]), attn_impl=attn_impl)
    trainer = Trainer(model, cfg, stats, tpl)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), flax_tree_from_npz(d))
    graph = trainer._batched_graph(tpl, 1)
    if dense:
        if not graph.dense or (graph.fused_factored is not None) != (args.path == "pallas"):
            raise SystemExit(f"the dense graph does not run the {args.path} path")
    elif args.path == "xla":
        graph = dataclasses.replace(graph, band_attn=None, band_attn_dma=None,
                                    band_spmm_dma=None)
    elif mega:
        from gnn_pressure_estimation_tpu.ops.banded import halo_widths
        from gnn_pressure_estimation_tpu.ops.pallas.band_attention import (
            flash_chunk_widths, make_band_attention_dma)

        bl = tpl.band_layout()
        nB, BLK, W = bl.adj_mask.shape
        U, _ = halo_widths(bl.win_start, bl.W, bl.n_pad)
        if graph.band_attn_dma is None or make_band_attention_dma(nB, BLK, W, U, 0.2) is not None:
            raise SystemExit("meganet did not route to the streaming-softmax band attention")
        print(f"meganet: n {n}, edges {tpl.n_edge}, nB {nB}, BLK {BLK}, W {W}; v2 refuses the "
              f"layout, band attention is make_band_attention_flash (v4), chunk widths "
              f"(fwd, bwd, W_pad) {flash_chunk_widths(W, BLK)}, interpret mode")

    k = masked_count(n, cfg.mask_rate)
    mask = np.zeros(n, bool)
    mask[np.random.default_rng(args.seed).permutation(n)[:k]] = True
    x = jnp.asarray(d["x"], jnp.float32)                          # [n, 1]
    if graph.banded:
        xp = graph.pack_nodes(x, n)
        maskp = graph.pack_nodes(jnp.asarray(mask, jnp.float32)[:, None], n)[:, 0] > 0.5
    else:
        xp, maskp = x, jnp.asarray(mask)

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
    if dense or mega:
        # the weights, the snapshot and the serving forward of the masked input
        payload.update(d)
        x_in = jnp.where(maskp[:, None], 0.0, xp)
        out, state = jax.jit(lambda p: model.apply(
            p, x_in, graph, capture_intermediates=True, mutable=["intermediates"]))(params)
        acts = [state["intermediates"][f"block_{i}"]["__call__"][0] for i in range(last + 1)]
    if dense:
        payload["x_in"] = np.asarray(x_in)
        payload["ours_out"] = np.asarray(out)
        for i, a in enumerate(acts):
            payload[f"ours_act_block_{i}"] = np.asarray(a)
        payload["preset"] = np.bytes_((args.preset or "gatres_small").encode())
    if mega:
        # original node order; per-block statistics stand in for the activations
        payload["x_in"] = np.asarray(graph.unpack_nodes(x_in, n))
        payload["ours_out"] = np.asarray(graph.unpack_nodes(out, n))
        real = [np.asarray(graph.unpack_nodes(a, n)) for a in acts]
        payload["block_absmax"] = np.asarray([np.abs(a).max() for a in real], np.float32)
        payload["block_mean"] = np.asarray([a.mean(dtype=np.float64) for a in real], np.float32)
        print(f"  forward: output in [{float(payload['ours_out'].min()):.5g}, "
              f"{float(payload['ours_out'].max()):.5g}], block |act| max {payload['block_absmax']}")
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
        if name.startswith(kept_after_3):
            payload[f"p3_{name}"] = v
    print(f"  {args.steps} Adam steps: losses {step_losses}, then {float(loss_after):.8g}")
    np.savez_compressed(out_path, **payload)
    print(f"wrote {os.path.relpath(out_path)} ({os.path.getsize(out_path) / 1e6:.2f} MB) "
          f"in {time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
