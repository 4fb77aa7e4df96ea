"""Where GATRes's bf16 attention operands round differently in the two packages.

    python tools/bf16_flips.py > artifacts/bf16_flips_bigtown.log
    python tools/bf16_flips.py --network synthctown > artifacts/bf16_flips_synthctown_softmax.log

Runs on the CPU. ``bigtown`` (default): the trained GATRes-large of
``artifacts/parity_r5_trained.npz`` on ``inputs/bigtown.inp`` (banded, BLK 256)
with ``attn_dtype=bfloat16``, batch 1, on the masked input of
``artifacts/parity_train_bigtown_bf16.npz``: the JAX package's forward (its v2
Pallas kernel with ``mxu_bf16``, interpret mode), and the PyTorch port's (its
plain versions), block by block. ``synthctown``: GATRes-small with
``attn_impl="softmax"`` and the seeded weights of
``artifacts/parity_train_synthctown_softmax_bf16.npz`` on
``inputs/synthctown.inp`` (dense), the JAX layer's XLA branch against the
port's plain versions; that branch also rounds each conv's output to bf16,
so the output elements a bf16 step apart are counted too.

The bf16 instances round x and the attention weight p to bf16. Where the two
packages' f32 values of one operand differ by an ulp (their projections and
logit halves sum in other orders), the operand can land on either side of a
bf16 rounding boundary: a flip, which moves every product that reads it by up
to 2^-8 of its size. For every block the script feeds the port the JAX
block's own input (so nothing upstream differs) and prints

* the block's output against JAX's, and each GATConv's;
* the flips of each GATConv: the set mask entries whose bf16 weight differs
  when the weights are formed from the JAX and from the port projections
  (both with the port's formula, so the count is the inputs' doing); those
  whose bf16 weight differs when the JAX projection's logits go through the
  JAX kernel's formula, exp(z - m) / Z with Z an f32 sum in XLA's order and
  XLA's exp, and through the port's, Z summed in double (the formula's
  doing); and the projected x elements whose bf16 rounding differs;

then the free-running forward's block deviations, where a flip in one block
reaches every block after it.
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def main() -> int:
    import argparse

    import jax
    import jax.numpy as jnp
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--network", choices=("bigtown", "synthctown"), default="bigtown")
    dense = ap.parse_args().network == "synthctown"
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from parity_train_export import flax_tree_from_npz

    from gnn_pressure_estimation_tpu.data.dataset import build_template as jax_build_template
    from gnn_pressure_estimation_tpu.data.dataset import get_keep_list as jax_keep_list
    from gnn_pressure_estimation_tpu.data.inp import parse_inp as jax_parse_inp
    from gnn_pressure_estimation_tpu.models.gatres import GATRes as JaxGATRes
    from gnn_pressure_estimation_tpu_torch.data.dataset import build_template, get_keep_list
    from gnn_pressure_estimation_tpu_torch.data.inp import parse_inp
    from gnn_pressure_estimation_tpu_torch.models.gatres import GATRes
    from gnn_pressure_estimation_tpu_torch.ops import band_attention as ba
    from gnn_pressure_estimation_tpu_torch.ops import banded as bops
    from gnn_pressure_estimation_tpu_torch.ops import graph_attention as ga
    from gnn_pressure_estimation_tpu_torch.weights import params_from_parity_npz

    torch.set_num_threads(8)
    network = "synthctown" if dense else "bigtown"
    inp = os.path.join(ROOT, "inputs", f"{network}.inp")
    if dense:
        npz = os.path.join(ROOT, "artifacts", "parity_train_synthctown_softmax_bf16.npz")
        fx = d = dict(np.load(npz))
    else:
        npz = os.path.join(ROOT, "artifacts", "parity_r5_trained.npz")
        fx = np.load(os.path.join(ROOT, "artifacts", "parity_train_bigtown_bf16.npz"))
        d = dict(np.load(npz))
    depth, nc = int(d["num_blocks"]), int(d["nc"])
    attn_impl = "softmax"

    jwn = jax_parse_inp(inp)
    jt, _ = jax_build_template(jwn, jax_keep_list(jwn, "keep_junction", None, "pressure"), None)
    wn = parse_inp(inp)
    pt, _ = build_template(wn, get_keep_list(wn, "keep_junction", None, "pressure"), None)
    n = pt.n_node
    if dense:
        os.environ.pop("GNN_TPU_FUSED_ATTN", None)          # the JAX layer's XLA branch
        jg = jt.batch(1, mode="dense")
        pg = pt.batch(1, "dense", None, "cpu")
        pack = lambda a: a                                  # noqa: E731
    else:
        jg = jt.batch(1, mode="banded", band_block=256)
        pg = pt.batch(1, "banded", 256, "cpu", band_attn="dma")
        pack = lambda a: jg.pack_nodes(a, n)                # noqa: E731
        order = np.arange(n, dtype=np.float32)[:, None]
        if not np.array_equal(np.asarray(pack(jnp.asarray(order))),
                              pg.pack_nodes(torch.from_numpy(order), n).numpy()):
            raise SystemExit("the two packages pack bigtown's nodes differently")

    jmodel = JaxGATRes(num_blocks=depth, channels=nc, attn_impl=attn_impl, attn_dtype=jnp.bfloat16)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), flax_tree_from_npz(d))
    jx = pack(jnp.asarray(fx["x_in"], jnp.float32))
    _, state = jax.jit(lambda p: jmodel.apply(p, jx, jg, capture_intermediates=True,
                                              mutable=["intermediates"]))(params)
    inter = jax.tree.map(np.array, state["intermediates"])          # writable copies
    model = GATRes(depth, nc, attn_impl=attn_impl, attn_dtype=torch.bfloat16)
    model.load_state_dict(params_from_parity_npz(npz))

    def bf16(t):
        return t.to(torch.bfloat16).to(torch.float32)

    if dense:
        mask = torch.as_tensor(pt.dense_operators()["adj_sl_mask"])
        nnz = int(mask.sum())

        def softmax_of(a_s, a_d):
            """(the port's weights e / Z, Z in double; the mask) [1, i, j, H]."""
            _, p = ga._softmax_p(a_d, a_s, mask, 0.2, bf16=True)
            return p, mask[None, :, :, None].expand_as(p)

        def jax_softmax(a_s, a_d):
            z = jnp.array(a_d.numpy())[:, :, None, :] + jnp.array(a_s.numpy())[:, None, :, :]
            z = jnp.where(jnp.array(mask.numpy())[None, :, :, None], jnp.where(z >= 0, z, 0.2 * z),
                          -1e9)
            return torch.from_numpy(np.array(jax.nn.softmax(z, axis=2)))
    else:
        bl = pt.band_layout()
        mask = torch.as_tensor(bl.adj_mask)
        nnz = int(bl.adj_mask.sum())

        def softmax_of(a_s, a_d):
            z, _, on = ba._logits(a_d, bops.band_windows(a_s, bl.win_start, bl.W), mask, 0.2)
            e, Z, _ = ba._bf16_weights(z, on)
            return e / Z, on.expand_as(z)

        def jax_softmax(a_s, a_d):
            z, _, _ = ba._logits(a_d, bops.band_windows(a_s, bl.win_start, bl.W), mask, 0.2)
            zj = jnp.array(z.numpy())
            ej = jnp.exp(zj - jnp.max(zj, axis=3, keepdims=True))
            return torch.from_numpy(np.array(ej / jnp.sum(ej, axis=3, keepdims=True)))

    def weights(x, conv, heads, C):
        """bf16 x and bf16 weights of a GATConv's input ``x`` (torch), by the
        port's formula, and where the mask is set."""
        xp = conv.lin(x).view(-1, heads, C)
        a_s = (xp * conv.att_src).sum(-1).view(1, -1, heads)
        a_d = (xp * conv.att_dst).sum(-1).view(1, -1, heads)
        p, on = softmax_of(a_s, a_d)
        return bf16(xp), bf16(p), on

    def jax_weights(x, p, heads, C):
        """The same from the JAX package's projection and logit halves, and
        the JAX formula's weights from them (Z an f32 sum in XLA's order, XLA's
        exp)."""
        xp = (jnp.array(x) @ p["w"]).reshape(-1, heads, C)
        a_s = jnp.sum(xp * p["att_src"], axis=-1)
        a_d = jnp.sum(xp * p["att_dst"], axis=-1)
        a_s, a_d = (torch.from_numpy(np.array(a)).view(1, -1, heads) for a in (a_s, a_d))
        return bf16(torch.from_numpy(np.array(xp))), bf16(softmax_of(a_s, a_d)[0]), \
            bf16(jax_softmax(a_s, a_d))

    real = (torch.ones(n, dtype=torch.bool) if dense else
            torch.from_numpy(np.asarray(jg.pack_nodes(jnp.ones((n, 1)), n))[:, 0] > 0.5))
    print(f"{network}, GATRes-{'small' if dense else 'large'} ({depth} blocks, nc {nc}), "
          + ("attn_impl softmax, " if dense else "") + f"attn_dtype bfloat16, B 1, CPU; mask "
          f"nonzeros {nnz}, {int(real.sum())} real of {real.numel()} rows")
    print("block: teacher-forced output deviation (conv1, conv2, block) | weights flipped by the "
          "inputs, by the formula, x elements flipped" + (", conv output elements a bf16 step "
                                                          "apart" if dense else "")
          + " (conv1; conv2)")
    total_p = total_f = total_x = total_o = 0
    x_blk = inter["lin0"]["__call__"][0]
    for k, blk in enumerate(model.blocks):
        jb = inter[f"block_{k}"]
        j1, j2 = jb["GATConv_0"]["__call__"][0], jb["GATConv_1"]["__call__"][0]
        p1 = params["params"][f"block_{k}"]
        with torch.no_grad():
            xin = torch.from_numpy(x_blk)
            o1 = blk.conv1(xin, pg)
            dev1 = float((o1 - torch.from_numpy(j1)).abs()[real].max())
            x2 = torch.relu(torch.from_numpy(j1))
            o2 = blk.conv2(x2, pg)
            dev2 = float((o2 - torch.from_numpy(j2)).abs()[real].max())
            devb = float((blk(xin, pg) - torch.from_numpy(jb["__call__"][0])).abs()[real].max())
            flips = []
            for conv, x_in, name, heads, o, jo in ((blk.conv1, xin, "GATConv_0", 2, o1, j1),
                                                   (blk.conv2, x2, "GATConv_1", 1, o2, j2)):
                xq, pq, on = weights(x_in, conv, heads, nc)
                jxq, jpq, jkq = jax_weights(x_in.numpy(), p1[name], heads, nc)
                fp = int(((pq != jpq) & on).sum())
                ff = int(((jpq != jkq) & on).sum())
                fxe = int((xq != jxq)[real].sum())
                # the conv's output less its bias: the rounded product where the JAX layer
                # rounds it (dense); elements that differ are a rounding apart at least
                fo = int((o - conv.bias != torch.from_numpy(jo) - conv.bias)[real].sum()) if dense else 0
                flips.append(f"{fp}, {ff}, {fxe}" + (f", {fo}" if dense else ""))
                total_p, total_f, total_x, total_o = (total_p + fp, total_f + ff, total_x + fxe,
                                                      total_o + fo)
        print(f"  block {k:2d}: {dev1:.3e} {dev2:.3e} {devb:.3e} | {'; '.join(flips)}")
        x_blk = jb["__call__"][0]
    print(f"flips over the {depth} blocks: {total_p} weights by the inputs and {total_f} by the "
          f"formula of {depth * 3 * nnz} (2 + 1 heads a block), {total_x} x "
          f"elements of {depth * 3 * nc * n}"
          + (f", {total_o} conv output elements of {depth * 3 * nc * n}" if dense else ""))

    acts = {}
    hooks = [b.register_forward_hook(lambda m, i, o, k=k: acts.__setitem__(k, o))
             for k, b in enumerate(model.blocks)]
    with torch.no_grad():
        x0 = torch.as_tensor(fx["x_in"])
        model(x0 if dense else pg.pack_nodes(x0, n), pg)
    for h in hooks:
        h.remove()
    devs = [float((acts[k] - torch.from_numpy(inter[f"block_{k}"]["__call__"][0])).abs()[real].max())
            for k in range(depth)]
    print("free-running forward, each block against JAX's: "
          + ", ".join(f"{k}: {v:.2e}" for k, v in enumerate(devs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
