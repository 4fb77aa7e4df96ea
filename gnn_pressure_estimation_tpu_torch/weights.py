"""Carry GATRes weights across from the JAX package.

``params_from_flax`` maps a JAX/Flax GATRes parameter tree, given as nested
dicts of arrays (``params["params"]["block_i"]["GATConv_0"]["w"]`` …), onto
the port's ``state_dict``. ``params_from_parity_npz`` does the same for the
torch-layout parity fixtures that ``tools/parity_export.py`` writes
(``w_lin0``, ``blk{i}_conv{j}_lin_w`` …). Neither needs JAX: the arrays are
read through numpy.

Layout (Flax → port):
  lin0/kernel [in, nc]             → lin0.weight [nc, in] (transposed), lin0.bias
  block_i/GATConv_0/w [in, H·C]    → blocks.i.conv1.lin.weight [H·C, in]
  block_i/GATConv_0/att_src|att_dst [1, H, C] → blocks.i.conv1.att_src|att_dst
  block_i/GATConv_0/bias           → blocks.i.conv1.bias
  (GATConv_1 ↔ conv2; SimpleMeanConv has no parameters)
  lin1/kernel [nc, 1]              → lin1.weight [1, nc], lin1.bias
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def params_from_flax(tree) -> dict[str, torch.Tensor]:
    p = tree["params"] if "params" in tree else tree
    sd = {}
    for lin in ("lin0", "lin1"):
        sd[f"{lin}.weight"] = _t(np.asarray(p[lin]["kernel"]).T)
        sd[f"{lin}.bias"] = _t(p[lin]["bias"])
    i = 0
    while f"block_{i}" in p:
        blk = p[f"block_{i}"]
        for j, conv in enumerate(("GATConv_0", "GATConv_1"), start=1):
            c, pre = blk[conv], f"blocks.{i}.conv{j}"
            sd[f"{pre}.lin.weight"] = _t(np.asarray(c["w"]).T)
            sd[f"{pre}.att_src"] = _t(c["att_src"])
            sd[f"{pre}.att_dst"] = _t(c["att_dst"])
            sd[f"{pre}.bias"] = _t(c["bias"])
        i += 1
    return sd


def params_from_parity_npz(path) -> dict[str, torch.Tensor]:
    with np.load(path) as d:
        sd = {
            "lin0.weight": _t(d["w_lin0"]), "lin0.bias": _t(d["b_lin0"]),
            "lin1.weight": _t(d["w_lin1"]), "lin1.bias": _t(d["b_lin1"]),
        }
        for i in range(int(d["num_blocks"])):
            for j in (1, 2):
                src, pre = f"blk{i}_conv{j}", f"blocks.{i}.conv{j}"
                sd[f"{pre}.lin.weight"] = _t(d[f"{src}_lin_w"])
                sd[f"{pre}.att_src"] = _t(d[f"{src}_att_src"])
                sd[f"{pre}.att_dst"] = _t(d[f"{src}_att_dst"])
                sd[f"{pre}.bias"] = _t(d[f"{src}_bias"])
    return sd
