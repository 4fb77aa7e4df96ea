"""PyTorch port: GATRes forward against the JAX package (CPU; the JAX side's
Pallas band kernels run in interpret mode), with weights carried across by
``weights.py``."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_pressure_estimation_tpu.models.gatres import GATRes as JaxGATRes
from gnn_pressure_estimation_tpu_torch.core.graph import GraphTemplate
from gnn_pressure_estimation_tpu_torch.data.dataset import build_template, get_keep_list
from gnn_pressure_estimation_tpu_torch.data.inp import parse_inp
from gnn_pressure_estimation_tpu_torch.models.gatres import GATRes
from gnn_pressure_estimation_tpu_torch.weights import params_from_flax, params_from_parity_npz
from helpers import random_graph

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def _port_model(num_blocks, nc, attn_impl, state_dict):
    model = GATRes(num_blocks, nc, attn_impl=attn_impl)
    model.load_state_dict(state_dict)
    return model.eval()


@pytest.mark.parametrize("mode,attn_impl", [("banded", "factored"), ("dense", "softmax"),
                                            ("dense", "factored")])
def test_gatres_matches_jax(rng, mode, attn_impl):
    """2 blocks, nc 64: conv1 (H·C 128) takes the v2 Pallas band kernel on
    the JAX side, conv2 (H·C 64) and the mean its XLA band path; the port
    runs its plain band ops on both."""
    jt = random_graph(rng, n=70, extra_edges=40)
    pt = GraphTemplate(jt.n_node, jt.senders, jt.receivers)
    B, n, block = 3, jt.n_node, 16
    jg = jt.batch(B, mode=mode, band_block=block if mode == "banded" else None)
    pg = pt.batch(B, mode=mode, band_block=block if mode == "banded" else None, device="cpu")
    x = rng.standard_normal((B * n, 1)).astype(np.float32)

    jm = JaxGATRes(num_blocks=2, channels=64, attn_impl=attn_impl)
    jx = jg.pack_nodes(jnp.asarray(x), n) if mode == "banded" else jnp.asarray(x)
    params = jm.init(jax.random.PRNGKey(0), jx, jg)
    ref = jm.apply(params, jx, jg)
    ref = np.asarray(jg.unpack_nodes(ref, n) if mode == "banded" else ref)

    model = _port_model(2, 64, attn_impl, params_from_flax(
        jax.tree_util.tree_map(np.asarray, params), GATRes(2, 64)))
    with torch.no_grad():
        tx = torch.from_numpy(x)
        out = model(pg.pack_nodes(tx, n) if mode == "banded" else tx, pg)
        out = (pg.unpack_nodes(out, n) if mode == "banded" else out).numpy()
    assert out.shape == (B * n, 1)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


def test_dense_parity_fixture():
    """``artifacts/parity.npz``: 15 blocks, nc 32, 60 nodes, batch 2; every
    block's activation and the output within 1e-4 of the stored JAX ones."""
    path = ROOT / "artifacts" / "parity.npz"
    d = np.load(path)
    und = d["edge_index_und"].T
    tpl = GraphTemplate(int(d["n"]), np.concatenate([und[:, 0], und[:, 1]]),
                        np.concatenate([und[:, 1], und[:, 0]]))
    model = _port_model(int(d["num_blocks"]), int(d["nc"]), "softmax",
                        params_from_parity_npz(path))
    acts = {}
    for k, blk in enumerate(model.blocks):
        blk.register_forward_hook(lambda m, i, o, k=k: acts.__setitem__(k, o))
    with torch.no_grad():
        out = model(torch.from_numpy(d["x"]), tpl.batch(int(d["batch"]), device="cpu"))
    assert len(acts) == int(d["num_blocks"])
    for k, a in acts.items():
        np.testing.assert_allclose(a.numpy(), d[f"ours_act_block_{k}"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(out.numpy(), d["ours_out"], rtol=0, atol=1e-4)


def test_flax_and_npz_weights_agree(tmp_path, rng):
    """The two converters give one state_dict for one parameter tree (the
    npz written in ``tools/parity_export.py``'s torch layout)."""
    jt = random_graph(rng, n=12, extra_edges=4)
    g = jt.batch(1)
    params = JaxGATRes(num_blocks=2, channels=8).init(
        jax.random.PRNGKey(1), np.zeros((g.n_node, 1), np.float32), g)
    p = jax.tree_util.tree_map(np.asarray, params)["params"]
    payload = {"num_blocks": np.int64(2),
               "w_lin0": p["lin0"]["kernel"].T, "b_lin0": p["lin0"]["bias"],
               "w_lin1": p["lin1"]["kernel"].T, "b_lin1": p["lin1"]["bias"]}
    for i in range(2):
        for j, conv in ((1, "GATConv_0"), (2, "GATConv_1")):
            c = p[f"block_{i}"][conv]
            payload[f"blk{i}_conv{j}_lin_w"] = c["w"].T
            for f in ("att_src", "att_dst", "bias"):
                payload[f"blk{i}_conv{j}_{f}"] = c[f]
    np.savez(tmp_path / "w.npz", **payload)
    model = GATRes(2, 8)
    a, b = params_from_flax(p, model), params_from_parity_npz(tmp_path / "w.npz")
    assert a.keys() == b.keys() == model.state_dict().keys()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_trained_bigtown_fixture_plain_path():
    """``artifacts/parity_r5_trained.npz``: the trained GATRes-large on the
    bigtown band layout through the plain band ops, within 1e-3 of the JAX
    output (the gate of ``tools/parity_export.py``)."""
    path = ROOT / "artifacts" / "parity_r5_trained.npz"
    d = np.load(path)
    wn = parse_inp(str(ROOT / "inputs" / "bigtown.inp"))
    tpl, _ = build_template(wn, get_keep_list(wn, "keep_junction", None, "pressure"), None)
    n = tpl.n_node
    g = tpl.batch(1, device="cpu")
    assert g.banded
    model = _port_model(int(d["num_blocks"]), int(d["nc"]), "softmax",
                        params_from_parity_npz(path))
    with torch.no_grad():
        out = g.unpack_nodes(model(g.pack_nodes(torch.from_numpy(d["x"]), n), g), n)
    np.testing.assert_allclose(out.numpy(), d["ours_out"], rtol=0, atol=1e-3)
