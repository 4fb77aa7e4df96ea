"""PyTorch port: the masked-token GATRes variants against the JAX package.

``GATResRemask`` (the mean-conv blocks, masked nodes starting from their
zeroed value) and ``GATResRemaskStack`` (a plain-sum GCN stem, the batch's
pooled unmasked encoding on every node, blocks without the mean conv) at 2
blocks, nc 8 and at nc 64, in the dense and the banded (BLK 16) modes, with
one explicit batch mask (in banded mode packed as the trainer packs it: the
pad rows count as unmasked in both packages). Forward within
1e-4·max|ref| + 1e-6, the input and parameter gradients of
``sum(out · cot)`` within 1e-4·max|g_ref| + 1e-6.

At nc 64 the JAX package's banded conv1 (H·C 128) takes the v2 Pallas band
attention (interpret mode here). The stack's stem gives the pad rows
nonzero features (the pooled encoding), and there the v2 Pallas backward
parts from the JAX package's own XLA band path, and from both models run in
float64, by 2.4e-4·max|g| on d x, where the XLA path and the port agree
with float64 within 2e-7. So the banded gradients are held against the JAX
model with the graph's Pallas kernels detached (its plain XLA band ops);
the forward is held against both.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_pressure_estimation_tpu.models import remask as jremask
from gnn_pressure_estimation_tpu_torch.core.graph import GraphTemplate
from gnn_pressure_estimation_tpu_torch.models import remask
from gnn_pressure_estimation_tpu_torch.weights import params_from_flax
from helpers import random_graph

torch.set_num_threads(1)
MODELS = {"remask": (jremask.GATResRemask, remask.GATResRemask),
          "stack": (jremask.GATResRemaskStack, remask.GATResRemaskStack)}


def within(name, got, ref, rel=1e-4, floor=1e-6):
    got, ref = np.asarray(got), np.asarray(ref)
    err, top = float(np.abs(got - ref).max()), float(np.abs(ref).max())
    assert got.shape == ref.shape and err <= rel * top + floor, \
        f"{name}: off by {err:.3e} (max |ref| {top:.3e})"


@pytest.mark.parametrize("mode", ["dense", "banded"])
@pytest.mark.parametrize("nc", [8, 64])
@pytest.mark.parametrize("name", list(MODELS))
def test_remask_matches_jax(name, nc, mode):
    rng = np.random.default_rng(4)
    jt = random_graph(rng, n=70, extra_edges=40)
    pt = GraphTemplate(jt.n_node, jt.senders, jt.receivers)
    B, n = 2, jt.n_node
    blk = 16 if mode == "banded" else None
    jg, pg = jt.batch(B, mode=mode, band_block=blk), pt.batch(B, mode=mode, band_block=blk,
                                                              device="cpu")
    x = rng.standard_normal((B * n, 1)).astype(np.float32)
    mask = rng.random(B * n) < 0.5
    x[mask] = 0.0
    jx, jm = jnp.asarray(x), jnp.asarray(mask)
    if mode == "banded":
        if nc == 64:
            assert jg.band_attn_dma is not None
        jx = jg.pack_nodes(jx, n)
        jm = jg.pack_nodes(jm.astype(jnp.float32)[:, None], n)[:, 0] > 0.5
    jcls, pcls = MODELS[name]
    jmodel = jcls(num_blocks=2, channels=nc)
    variables = jmodel.init(jax.random.PRNGKey(2), jx, jg, jm)
    ref_kernels = jax.jit(lambda v, x_: jmodel.apply(v, x_, jg, jm))(variables, jx)
    if mode == "banded":
        jg = dataclasses.replace(jg, band_attn=None, band_attn_dma=None, band_spmm_dma=None)
    ref = jax.jit(lambda v, x_: jmodel.apply(v, x_, jg, jm))(variables, jx)
    cot = rng.standard_normal(ref.shape).astype(np.float32)

    def loss(p, x_):
        return jnp.sum(jmodel.apply({**variables, "params": p}, x_, jg, jm) * cot)

    jgp, jgx = jax.jit(jax.grad(loss, argnums=(0, 1)))(variables["params"], jx)

    model = pcls(num_blocks=2, channels=nc)
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, variables), model))
    if name == "stack":
        assert "mask_token" not in model.state_dict()
        assert torch.equal(model.mask_token, torch.zeros(1, nc))
        np.testing.assert_array_equal(np.asarray(variables["constants"]["mask_token"]),
                                      model.mask_token.numpy())
    tx = torch.tensor(np.asarray(jx), requires_grad=True)
    out = model(tx, pg, torch.from_numpy(np.asarray(jm)))
    within("forward", out.detach().numpy(), ref)
    within("forward against the JAX kernels' path", out.detach().numpy(), ref_kernels)
    (out * torch.from_numpy(cot)).sum().backward()
    within("d x", tx.grad.numpy(), jgx)
    gref = params_from_flax(jax.tree.map(np.asarray, jgp), model)
    for pname, p in model.named_parameters():
        within(f"d {pname}", p.grad.numpy(), gref[pname].numpy())
