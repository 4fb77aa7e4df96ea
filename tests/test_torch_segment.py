"""PyTorch port: ``ops/segment.py`` and the edge-list (segment) path of the
layers against the JAX package on the CPU.

- The ops (``segment_sum``, ``segment_mean``, ``segment_max``,
  ``segment_softmax`` with and without an edge mask, ``spmm`` with scalar and
  per-head edge weights and an edge mask, ``sddmm_dot``, the two gathers),
  forward and vector-Jacobian products, against the JAX ops on the same
  receiver-sorted edge lists, which the port's batched graph must give
  equal to the JAX batch's (with self-loops too, and the GCN and Chebyshev
  edge weights).
- GATRes, GIN, GCN2 and ChebNet on ``tests/test_layers.py``'s stripped graph
  (a padded-mode batch with its padded tables taken out, so every layer takes
  the edge-list path), forward and every parameter gradient, against the
  JAX models on the JAX stripped graph.
- ``spmm`` in edge-partitioned mode (``axis``: the senders global ids into
  the graph group's all-gathered blocks, padding edges masked), forward and
  gradient, on 2 gloo ranks started through ``parallel.launch``, against the
  JAX ``spmm`` on the whole batch.

Tolerances are the JAX package's for these ops: rtol 2e-4, atol 2e-5.
"""

import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_pressure_estimation_tpu import ops as jops
from gnn_pressure_estimation_tpu.models.gatres import GATRes as JaxGATRes
from gnn_pressure_estimation_tpu.models.zoo import GCN2 as JaxGCN2
from gnn_pressure_estimation_tpu.models.zoo import GIN as JaxGIN
from gnn_pressure_estimation_tpu.models.zoo import ChebNet as JaxChebNet
from gnn_pressure_estimation_tpu_torch.core.graph import GraphTemplate
from gnn_pressure_estimation_tpu_torch.models.gatres import GATRes
from gnn_pressure_estimation_tpu_torch.models.zoo import GCN2, GIN, ChebNet
from gnn_pressure_estimation_tpu_torch.ops import segment
from gnn_pressure_estimation_tpu_torch.weights import params_from_flax
from helpers import random_graph
from torch_rank_jobs import spawn_jobs

torch.set_num_threads(1)
RTOL, ATOL = 2e-4, 2e-5
B = 3


@pytest.fixture(scope="module")
def graphs():
    rng = np.random.default_rng(21)
    jt = random_graph(rng, n=21, extra_edges=11, edge_dim=2)
    pt = GraphTemplate(jt.n_node, jt.senders, jt.receivers, edge_attr=jt.edge_attr)
    jg = jt.batch(B, dense=False)
    pg = pt.batch(B, mode="padded", device="cpu")
    strip = dict(senders_dp=None, mask_dp=None, senders_dp_sl=None, mask_dp_sl=None,
                 gcn_dp_sl=None, cheb_dp=None)
    return dict(jt=jt, jg=jg, pg=pg, jseg=dataclasses.replace(jg, **strip),
                pseg=dataclasses.replace(pg, **strip))


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def close(got, ref, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got),
                               np.asarray(ref), rtol=RTOL, atol=ATOL, err_msg=msg)


def test_edge_lists_match_the_jax_batch(graphs):
    jg, pg = graphs["jg"], graphs["pg"]
    for port_edges, s, r in ((pg.edges, jg.senders, jg.receivers),
                             (pg.edges_sl, jg.senders_sl, jg.receivers_sl)):
        np.testing.assert_array_equal(port_edges.senders.numpy(), np.asarray(s))
        np.testing.assert_array_equal(port_edges.receivers.numpy(), np.asarray(r))
    np.testing.assert_array_equal(pg.gcn_norm.numpy(), np.asarray(jg.gcn_norm))
    np.testing.assert_array_equal(pg.cheb_norm.numpy(), np.asarray(jg.cheb_norm))
    np.testing.assert_array_equal(pg.edge_attr.numpy(), np.asarray(jg.edge_attr))
    assert not (graphs["pseg"].padded or graphs["pseg"].dense or graphs["pseg"].banded)


@pytest.mark.parametrize("op", ["sum", "mean", "max"])
def test_segment_reductions_match_jax(graphs, op):
    jg, pg = graphs["jg"], graphs["pg"]
    rng = np.random.default_rng(1)
    data = rng.standard_normal((int(jg.senders.shape[0]), 4)).astype(np.float32)
    jfn = {"sum": jops.segment_sum, "mean": jops.segment.segment_mean,
           "max": jops.segment.segment_max}[op]
    pfn = {"sum": segment.segment_sum, "mean": segment.segment_mean,
           "max": segment.segment_max}[op]
    ref, vjp = jax.vjp(lambda d: jfn(d, jg.receivers, jg.n_node), jnp.asarray(data))
    d = t(data).requires_grad_(True)
    got = pfn(d, pg.edges)
    close(got, ref)
    cot = rng.standard_normal(got.shape).astype(np.float32)
    (got * t(cot)).sum().backward()
    close(d.grad, vjp(jnp.asarray(cot))[0])


@pytest.mark.parametrize("masked", [False, True])
def test_segment_softmax_matches_jax(graphs, masked):
    jg, pg = graphs["jg"], graphs["pg"]
    rng = np.random.default_rng(2)
    E = int(jg.senders_sl.shape[0])
    logits = rng.standard_normal((E, 2)).astype(np.float32)
    emask = rng.random(E) > 0.2 if masked else None
    jm = None if emask is None else jnp.asarray(emask)
    ref, vjp = jax.vjp(lambda lg: jops.segment_softmax(lg, jg.receivers_sl, jg.n_node,
                                                        edge_mask=jm), jnp.asarray(logits))
    lg = t(logits).requires_grad_(True)
    got = segment.segment_softmax(lg, pg.edges_sl,
                                  None if emask is None else torch.from_numpy(emask))
    close(got, ref)
    cot = rng.standard_normal((E, 2)).astype(np.float32)
    (got * t(cot)).sum().backward()
    close(lg.grad, vjp(jnp.asarray(cot))[0])


@pytest.mark.parametrize("weight", [None, "gcn", "heads", "masked"])
def test_spmm_matches_jax(graphs, weight):
    jg, pg = graphs["jg"], graphs["pg"]
    rng = np.random.default_rng(3)
    sl = weight in ("gcn", "masked")
    s, r = (jg.senders_sl, jg.receivers_sl) if sl else (jg.senders, jg.receivers)
    edges = pg.edges_sl if sl else pg.edges
    E = int(s.shape[0])
    x = rng.standard_normal((jg.n_node, 2, 3) if weight == "heads" else (jg.n_node, 5))
    x = x.astype(np.float32)
    w = {None: None, "gcn": np.asarray(jg.gcn_norm), "masked": np.asarray(jg.gcn_norm),
         "heads": rng.standard_normal((E, 2)).astype(np.float32)}[weight]
    emask = rng.random(E) > 0.3 if weight == "masked" else None

    def jfn(x_, w_):
        return jops.spmm(x_, s, r, jg.n_node, edge_weight=w_,
                         edge_mask=None if emask is None else jnp.asarray(emask))
    args = (jnp.asarray(x), None if w is None else jnp.asarray(w))
    ref, vjp = jax.vjp(jfn, *args)
    xt = t(x).requires_grad_(True)
    wt = None if w is None else t(w).requires_grad_(True)
    got = segment.spmm(xt, edges, wt, None, None if emask is None else torch.from_numpy(emask))
    close(got, ref)
    cot = rng.standard_normal(got.shape).astype(np.float32)
    (got * t(cot)).sum().backward()
    gx, gw = vjp(jnp.asarray(cot))
    close(xt.grad, gx)
    if wt is not None:
        close(wt.grad, gw)


def test_sddmm_and_gathers_match_jax(graphs):
    jg, pg = graphs["jg"], graphs["pg"]
    rng = np.random.default_rng(4)
    a = rng.standard_normal((jg.n_node, 6)).astype(np.float32)
    b = rng.standard_normal((jg.n_node, 6)).astype(np.float32)
    ref, vjp = jax.vjp(lambda a_, b_: jops.sddmm_dot(a_, b_, jg.senders, jg.receivers),
                       jnp.asarray(a), jnp.asarray(b))
    at, bt = t(a).requires_grad_(True), t(b).requires_grad_(True)
    got = segment.sddmm_dot(at, bt, pg.edges)
    close(got, ref)
    cot = rng.standard_normal(got.shape).astype(np.float32)
    (got * t(cot)).sum().backward()
    ga, gb = vjp(jnp.asarray(cot))
    close(at.grad, ga)
    close(bt.grad, gb)


MODELS = {"gatres": (JaxGATRes(num_blocks=2, channels=8), lambda: GATRes(2, 8)),
          "gin": (JaxGIN(num_blocks=2, channels=8), lambda: GIN(2, 8)),
          "gcn2": (JaxGCN2(num_blocks=2, channels=8), lambda: GCN2(2, 8)),
          "chebnet": (JaxChebNet(channels=8), lambda: ChebNet(8))}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_models_on_the_stripped_graph_match_jax(graphs, name):
    """``tests/test_layers.py``'s segment-only graph: forward and every
    parameter gradient of the loss Σ out · cot."""
    jmodel, pmodel = MODELS[name]
    jg, jseg, pseg = graphs["jg"], graphs["jseg"], graphs["pseg"]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((jg.n_node, 1)).astype(np.float32)
    cot = rng.standard_normal((jg.n_node, 1)).astype(np.float32)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), jg)
    model = pmodel()
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params), model))

    def loss(p):
        out = jmodel.apply(p, jnp.asarray(x), jseg)
        return jnp.sum(out * jnp.asarray(cot)), out
    (_, ref), grads = jax.value_and_grad(loss, has_aux=True)(params)
    out = model(t(x), pseg)
    close(out, ref, name)
    (out * t(cot)).sum().backward()
    ref_g = params_from_flax(jax.tree.map(np.asarray, grads), model)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_g[k].numpy(), rtol=RTOL,
                                   atol=ATOL * max(1.0, float(np.abs(ref_g[k].numpy()).max())),
                                   err_msg=f"{name} {k}")


@pytest.fixture(scope="module")
def axis_runs(graphs, tmp_path_factory):
    """``spmm`` with ``axis`` on a 1×2 mesh of gloo ranks, plain and with the
    GCN weights over the self-loop list."""
    jt = graphs["jt"]
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B * jt.n_node, 4)).astype(np.float32)
    cot = rng.standard_normal((B * jt.n_node, 4)).astype(np.float32)
    tpl = dict(n=jt.n_node, senders=np.asarray(jt.senders), receivers=np.asarray(jt.receivers))
    jobs = [dict(kind="spmm", dp=1, gp=2, template=tpl, B=B, x=x, cot=cot, self_loops=sl)
            for sl in (False, True)]
    out = tmp_path_factory.mktemp("axis")
    spec = os.path.join(out, "spec.pkl")
    with open(spec, "wb") as f:
        pickle.dump({"jobs": jobs, "out": str(out)}, f)
    assert spawn_jobs(2, spec, device="cpu", threads=1, timeout_s=300) == 0
    return x, cot, [pickle.load(open(os.path.join(out, f"rank{r}.pkl"), "rb"))["results"]
                    for r in range(2)]


@pytest.mark.parametrize("self_loops", [False, True])
def test_edge_partitioned_spmm_matches_jax(graphs, axis_runs, self_loops):
    jg = graphs["jg"]
    x, cot, ranks = axis_runs
    s, r = (jg.senders_sl, jg.receivers_sl) if self_loops else (jg.senders, jg.receivers)
    w = jnp.asarray(jg.gcn_norm) if self_loops else None
    ref, vjp = jax.vjp(lambda x_: jops.spmm(x_, s, r, jg.n_node, edge_weight=w), jnp.asarray(x))
    (gx,) = vjp(jnp.asarray(cot))
    i = int(self_loops)
    out = np.concatenate([ranks[g][i]["out"] for g in range(2)])[:jg.n_node]
    grad = np.concatenate([ranks[g][i]["grad"] for g in range(2)])[:jg.n_node]
    close(out, ref)
    close(grad, gx)
