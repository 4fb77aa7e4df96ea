"""PyTorch port: the edge-list path under bf16 activations against the JAX
package.

The edge list (the receiver-sorted edges with self-loops, ``ops.segment``)
is what a graph without dense, banded or padded tables takes: the edge
partition of ``DistributedTrainer``, and ``tests/test_layers.py``'s stripped
graph (a padded batch with its padded tables taken out). ``GATConv`` with
``dtype=bfloat16`` rounds there where the jitted JAX layer's edge-list
branch rounds: ``x @ w``, the logit halves, the softmax's weights, each
message, and each running sum of a receiver's messages (XLA's bf16
scatter-add rounds after every add, in edge order).

Held, with the gates of ``tests/test_torch_activation_dtype.py``:

- ``ops.segment.segment_sum_bf16`` bit-equal to the jitted JAX
  ``segment_sum`` of bf16 messages;
- ``GATConv(dtype=bfloat16)`` on the stripped graph against the jitted JAX
  layer: the forward within one bf16 step (2^-8 of each value) plus
  ``1e-5 + 1e-5·max|ref|``, at most 1% of values past the second term, and
  at least ``5e-4·max|ref|`` from the JAX f32 layer's; d x and every
  parameter gradient within ``2^-5·max|g| + 1e-6`` (the JAX backward sums
  its bf16 cotangents in bf16, the port in f32: ROADMAP, divergences);
- GATRes at GATRes-small's width (nc 32, 2 heads), cut to 4 blocks, on the
  stripped graph: the forward within 1e-3 of the JAX model's, the loss of a
  masked step to rtol 1e-5, and each gradient no farther from the JAX bf16
  gradient than twice the port's f32 gradient is, or 2^-6·max|g|, plus
  1e-4 of the largest gradient (the model rule);
- one ``DistributedTrainer`` step of a 2-rank gloo launch (a 1×2 mesh, the
  edge partition; ``tests/torch_rank_jobs.py`` ``dist_step``) against the
  JAX ``DistributedTrainer`` at dp 1 / gp 2 on the same mask: the loss to
  rtol 1e-5, the train MAE to rtol 1e-4, the gradients at the model rule
  (the JAX gradients come out of ``make_distributed_train_step`` itself,
  given an optimizer that returns them as its state), and every rank's
  parameters bit-identical after the step.
"""

import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gnn_pressure_estimation_tpu import ops as jops
from gnn_pressure_estimation_tpu.models.gatres import GATRes as JaxGATRes
from gnn_pressure_estimation_tpu.models.layers import GATConv as JaxGATConv
from gnn_pressure_estimation_tpu.parallel import make_mesh as jax_make_mesh
from gnn_pressure_estimation_tpu.parallel.distributed import DistributedTrainer as JaxDT
from gnn_pressure_estimation_tpu.parallel.distributed import _dist_criterion
from gnn_pressure_estimation_tpu.parallel.distributed import make_distributed_train_step
from gnn_pressure_estimation_tpu.train.loop import TrainConfig as JaxTrainConfig
from gnn_pressure_estimation_tpu.utils.masking import batch_node_mask as jax_mask
from gnn_pressure_estimation_tpu.utils.scaling import NormStats as JaxNormStats
from gnn_pressure_estimation_tpu_torch.core.graph import GraphTemplate
from gnn_pressure_estimation_tpu_torch.models.gatres import GATRes
from gnn_pressure_estimation_tpu_torch.models.layers import GATConv
from gnn_pressure_estimation_tpu_torch.ops import segment
from gnn_pressure_estimation_tpu_torch.weights import params_from_flax
from helpers import random_graph
from torch_rank_jobs import spawn_jobs

torch.set_num_threads(1)
BF16_STEP = 2.0 ** -8
B, N, CIN = 2, 40, 12
STRIP = dict(senders_dp=None, mask_dp=None, senders_dp_sl=None, mask_dp_sl=None,
             gcn_dp_sl=None, cheb_dp=None)


@pytest.fixture(scope="module")
def graphs():
    jt = random_graph(np.random.default_rng(7), n=N, extra_edges=20)
    pt = GraphTemplate(jt.n_node, jt.senders, jt.receivers)
    jg, pg = jt.batch(B, dense=False), pt.batch(B, mode="padded", device="cpu")
    jseg, pseg = dataclasses.replace(jg, **STRIP), dataclasses.replace(pg, **STRIP)
    assert not (pseg.dense or pseg.banded or pseg.padded or pseg.halo)
    return dict(jt=jt, jseg=jseg, pseg=pseg)


def _within_a_bf16_step(got, ref, what, share=0.01):
    got, ref = np.asarray(got), np.asarray(ref)
    err, fine = np.abs(got - ref), 1e-5 + 1e-5 * float(np.abs(ref).max())
    assert (err <= BF16_STEP * np.abs(ref) + fine).all(), f"{what}: {err.max():.3e}"
    assert (err > fine).mean() <= share, f"{what}: {(err > fine).sum()} of {err.size} a step off"


def _grad_close(got, ref, what, tol=2.0 ** -5):
    got, ref = np.asarray(got), np.asarray(ref)
    err, top = float(np.abs(got - ref).max()), float(np.abs(ref).max())
    assert err <= tol * top + 1e-6, f"{what}: {err:.3e} (max |g| {top:.3e})"


def _model_rule(got16, got32, ref):
    """Each gradient no farther from the JAX bf16 gradient than twice the
    port's f32 gradient is, or 2^-6·max|g|, plus 1e-4 of the largest."""
    top = max(float(np.abs(np.asarray(r)).max()) for r in ref.values())
    for name, r in ref.items():
        r = np.asarray(r)
        err16 = float(np.abs(np.asarray(got16[name]) - r).max())
        err32 = float(np.abs(np.asarray(got32[name]) - r).max())
        assert err16 <= max(2 * err32, 2.0 ** -6 * float(np.abs(r).max())) + 1e-4 * top, \
            f"{name}: {err16:.3e} against the f32 step's {err32:.3e}"


def test_segment_sum_bf16_matches_jit_jax(graphs):
    """The running bf16 sum of each receiver's messages is the jitted JAX
    ``segment_sum`` of bf16 messages bit for bit; one f32 sum rounded once
    is not."""
    jseg, edges = graphs["jseg"], graphs["pseg"].edges_sl
    d = np.random.default_rng(1).standard_normal((len(edges.receivers), 2, 8)).astype(np.float32)
    ref = jax.jit(lambda a: jops.segment_sum(a, jseg.receivers_sl, jseg.n_node))(
        jnp.asarray(d, jnp.bfloat16))
    data = torch.from_numpy(d).to(torch.bfloat16)
    got = segment.segment_sum_bf16(data, edges)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))
    once = segment.segment_sum(data.float(), edges).to(torch.bfloat16)
    assert not torch.equal(once, got)


LAYER_CASES = [(2, 8, True), (1, 8, False), (2, 32, True), (1, 32, False), (3, 5, True)]


@pytest.mark.parametrize("H,C,concat", LAYER_CASES, ids=[f"H{h}-C{c}" for h, c, _ in LAYER_CASES])
def test_gatconv_edge_list_bf16_matches_jit_jax_layer(graphs, H, C, concat):
    jseg, pseg = graphs["jseg"], graphs["pseg"]
    rng = np.random.default_rng(10 * H + C)
    x = rng.standard_normal((B * N, CIN)).astype(np.float32)
    g = rng.standard_normal((B * N, H * C if concat else C)).astype(np.float32)
    jl = JaxGATConv(out_channels=C, heads=H, concat=concat, dtype=jnp.bfloat16)
    params = jl.init(jax.random.PRNGKey(H + C), jnp.asarray(x), jseg)
    params = {"params": {k: v + 0.1 if k == "bias" else v for k, v in params["params"].items()}}
    ref, vjp = jax.vjp(jax.jit(lambda p, xx: jl.apply(p, xx, jseg)), params, jnp.asarray(x))
    jgrads, jdx = vjp(jnp.asarray(g))
    ref32 = jax.jit(lambda p, xx: jl.clone(dtype=jnp.float32).apply(p, xx, jseg))(
        params, jnp.asarray(x))

    layer = GATConv(CIN, C, heads=H, concat=concat, dtype=torch.bfloat16)
    layer.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params), layer))
    px = torch.from_numpy(x).requires_grad_()
    out = layer(px, pseg)
    assert out.dtype == torch.float32
    _within_a_bf16_step(out.detach().numpy(), ref, f"H {H} C {C} forward")
    gap = float(np.abs(out.detach().numpy() - np.asarray(ref32)).max())
    assert gap >= 5e-4 * float(np.abs(ref).max()), f"only {gap:.3e} from the f32 layer"
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(), [px, *layer.parameters()])
    _grad_close(grads[0].numpy(), jdx, "d x")
    want = params_from_flax(jax.tree.map(np.asarray, jgrads), layer)
    for (name, _), gr in zip(layer.named_parameters(), grads[1:]):
        _grad_close(gr.numpy(), want[name].numpy(), name)


def test_gatres_small_width_edge_list_bf16_forward_and_step(graphs):
    jseg, pseg = graphs["jseg"], graphs["pseg"]
    blocks, nc = 4, 32
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B * N, 1)).astype(np.float32)
    mask = np.zeros(B * N, bool)
    mask[rng.permutation(B * N)[:int(0.8 * B * N)]] = True
    x_in = np.where(mask[:, None], 0.0, x).astype(np.float32)
    jm = JaxGATRes(num_blocks=blocks, channels=nc, dtype=jnp.bfloat16)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), jseg)
    mk = jnp.asarray(mask[:, None], jnp.float32)

    def jloss_fn(p):
        diff = (jm.apply(p, jnp.asarray(x_in), jseg) - jnp.asarray(x)) * mk
        return jnp.sum(diff * diff) / jnp.sum(mk)

    jout = np.asarray(jax.jit(lambda p: jm.apply(p, jnp.asarray(x_in), jseg))(params))
    jloss, jgrads = jax.jit(jax.value_and_grad(jloss_fn))(params)
    got = {}
    for dt in (torch.bfloat16, None):
        model = GATRes(blocks, nc, dtype=dt)
        model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params), model))
        out = model(torch.from_numpy(x_in), pseg)
        diff = (out - torch.from_numpy(x)) * torch.from_numpy(mask[:, None]).float()
        loss = (diff * diff).sum() / float(mask.sum())
        names = [k for k, _ in model.named_parameters()]
        got[dt] = (out.detach().numpy(), float(loss.detach()),
                   dict(zip(names, (g.numpy() for g in torch.autograd.grad(
                       loss, list(model.parameters()))))))
    out16, loss16, g16 = got[torch.bfloat16]
    np.testing.assert_allclose(out16, jout, rtol=0, atol=1e-3, err_msg="model forward")
    assert float(np.abs(out16 - got[None][0]).max()) > 1e-4, "the bf16 model computed in f32"
    np.testing.assert_allclose(loss16, float(jloss), rtol=1e-5)
    ref = {k: v.numpy() for k, v in
           params_from_flax(jax.tree.map(np.asarray, jgrads), GATRes(blocks, nc)).items()}
    _model_rule(g16, got[None][2], ref)


# ---- DistributedTrainer: the edge partition on a 1×2 mesh of gloo ranks ------------------------

def _returning_grads() -> optax.GradientTransformation:
    """An optimizer whose state after ``update`` is the gradient it was
    given (and whose update is zero), so a train step hands its summed
    gradients back as the optimizer state."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


@pytest.fixture(scope="module")
def dist_case(tmp_path_factory):
    rng = np.random.default_rng(310)
    jt = random_graph(rng, n=24, extra_edges=12)
    kw = dict(batch_size=4, mask_rate=0.5, criterion="mse", lr=1e-3, weight_decay=0.0, seed=0)
    stats = dict(norm_type="znorm", mean=2.0, std=1.5)
    mkw = dict(num_blocks=2, channels=8)
    x = rng.standard_normal((4, 24)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    mask = np.asarray(jax_mask(key, 4, 24, 0.5))
    g = random_graph(np.random.default_rng(0), n=6, extra_edges=2).batch(1, mode="dense")
    params = JaxGATRes(**mkw).init(jax.random.PRNGKey(0), jnp.zeros((6, 1), jnp.float32), g)
    state = {k: v.numpy() for k, v in
             params_from_flax(jax.tree.map(np.asarray, params), GATRes(**mkw)).items()}
    tpl = dict(n=24, senders=np.asarray(jt.senders), receivers=np.asarray(jt.receivers))
    jobs = [dict(kind="dist_step", dp=1, gp=2, template=tpl,
                 model=("gatres", dict(mkw, dtype=dt), state), cfg=kw, stats=stats, x=x,
                 masks=[mask]) for dt in (torch.bfloat16, None)]
    out = tmp_path_factory.mktemp("dist_bf16")
    spec = os.path.join(out, "spec.pkl")
    with open(spec, "wb") as f:
        pickle.dump({"jobs": jobs, "out": str(out)}, f)
    assert spawn_jobs(2, spec, device="cpu", threads=1, timeout_s=300) == 0
    ranks = [pickle.load(open(os.path.join(out, f"rank{r}.pkl"), "rb"))["results"]
             for r in range(2)]
    return dict(jt=jt, kw=kw, stats=stats, mkw=mkw, x=x, key=key, params=params, ranks=ranks)


def test_distributed_trainer_bf16_step_matches_jax(dist_case):
    c = dist_case
    model = JaxGATRes(**c["mkw"], dtype=jnp.bfloat16)
    cfg = JaxTrainConfig(donate_state=False, **c["kw"])
    mesh = jax_make_mesh(dp=1, gp=2)
    dtr = JaxDT(model, cfg, JaxNormStats(**c["stats"]), c["jt"], mesh)
    tx = _returning_grads()
    step, pack, _ = make_distributed_train_step(model, tx, mesh, c["jt"], dtr.batch_per_shard,
                                                cfg.mask_rate, JaxNormStats(**c["stats"]),
                                                _dist_criterion(cfg.criterion))
    _, jgrads, loss, mets = step(c["params"], tx.init(c["params"]), pack(c["x"]), c["key"])
    ref = {k: v.numpy() for k, v in
           params_from_flax(jax.tree.map(np.asarray, jgrads), GATRes(**c["mkw"])).items()}
    r16, r32 = ([r[i] for r in c["ranks"]] for i in (0, 1))
    for ranks in (r16, r32):
        for k in ranks[0]["state"]:
            np.testing.assert_array_equal(ranks[1]["state"][k], ranks[0]["state"][k], err_msg=k)
    np.testing.assert_allclose(r16[0]["losses"][0], float(loss), rtol=1e-5)
    np.testing.assert_allclose(r16[0]["mets"][0]["train_mae"], float(mets["train_mae"]),
                               rtol=1e-4)
    assert r16[0]["losses"][0] != r32[0]["losses"][0], "the bf16 step computed in f32"
    _model_rule(r16[0]["grads"][0], r32[0]["grads"][0], ref)
    # the JAX DistributedTrainer's own step (Adam) computes the same loss
    _, _, loss2, _ = dtr.step(c["params"], dtr.tx.init(c["params"]), dtr.pack(c["x"]), c["key"])
    assert float(loss2) == float(loss)
