"""PyTorch port: the degree-padded aggregation mode (``batch(mode="padded")``,
``ops.padded``) and the windowed gather (``ops.window_gather``, the
counterpart of ``make_window_gather``) against the JAX package, on the CPU
(the port runs its plain versions; the JAX side its XLA gather and, for the
windowed gather, its Pallas kernel in interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_pressure_estimation_tpu.models.gatres import GATRes as JaxGATRes
from gnn_pressure_estimation_tpu.ops.padded import build_transpose_tables as jax_transpose_tables
from gnn_pressure_estimation_tpu.ops.padded import make_padded_gather
from gnn_pressure_estimation_tpu.ops.pallas import window_gather as jax_wg
from gnn_pressure_estimation_tpu.train.loop import TrainConfig as JaxTrainConfig
from gnn_pressure_estimation_tpu.train.loop import Trainer as JaxTrainer
from gnn_pressure_estimation_tpu.utils.scaling import NormStats as JaxNormStats
from gnn_pressure_estimation_tpu_torch.core.graph import GraphTemplate
from gnn_pressure_estimation_tpu_torch.data.dataset import WDNDataset, _Member
from gnn_pressure_estimation_tpu_torch.evaluation.infer import Inferencer
from gnn_pressure_estimation_tpu_torch.models.gatres import GATRes
from gnn_pressure_estimation_tpu_torch.ops.padded import build_transpose_tables, padded_gather
from gnn_pressure_estimation_tpu_torch.ops.window_gather import (
    build_window_layout, make_window_gather, window_gather_bwd, window_gather_bwd_plain,
    window_gather_fwd,
)
from gnn_pressure_estimation_tpu_torch.train import TrainConfig, Trainer, load_checkpoint
from gnn_pressure_estimation_tpu_torch.utils.masking import masked_count
from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats
from gnn_pressure_estimation_tpu_torch.weights import params_from_flax
from helpers import random_graph

torch.set_num_threads(1)


def _pair(rng, n=21, extra=11):
    jt = random_graph(rng, n=n, extra_edges=extra)
    return jt, GraphTemplate(jt.n_node, jt.senders, jt.receivers)


def test_degree_tables_match_jax(rng):
    jt, pt = _pair(rng)
    assert pt.max_degree == jt.max_degree
    jd, pd = jt.degree_tables(), pt.degree_tables()
    for k in ("senders_dp", "mask_dp", "senders_dp_sl", "mask_dp_sl", "out_flat", "out_mask",
              "out_flat_sl", "out_mask_sl"):
        np.testing.assert_array_equal(pd[k], jd[k], err_msg=k)
    idx = rng.integers(0, 30, (12, 4)).astype(np.int32)
    m = rng.random((12, 4)) < 0.7
    for a, b in zip(build_transpose_tables(idx, m, 30), jax_transpose_tables(idx, m, 30)):
        np.testing.assert_array_equal(a, b)


def test_padded_batch_matches_jax_tables(rng):
    """Tables built once per template and shifted per graph, as the JAX
    ``batch`` does, equal its batched tables; cached per batch size."""
    jt, pt = _pair(rng)
    B = 3
    jg, pg = jt.batch(B, mode="padded"), pt.batch(B, "padded", device="cpu")
    assert pg.padded and not pg.dense and not pg.banded and pg.nodes_per_graph == jt.n_node
    assert pg.band_attn is None and pt.batch(B, "padded", device="cpu") is pg
    for k in ("senders_dp", "mask_dp", "senders_dp_sl", "mask_dp_sl", "inv_degree"):
        np.testing.assert_array_equal(getattr(pg, k).numpy(), np.asarray(getattr(jg, k)), err_msg=k)
    # the shifted transpose tables are the tables of the batched in-edge
    # tables on their valid slots (an empty slot holds its graph's offset)
    for idx, mask, flat, omask in ((pg.senders_dp, pg.mask_dp, pg.out_flat, pg.out_mask),
                                   (pg.senders_dp_sl, pg.mask_dp_sl, pg.out_flat_sl, pg.out_mask_sl)):
        f, m = build_transpose_tables(idx.numpy().astype(np.int32), mask.numpy(), B * jt.n_node)
        np.testing.assert_array_equal(omask.numpy(), m)
        np.testing.assert_array_equal(flat.numpy()[m], f[m])
    with pytest.raises(ValueError, match="banded graphs only"):
        pt.batch(B, "padded", device="cpu", band_attn="acc")


def test_padded_gather_backward_matches_jax_vjp(rng):
    jt, pt = _pair(rng)
    pg = pt.batch(2, "padded", device="cpu")
    x = rng.standard_normal((2 * jt.n_node, 3, 5)).astype(np.float32)
    for idx, flat, omask in ((pg.senders_dp_sl, pg.out_flat_sl, pg.out_mask_sl),
                             (pg.senders_dp, pg.out_flat, pg.out_mask)):
        g = rng.standard_normal(tuple(idx.shape) + (3, 5)).astype(np.float32)
        gather = make_padded_gather(idx.numpy(), flat.numpy(), omask.numpy())
        ref, vjp = jax.vjp(gather, jnp.asarray(x))
        xt = torch.from_numpy(x).requires_grad_()
        out = padded_gather(xt, idx, flat, omask)
        np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
        (got,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
        np.testing.assert_allclose(got.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("nc", [8, 64])
def test_gatres_padded_matches_jax_model(rng, nc):
    """Forward and every parameter gradient of a 2-block GATRes on
    ``tpl.batch(B, mode="padded")``, against the JAX model on its own."""
    jt, pt = _pair(rng, n=40, extra=25)
    B, n = 3, jt.n_node
    jg, pg = jt.batch(B, mode="padded"), pt.batch(B, "padded", device="cpu")
    x = rng.standard_normal((B * n, 1)).astype(np.float32)
    w = rng.standard_normal((B * n, 1)).astype(np.float32)
    jm = JaxGATRes(num_blocks=2, channels=nc)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jg)
    params = jax.tree.map(lambda a: a + 0.05, params)                   # biases that are not zero
    ref = jm.apply(params, jnp.asarray(x), jg)
    jgrads = jax.grad(lambda p: jnp.sum(jnp.tanh(jm.apply(p, jnp.asarray(x), jg)) * jnp.asarray(w)))(
        params)

    model = GATRes(2, nc)
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params), model))
    out = model(torch.from_numpy(x), pg)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad((torch.tanh(out) * torch.from_numpy(w)).sum(),
                                list(model.parameters()))
    want = params_from_flax(jax.tree.map(np.asarray, jgrads), model)
    for (name, _), g in zip(model.named_parameters(), grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_padded_matches_the_ports_dense_and_banded_modes(rng):
    """The three modes compute one function (``tests/test_layers.py``'s mode
    parity, on the port alone): outputs and input gradients."""
    _, pt = _pair(rng, n=40, extra=25)
    B, n = 2, 40
    model = GATRes(2, 8)
    model.reset_parameters(torch.Generator().manual_seed(3))
    x = torch.from_numpy(rng.standard_normal((B * n, 1)).astype(np.float32))
    outs = {}
    for mode in ("dense", "banded", "padded"):
        g = pt.batch(B, mode, 8 if mode == "banded" else None, "cpu")
        xi = x.clone().requires_grad_()
        out = g.unpack_nodes(model(g.pack_nodes(xi, n), g), n) if g.banded else model(xi, g)
        (dx,) = torch.autograd.grad(out.square().sum(), xi)
        outs[mode] = (out.detach().numpy(), dx.numpy())
    for mode in ("banded", "padded"):
        for a, b in zip(outs[mode], outs["dense"]):
            np.testing.assert_allclose(a, b, rtol=3e-4, atol=3e-5, err_msg=mode)


def test_train_step_padded_matches_jax_trainer(rng):
    """Loss, metrics and gradients of one step of a 1-block GATRes, nc 8, with
    ``agg_mode="padded"``; the tolerances of tests/test_torch_train.py."""
    jt, pt = _pair(rng, n=40, extra=25)
    n, bs = jt.n_node, 3
    kw = dict(batch_size=bs, mask_rate=0.5, criterion="mse", agg_mode="padded", donate_state=False,
              seed=0)
    stats = dict(norm_type="znorm", mean=1.0, std=3.0)
    jtr = JaxTrainer(JaxGATRes(num_blocks=1, channels=8), JaxTrainConfig(**kw),
                     JaxNormStats(**stats), jt)
    ptr = Trainer(GATRes(1, 8), TrainConfig(**kw), NormStats(**stats), pt, device="cpu")
    ptr.model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, jtr.params), ptr.model))
    xb = rng.standard_normal((bs, n)).astype(np.float32)
    k = masked_count(n, 0.5)
    mask = np.zeros((bs, n), bool)
    for b in range(bs):
        mask[b, rng.permutation(n)[:k]] = True
    mask = mask.reshape(-1)

    jg = jtr._batched_graph(jt, bs)
    assert jg.padded
    jx = jnp.asarray(xb.reshape(-1, 1))

    def loss_fn(p_):
        loss, mets, _ = jtr._masked_loss_and_metrics(p_, jg, jx, jx, jnp.asarray(mask), bs * k,
                                                     "train")
        return loss, mets

    (jloss, jmets), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jtr.params)
    graph, x, pmask, pn = ptr._prepare(pt, xb, mask, None, None)
    assert graph.padded and pn == bs * k
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))            # original node order
    np.testing.assert_array_equal(pmask.numpy(), mask)
    ptr.model.train()
    loss, mets, _ = ptr._masked_loss_and_metrics(graph, x, x, pmask, pn, "train")
    grads = torch.autograd.grad(loss, list(ptr.model.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for name in mets:
        np.testing.assert_allclose(float(mets[name]), float(jmets[name]), rtol=1e-4, atol=2e-5,
                                   err_msg=name)
    ref = params_from_flax(jax.tree.map(np.asarray, jgrads), ptr.model)
    for (name, _), g in zip(ptr.model.named_parameters(), grads):
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), rtol=1e-3, atol=1e-5, err_msg=name)


def test_padded_fit_records_the_mode_and_serves(rng, tmp_path):
    """``TrainConfig(agg_mode="padded")`` trains and writes the mode into the
    checkpoint's layout; ``Inferencer(agg_mode="padded")`` serves the same
    fields as the dense mode."""
    _, pt = _pair(rng, n=30, extra=12)
    arr = rng.standard_normal((8, 30)).astype(np.float32)
    ds = WDNDataset.from_members([_Member(pt, arr, [], None)], NormStats())
    model = GATRes(1, 4)
    tr = Trainer(model, TrainConfig(epochs=1, batch_size=4, mask_rate=0.5, agg_mode="padded",
                                    save_path=str(tmp_path)), NormStats(), pt, device="cpu")
    tr.fit(ds, ds, log_fn=lambda *_: None)
    _, _, meta = load_checkpoint(str(tmp_path / "last_model.ckpt"), model.state_dict())
    assert meta["extra"]["layout"]["agg_mode"] == "padded"
    obs = np.arange(0, 30, 3)
    preds = [Inferencer(model, NormStats(), agg_mode=mode, device="cpu").infer(
        pt, arr, obs, batch_size=4).pred for mode in ("padded", "dense")]
    np.testing.assert_allclose(preds[0], preds[1], rtol=1e-5, atol=1e-5)


# ---- the windowed gather ---------------------------------------------------------

def _window_case(rng, case):
    """Degree-padded tables: a graph's in-edge slots with the self-loop slot
    (sentinel slots where a node has fewer in-edges than D), or the wide
    random tables of the tail-chunk regression (W clamped to the source,
    not a multiple of 1024)."""
    if case == "tail_chunk":
        N, D = 1280, 3
        senders = rng.integers(0, N, (N, D)).astype(np.int32)
        return senders, np.ones((N, D), bool), N, np.arange(N)
    jt = random_graph(rng, n=300, extra_edges=150)
    dt = GraphTemplate(jt.n_node, jt.senders, jt.receivers).degree_tables()
    return dt["senders_dp_sl"], dt["mask_dp_sl"], jt.n_node, None


@pytest.mark.parametrize("case", ["graph", "tail_chunk"])
def test_window_layout_matches_jax(rng, case):
    senders, mask, N, perm = _window_case(rng, case)
    block = 64 if case == "graph" else 256
    jl = jax_wg.build_window_layout(senders, mask, N, block=block, perm=perm)
    pl = build_window_layout(senders, mask, N, block=block, perm=perm)
    assert pl.n_pad == jl.n_pad
    for k in ("perm", "inv_perm", "mask_fwd", "mask_bwd"):
        np.testing.assert_array_equal(getattr(pl, k), getattr(jl, k), err_msg=k)
    for t in ("fwd", "bwd"):
        a, b = getattr(pl, t), getattr(jl, t)
        assert (a.n_rows, a.BLK, a.D, a.W) == (b.n_rows, b.BLK, b.D, b.W), t
        for k in ("rel", "win_start", "mask"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=f"{t}.{k}")
    if case == "tail_chunk":
        assert pl.fwd.W % 1024 != 0
    else:
        assert (pl.fwd.rel == pl.fwd.W).any()               # sentinel slots


@pytest.mark.parametrize("case,C", [("graph", 5), ("graph", 8), ("tail_chunk", 8)])
def test_window_gather_matches_pallas_kernel(rng, case, C):
    """Forward exact, backward within 1e-6, against ``make_window_gather`` in
    interpret mode; the forward also against the plain ``x_perm[idx_perm]``."""
    senders, mask, N, perm = _window_case(rng, case)
    block = 64 if case == "graph" else 256
    layout = build_window_layout(senders, mask, N, block=block, perm=perm)
    xp = rng.standard_normal((layout.n_pad, C)).astype(np.float32)
    g = rng.standard_normal((layout.n_pad, layout.fwd.D, C)).astype(np.float32)
    jgather = jax_wg.make_window_gather(jax_wg.build_window_layout(senders, mask, N, block=block,
                                                                   perm=perm), interpret=True)
    ref, vjp = jax.vjp(jgather, jnp.asarray(xp))
    xt = torch.from_numpy(xp).requires_grad_()
    out = make_window_gather(layout)(xt)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    # the same slots from the degree tables: perm space, zero where a slot is empty
    inv = layout.inv_perm
    idx_perm = np.zeros_like(senders)
    mask_perm = np.zeros_like(mask)
    idx_perm[inv] = inv[senders]
    mask_perm[inv] = mask
    direct = np.where(mask_perm[..., None], xp[idx_perm], 0.0)
    np.testing.assert_array_equal(out.detach().numpy()[:N], direct)
    (got,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), rtol=0, atol=1e-6)


def test_window_gather_wrappers_take_device_tables(rng):
    senders, mask, N, perm = _window_case(rng, "graph")
    layout = build_window_layout(senders, mask, N, block=64)
    fwd, bwd = layout.fwd.to("cpu"), layout.bwd.to("cpu")
    assert fwd.rel.dtype == torch.int32 and fwd.mask.dtype == torch.bool
    x = torch.from_numpy(rng.standard_normal((layout.n_pad, 3)).astype(np.float32))
    slots = window_gather_fwd(x, fwd)
    assert slots.shape == (layout.n_pad, fwd.D, 3)
    flat = slots.reshape(-1, 3)
    assert torch.equal(window_gather_bwd(flat, bwd), window_gather_bwd_plain(flat, bwd))
