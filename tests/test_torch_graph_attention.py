"""PyTorch port: the dense-mode attention ops (``ops/graph_attention.py``)
against the JAX package's Pallas kernels ``make_fused_attention`` and
``make_fused_factored`` (interpret mode on the CPU), forward and every input
gradient, and ``GATConv`` on a dense graph against the JAX layer with and
without its fused op attached. The port runs on the CPU, through the
autograd Functions' plain versions; the compressed mask index that the CUDA
kernels walk is checked by walking it in numpy.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_pressure_estimation_tpu.models import layers as jax_layers
from gnn_pressure_estimation_tpu.ops.pallas.graph_attention import (
    make_fused_attention,
    make_fused_factored,
)
from gnn_pressure_estimation_tpu_torch.core.graph import GraphTemplate
from gnn_pressure_estimation_tpu_torch.models.layers import GATConv
from gnn_pressure_estimation_tpu_torch.ops import graph_attention as ga
from gnn_pressure_estimation_tpu_torch.ops.banded import plain_versions
from helpers import random_graph

torch.set_num_threads(1)
F_RTOL, F_ATOL = 1e-5, 1e-6      # forward
G_RTOL, G_ATOL = 1e-4, 1e-5      # gradients (tests/test_layers.py's for the kernels)

# n 26 and n 130 (one above a multiple of the TPU's 128 lanes), H, C, B
SHAPES = [(26, 1, 4, 1), (26, 2, 32, 2), (26, 2, 4, 3), (26, 1, 32, 3),
          (130, 1, 32, 1), (130, 2, 4, 2), (130, 2, 32, 3), (130, 1, 4, 2)]


def _mask(rng, n, kind="symmetric"):
    """An adjacency mask with self-loops. ``one_way``: some links in one
    direction only, so the mask is not symmetric."""
    tpl = random_graph(rng, n=n, extra_edges=n // 2)
    m = np.eye(n, dtype=bool)
    m[tpl.receivers, tpl.senders] = True
    if kind == "one_way":
        i, j = np.nonzero(np.triu(m, 1))
        drop = rng.permutation(i.size)[: max(2, i.size // 4)]
        m[i[drop], j[drop]] = False
        assert not (m == m.T).all()
    return m


def _alphas(rng, B, n, H, zeroed=False):
    a_dst = rng.standard_normal((B, n, H)).astype(np.float32)
    a_src = rng.standard_normal((B, n, H)).astype(np.float32)
    if zeroed:   # masked (zeroed) nodes: a_d + a_s == 0 exactly where two of them meet
        dead = rng.permutation(n)[: n // 2]
        a_dst[:, dead] = 0.0
        a_src[:, dead] = 0.0
    return a_dst, a_src


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_() for a in arrays]


def _bhn(a):
    """The port's [B, n, H, ...] → the TPU kernels' [B, H, n, ...]."""
    return np.swapaxes(a, 1, 2)


def _check_attention(rng, mask, a_dst, a_src, B, n, H, C):
    v = rng.standard_normal((B, n, H, C)).astype(np.float32)
    g = rng.standard_normal((B, n, H, C)).astype(np.float32)
    args = _t(a_dst, a_src, v)
    out = ga.fused_attention(*args, torch.from_numpy(mask), 0.2)
    grads = torch.autograd.grad((torch.tanh(out) * torch.from_numpy(g)).sum(), args)

    attend = make_fused_attention(mask, 0.2, interpret=True)
    jargs = (jnp.asarray(a_dst), jnp.asarray(_bhn(a_src)), jnp.asarray(_bhn(v)))
    ref = attend(*jargs)
    jg = jax.grad(lambda a: jnp.sum(jnp.tanh(attend(*a)) * jnp.asarray(_bhn(g))))(jargs)
    np.testing.assert_allclose(out.detach().numpy(), _bhn(np.asarray(ref)), rtol=F_RTOL, atol=F_ATOL)
    for got, want, name in zip(grads, (jg[0], _bhn(np.asarray(jg[1])), _bhn(np.asarray(jg[2]))),
                               ("a_dst", "a_src", "v")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=G_RTOL, atol=G_ATOL,
                                   err_msg=name)

    # the explicit backward formulas (the yardstick of the CUDA backward)
    d_out = torch.from_numpy(g)
    o2 = ga.fused_attention(*args, torch.from_numpy(mask), 0.2)
    auto = torch.autograd.grad((o2 * d_out).sum(), args)
    explicit = ga.fused_attention_bwd_plain(*(a.detach() for a in args), torch.from_numpy(mask),
                                            d_out, 0.2)
    for a, b in zip(auto, explicit):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _check_factored(rng, mask, a_dst, a_src, B, n, H, C):
    D = C + 1
    rv = rng.standard_normal((B, n, H, D)).astype(np.float32)
    rq = rng.standard_normal((B, n, H, D)).astype(np.float32)
    g1 = rng.standard_normal((B, n, H, D)).astype(np.float32)
    g2 = rng.standard_normal((B, n, H, D)).astype(np.float32)
    args = _t(a_dst, a_src, rv, rq)
    t_pv, t_nq = ga.fused_factored(*args, torch.from_numpy(mask))
    loss = (torch.tanh(t_pv) * torch.from_numpy(g1)).sum() + (t_nq * torch.from_numpy(g2)).sum()
    grads = torch.autograd.grad(loss, args, allow_unused=True)
    assert grads[0] is None and grads[1] is None      # the gate has no gradient

    agg = make_fused_factored(mask, interpret=True)
    jargs = (jnp.asarray(a_dst), jnp.asarray(_bhn(a_src)), jnp.asarray(_bhn(rv)),
             jnp.asarray(_bhn(rq)))

    def jloss(a):
        p, q = agg(*a)
        return jnp.sum(jnp.tanh(p) * jnp.asarray(_bhn(g1))) + jnp.sum(q * jnp.asarray(_bhn(g2)))

    r_pv, r_nq = agg(*jargs)
    jg = jax.grad(jloss)(jargs)
    np.testing.assert_allclose(t_pv.detach().numpy(), _bhn(np.asarray(r_pv)), rtol=F_RTOL, atol=F_ATOL)
    np.testing.assert_allclose(t_nq.detach().numpy(), _bhn(np.asarray(r_nq)), rtol=F_RTOL, atol=F_ATOL)
    assert not np.asarray(jg[0]).any() and not np.asarray(jg[1]).any()
    for got, want, name in zip(grads[2:], jg[2:], ("rhs_v", "rhs_q")):
        np.testing.assert_allclose(got.numpy(), _bhn(np.asarray(want)), rtol=G_RTOL, atol=G_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("n,H,C,B", SHAPES)
def test_fused_attention_matches_pallas_kernel(rng, n, H, C, B):
    _check_attention(rng, _mask(rng, n), *_alphas(rng, B, n, H), B, n, H, C)


@pytest.mark.parametrize("n,H,C,B", SHAPES)
def test_fused_factored_matches_pallas_kernel(rng, n, H, C, B):
    _check_factored(rng, _mask(rng, n), *_alphas(rng, B, n, H), B, n, H, C)


@pytest.mark.parametrize("op", ["attention", "factored"])
@pytest.mark.parametrize("n,H,C,B", [(26, 2, 4, 2), (130, 1, 32, 1)])
def test_exact_zero_sums_and_one_way_edges(rng, op, n, H, C, B):
    """Zeroed nodes meet at a_d + a_s == 0 (the >= side of every comparison)
    and the mask is not symmetric (the backward must not assume it is)."""
    mask = _mask(rng, n, "one_way")
    a_dst, a_src = _alphas(rng, B, n, H, zeroed=True)
    s = a_dst[:, :, None, :] + a_src[:, None, :, :]
    assert ((s == 0) & mask[None, :, :, None]).sum() > n // 2
    check = _check_attention if op == "attention" else _check_factored
    check(rng, mask, a_dst, a_src, B, n, H, C)


# ---- the compressed mask index ------------------------------------------------

def test_mask_index_lists_rows_and_columns(rng):
    mask = _mask(rng, 40, "one_way")
    ix = ga.build_mask_index(mask)
    assert ix.nnz == int(mask.sum()) and ix.n == 40
    i, j = np.nonzero(mask)
    rows = np.repeat(np.arange(40), np.diff(ix.row_ptr))
    assert np.array_equal(rows, i) and np.array_equal(ix.col, j)
    # the transposed lists name the same entries, grouped by column
    cols = np.repeat(np.arange(40), np.diff(ix.t_ptr))
    assert np.array_equal(ix.col[ix.t_entry], cols) and np.array_equal(rows[ix.t_entry], ix.t_row)
    assert sorted(ix.t_entry.tolist()) == list(range(ix.nnz))
    # the padded neighbour table: each row's columns, then the row itself
    assert ix.nbr.shape == (40, int(mask.sum(1).max()))
    for r in range(40):
        assert set(ix.nbr[r].tolist()) == set(np.nonzero(mask[r])[0].tolist())
    moved = ix.to("cpu")
    assert moved.col.dtype == torch.int32 and moved.nbr.dtype == torch.int64 and moved.n == 40


def test_mask_without_a_self_loop_raises():
    mask = np.eye(5, dtype=bool)
    mask[3, 3] = False
    mask[3, 1] = True
    with pytest.raises(ValueError, match="self-loop"):
        ga.build_mask_index(mask)
    with pytest.raises(ValueError, match="square"):
        ga.build_mask_index(np.ones((3, 4), bool))


def walk_the_index(ix, a_dst, a_src, rv, rq, g_pv, g_nq):
    """The factored pair as a walk of one (b, row, head) at a time, in numpy:
    the forward walks each row's list, the backward each column's, every
    cell going to exactly one of the two sums by the sign of a_d + a_s (>=),
    each channel's adds in list order. Returns (t_pv, t_nq, d_rv, d_rq)."""
    n = ix.n
    t_pv, t_nq = np.zeros_like(rv), np.zeros_like(rq)
    d_rv, d_rq = np.zeros_like(g_pv), np.zeros_like(g_nq)
    for i in range(n):
        for k in range(ix.row_ptr[i], ix.row_ptr[i + 1]):
            j = ix.col[k]
            pos = (a_dst[:, i] + a_src[:, j] >= 0)[..., None]          # [B, H, 1]
            t_pv[:, i] += np.where(pos, rv[:, j], 0)
            t_nq[:, i] += np.where(pos, 0, rq[:, j])
    for j in range(n):
        for t in range(ix.t_ptr[j], ix.t_ptr[j + 1]):
            i = ix.t_row[t]
            pos = (a_dst[:, i] + a_src[:, j] >= 0)[..., None]
            d_rv[:, j] += np.where(pos, g_pv[:, i], 0)
            d_rq[:, j] += np.where(pos, 0, g_nq[:, i])
    return t_pv, t_nq, d_rv, d_rq


@pytest.mark.parametrize("n,H,D,B", [(26, 2, 5, 2), (70, 1, 33, 3)])
def test_walking_the_index_gives_the_plain_sums(rng, n, H, D, B):
    """What the CUDA kernels compute, spelled out in numpy (the lane-level
    replay of their walk is ``tests/test_torch_dense_walk.py``)."""
    mask = _mask(rng, n, "one_way")
    ix = ga.build_mask_index(mask)
    a_dst, a_src = _alphas(rng, B, n, H, zeroed=True)
    rv = rng.standard_normal((B, n, H, D)).astype(np.float32)
    rq = rng.standard_normal((B, n, H, D)).astype(np.float32)
    # rv, rq stand in for the cotangents
    t_pv, t_nq, d_rv, d_rq = walk_the_index(ix, a_dst, a_src, rv, rq, rv, rq)
    tm = torch.from_numpy(mask)
    a, b, c, d = (torch.from_numpy(x) for x in (a_dst, a_src, rv, rq))
    for got, want in zip((t_pv, t_nq), ga.fused_factored_plain(a, b, c, d, tm)):
        np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-5)
    for got, want in zip((d_rv, d_rq), ga.fused_factored_bwd_plain(a, b, tm, c, d)):
        np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-5)


# ---- the autograd Functions -----------------------------------------------------

def test_gradcheck_in_f64(rng):
    n, B, H, C = 9, 2, 2, 3
    mask = torch.from_numpy(_mask(rng, n, "one_way"))
    f64 = lambda *s: torch.from_numpy(rng.standard_normal(s)).requires_grad_()  # noqa: E731
    a_dst, a_src = f64(B, n, H), f64(B, n, H)
    assert torch.autograd.gradcheck(
        lambda a, b, v: ga.fused_attention(a, b, v, mask, 0.2), (a_dst, a_src, f64(B, n, H, C)))
    # the gate is piecewise constant in a_dst and a_src: their numerical
    # gradient is 0 away from a sign change, and the Function returns none
    assert torch.autograd.gradcheck(
        lambda a, b, rv, rq: ga.fused_factored(a, b, rv, rq, mask),
        (a_dst, a_src, f64(B, n, H, C + 1), f64(B, n, H, C + 1)))


def test_wrappers_take_plain_versions_only_for_cpu_tensors(rng):
    n, B, H, C = 12, 2, 2, 4
    mask = torch.from_numpy(_mask(rng, n))
    a_dst, a_src = (torch.from_numpy(a) for a in _alphas(rng, B, n, H))
    v = torch.from_numpy(rng.standard_normal((B, n, H, C)).astype(np.float32))
    before = [w.launches for w in (ga.fused_attention_fwd, ga.fused_attention_bwd,
                                   ga.fused_factored_fwd, ga.fused_factored_bwd)]
    torch.testing.assert_close(ga.fused_attention_fwd(a_dst, a_src, v, mask),
                               ga.fused_attention_plain(a_dst, a_src, v, mask), rtol=0, atol=0)
    with plain_versions():
        ga.fused_factored_fwd(a_dst, a_src, v, v, mask)
    ga.fused_factored_bwd(a_dst, a_src, mask, v, v)
    ga.fused_attention_bwd(a_dst, a_src, v, mask, v)
    assert before == [w.launches for w in (ga.fused_attention_fwd, ga.fused_attention_bwd,
                                           ga.fused_factored_fwd, ga.fused_factored_bwd)]
    # the check every launch passes first refuses what the kernels do not take
    ix = ga.mask_index_of(mask)
    with pytest.raises(ValueError, match="unsupported device"):
        ga._check("fused_attention_fwd", a_dst, a_src, {"v": v}, ix)


# ---- GATConv on a dense graph against the JAX layer ------------------------------

def _jax_layer_run(layer, params, x, graph, g):
    out = layer.apply(params, x, graph)
    grads = jax.grad(lambda p, xx: jnp.sum(jnp.tanh(layer.apply(p, xx, graph)) * g),
                     argnums=(0, 1))(params, x)
    return np.asarray(out), grads


@pytest.mark.parametrize("impl,fused", [
    ("softmax", False), ("softmax", True), ("factored", False), ("factored", True),
    ("onepass", False),
])
@pytest.mark.parametrize("heads,concat", [(2, True), (1, False)])
def test_gatconv_dense_matches_jax_layer(rng, impl, fused, heads, concat):
    n, B, cin, C = 20, 2, 6, 4
    jt = random_graph(rng, n=n, extra_edges=12)
    jgraph = jt.batch(B)
    mask = np.asarray(jt.dense_operators()["adj_sl_mask"])
    if fused:
        op = (dict(fused_attn=make_fused_attention(mask, 0.2, interpret=True)) if impl == "softmax"
              else dict(fused_factored=make_fused_factored(mask, interpret=True)))
        jgraph = dataclasses.replace(jgraph, **op)
    x = rng.standard_normal((B * n, cin)).astype(np.float32)
    x[rng.permutation(B * n)[: B * n // 2]] = 0.0      # zeroed nodes, as a masked input has
    g = rng.standard_normal((B * n, heads * C if concat else C)).astype(np.float32)

    jlayer = jax_layers.GATConv(out_channels=C, heads=heads, concat=concat, attn_impl=impl)
    params = jlayer.init(jax.random.PRNGKey(5), jnp.asarray(x), jgraph)
    p = jax.tree.map(np.asarray, params)["params"]
    jout, (jgp, jgx) = _jax_layer_run(jlayer, params, jnp.asarray(x), jgraph, jnp.asarray(g))

    layer = GATConv(cin, C, heads=heads, concat=concat, attn_impl=impl)
    with torch.no_grad():
        layer.lin.weight.copy_(torch.from_numpy(p["w"].T.copy()))
        layer.att_src.copy_(torch.from_numpy(p["att_src"].copy()))
        layer.att_dst.copy_(torch.from_numpy(p["att_dst"].copy()))
        layer.bias.copy_(torch.from_numpy(p["bias"].copy()))
    graph = GraphTemplate(n, jt.senders, jt.receivers).batch(B, device="cpu")
    assert graph.dense and graph.adj_sl_index.n == n
    xt = torch.from_numpy(x).requires_grad_()
    out = layer(xt, graph)
    grads = torch.autograd.grad((torch.tanh(out) * torch.from_numpy(g)).sum(),
                                [xt, layer.lin.weight, layer.att_src, layer.att_dst, layer.bias])
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=1e-5, atol=1e-5)
    jp = jax.tree.map(np.asarray, jgp)["params"]
    refs = [np.asarray(jgx), jp["w"].T, jp["att_src"], jp["att_dst"], jp["bias"]]
    for got, want, name in zip(grads, refs, ("x", "w", "att_src", "att_dst", "bias")):
        np.testing.assert_allclose(got.numpy(), want, rtol=G_RTOL, atol=G_ATOL, err_msg=name)


def test_unported_attn_impl_raises():
    with pytest.raises(NotImplementedError, match="band_factored"):
        GATConv(4, 4, attn_impl="band_factored")
