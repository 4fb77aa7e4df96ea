"""PyTorch port: the zoo's conv layers against the JAX layers, in the dense,
banded (BLK 16 on a 70-node graph: five blocks, halos on both sides) and
degree-padded modes.

The same numpy-seeded inputs, cotangent and flax-initialised weights
(carried across by ``weights.params_from_flax``) go through the JAX layer
and the port's; the forward, the input gradients and every parameter
gradient are held to atol 1e-5 and rtol 1e-4. On the JAX side these widths
take the plain XLA band path (the band SpMM kernel wants C % 128 == 0); the
port's banded path runs ``ops.band_spmm`` over the count bands and scales
(its plain version here), so the sums run in another order. ``ops.segment``
(m_GCN's gathers and receiver sums) is also checked to repeat to the bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_pressure_estimation_tpu.models import layers as jl
from gnn_pressure_estimation_tpu_torch.core.graph import GraphTemplate
from gnn_pressure_estimation_tpu_torch.models import layers as pl
from gnn_pressure_estimation_tpu_torch.ops import segment
from gnn_pressure_estimation_tpu_torch.weights import params_from_flax
from helpers import random_graph

torch.set_num_threads(1)
MODES = ("dense", "banded", "padded")
ATOL, RTOL = 1e-5, 1e-4
B, BLK = 2, 16


@pytest.fixture(scope="module")
def graphs():
    rng = np.random.default_rng(7)
    jt = random_graph(rng, n=70, extra_edges=40, edge_dim=2)
    pt = GraphTemplate(jt.n_node, jt.senders, jt.receivers, edge_attr=jt.edge_attr)
    out = {}
    for mode in MODES:
        blk = BLK if mode == "banded" else None
        jg, pg = jt.batch(B, mode=mode, band_block=blk), pt.batch(B, mode=mode, band_block=blk,
                                                                  device="cpu")
        if mode == "banded":
            assert len(jg.band_win_start) == 5 and pg.band_U > 0 and pg.band_R > 0
        out[mode] = (jg, pg)
    return out


def _state(tree, pmod) -> dict:
    """A layer's flax tree → the port layer's ``state_dict``, by the
    layer's own flax names."""
    return params_from_flax(tree["params"], pmod)


def _check(name, got, ref):
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL, rtol=RTOL, err_msg=name)


def _run(jmod, pmod, jg, pg, inputs, call_j, call_p, rng):
    """Init the JAX layer, load its weights into the port's, and hold the
    forward and the gradients of ``sum(out · cot)`` (inputs and parameters)."""
    params = jmod.init(jax.random.PRNGKey(3), *call_j(jg, *map(jnp.asarray, inputs)))
    pmod.load_state_dict(_state(params, pmod))
    ref = jmod.apply(params, *call_j(jg, *map(jnp.asarray, inputs)))
    cot = rng.standard_normal(ref.shape).astype(np.float32)

    def loss(p, *xs):
        return jnp.sum(jmod.apply(p, *call_j(jg, *xs)) * cot)

    jgrads = jax.grad(loss, argnums=tuple(range(len(inputs) + 1)))(
        params, *map(jnp.asarray, inputs))
    txs = [torch.tensor(a, requires_grad=True) for a in inputs]
    out = pmod(*call_p(pg, *txs))
    _check("forward", out.detach().numpy(), ref)
    (out * torch.from_numpy(cot)).sum().backward()
    for i, t in enumerate(txs):
        _check(f"d input {i}", t.grad.numpy(), jgrads[i + 1])
    ref_p = _state(jax.tree.map(np.asarray, jgrads[0]), pmod)
    for k, p in pmod.named_parameters():
        _check(f"d {k}", p.grad.numpy(), ref_p[k])


def _x(rng, pg, c):
    return rng.standard_normal((pg.n_node, c)).astype(np.float32)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("normalize", [True, False])
def test_gcnconv(graphs, mode, normalize):
    """GCNConv, both ``normalize`` cases (the remask stack's stem takes the
    plain sum), 5 → 6 channels; atol 1e-5, rtol 1e-4."""
    rng = np.random.default_rng(1)
    jg, pg = graphs[mode]
    _run(jl.GCNConv(6, normalize=normalize), pl.GCNConv(5, 6, normalize=normalize),
         jg, pg, [_x(rng, pg, 5)], lambda g, x: (x, g), lambda g, x: (x, g), rng)


@pytest.mark.parametrize("mode", MODES)
def test_gcn2conv(graphs, mode):
    """GCN2Conv at layer 3 (β = log(θ/3 + 1)), 8 channels, gradients to x
    and x0; atol 1e-5, rtol 1e-4."""
    rng = np.random.default_rng(2)
    jg, pg = graphs[mode]
    _run(jl.GCN2Conv(8, layer_index=3), pl.GCN2Conv(8, layer_index=3),
         jg, pg, [_x(rng, pg, 8), _x(rng, pg, 8)], lambda g, x, x0: (x, x0, g),
         lambda g, x, x0: (x, x0, g), rng)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("K", [1, 3, 12])
def test_chebconv(graphs, mode, K):
    """ChebConv at K 1, 3 (unrolled in the JAX layer) and 12 (its
    ``lax.scan``), 4 → 5 channels, with bias; atol 1e-5, rtol 1e-4."""
    rng = np.random.default_rng(3)
    jg, pg = graphs[mode]
    _run(jl.ChebConv(5, K=K), pl.ChebConv(4, 5, K=K), jg, pg,
         [_x(rng, pg, 4)], lambda g, x: (x, g), lambda g, x: (x, g), rng)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("head", ["mlp", "linear"])
def test_ginconv(graphs, mode, head):
    """GINConv with the SELU MLP (3 → 4 → 8) and with the bias-free linear
    head (3 → 1); atol 1e-5, rtol 1e-4."""
    rng = np.random.default_rng(4)
    jg, pg = graphs[mode]
    kw = {"mlp_dims": (4, 8)} if head == "mlp" else {"linear_out": 1}
    _run(jl.GINConv(**kw), pl.GINConv(3, **kw), jg, pg,
         [_x(rng, pg, 3)], lambda g, x: (x, g), lambda g, x: (x, g), rng)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("edge_emb", [True, False])
@pytest.mark.parametrize("mlp", [True, False])
def test_genconv(graphs, mode, edge_emb, mlp):
    """GENConv, latent 6, with and without edge embeddings, with and without
    its MLP (m_GCN's multi-hop passes); gradients to x and the edge
    embeddings; atol 1e-5, rtol 1e-4."""
    rng = np.random.default_rng(5)
    jg, pg = graphs[mode]
    x = _x(rng, pg, 6)
    E = int(pg.edges.senders.shape[0])
    inputs = [x] + ([rng.standard_normal((E, 6)).astype(np.float32)] if edge_emb else [])

    def call(g, x_, e=None):
        return (x_, g, e) if edge_emb else (x_, g, None)

    class JaxHarness(jl.nn.Module):               # the GENConv as m_GCN names it
        with_mlp: bool

        @jl.nn.compact
        def __call__(self, x_, g, e):
            return jl.GENConv(6, name="gcn_0")(x_, g, e, mlp=self.with_mlp)

    class PortHarness(torch.nn.Module):
        FLAX_NAMES = {"gcn": "gcn_{}"}

        def __init__(self):
            super().__init__()
            self.gcn = torch.nn.ModuleList([pl.GENConv(6, edge_emb=edge_emb)])

        def forward(self, x_, g, e):
            return self.gcn[0](x_, g, e, mlp=mlp)

    # initialised with the MLP (the JAX layer builds it on the call that runs
    # it), applied with or without
    params = JaxHarness(True).init(jax.random.PRNGKey(3), *call(jg, *map(jnp.asarray, inputs)))
    jmod, pmod = JaxHarness(mlp), PortHarness()
    pmod.load_state_dict(params_from_flax(params, pmod))
    ref = jmod.apply(params, *call(jg, *map(jnp.asarray, inputs)))
    cot = rng.standard_normal(ref.shape).astype(np.float32)
    jgrads = jax.grad(lambda p, *xs: jnp.sum(jmod.apply(p, *call(jg, *xs)) * cot),
                      argnums=tuple(range(len(inputs) + 1)))(params, *map(jnp.asarray, inputs))
    txs = [torch.tensor(a, requires_grad=True) for a in inputs]
    out = pmod(*call(pg, *txs))
    _check("forward", out.detach().numpy(), ref)
    (out * torch.from_numpy(cot)).sum().backward()
    for i, t in enumerate(txs):
        _check(f"d input {i}", t.grad.numpy(), jgrads[i + 1])
    ref_p = params_from_flax(jax.tree.map(np.asarray, jgrads[0]), pmod)
    for k, p in pmod.named_parameters():
        if p.grad is None:              # the MLP, unused without it
            assert not mlp and ".mlp." in k
            continue
        _check(f"d {k}", p.grad.numpy(), ref_p[k])


def test_mlp():
    """MLP 5 → 7 → 7 → 3 (SELU between), with and without biases, and its
    initialiser's bound, U(±1/√fan_in); atol 1e-5, rtol 1e-4. It takes no
    graph, so one mode covers it."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((40, 5)).astype(np.float32)
    for use_bias in (True, False):
        jmod = jl.MLP((7, 7, 3), use_bias=use_bias)
        params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
        pmod = pl.MLP(5, (7, 7, 3), use_bias=use_bias)
        pmod.load_state_dict(_state(params, pmod))
        ref = jmod.apply(params, jnp.asarray(x))
        cot = rng.standard_normal(ref.shape).astype(np.float32)
        jgx, = jax.grad(lambda x_: jnp.sum(jmod.apply(params, x_) * cot), argnums=(0,))(
            jnp.asarray(x))
        tx = torch.tensor(x, requires_grad=True)
        out = pmod(tx)
        _check("forward", out.detach().numpy(), ref)
        (out * torch.from_numpy(cot)).sum().backward()
        _check("d x", tx.grad.numpy(), jgx)
    big = pl.MLP(400, (300,))
    big.reset_parameters(torch.Generator().manual_seed(0))
    w = big.layers[0].weight.detach()
    assert float(w.abs().max()) <= 1 / 20 and float(w.abs().max()) > 0.95 / 20
    assert float(big.layers[0].bias.detach().abs().max()) == 0.0


@pytest.mark.parametrize("mode", MODES)
def test_aggregations_match_dense_operators(graphs, mode):
    """Each parameter-free aggregation of the port (``adj``, ``mean``,
    ``gcn``, ``cheb``) equals the dense template operator's product in every
    mode, in the original node order (atol 1e-5): the count bands and their
    factored scales, and the padded slot weights, are the operators."""
    rng = np.random.default_rng(8)
    _, pg = graphs[mode]
    dense = graphs["dense"][1]
    n = dense.nodes_per_graph
    x = torch.from_numpy(rng.standard_normal((B * n, 3)).astype(np.float32))
    for kind in ("adj", "mean", "gcn", "cheb"):
        ref = pl._aggregate(kind, x, dense)
        if mode == "banded":
            got = pg.unpack_nodes(pl._aggregate(kind, pg.pack_nodes(x, n), pg), n)
        else:
            got = pl._aggregate(kind, x, pg)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL, err_msg=kind)


@pytest.mark.parametrize("mode", MODES)
def test_segment_ops_repeat_to_the_bit(graphs, mode):
    """``segment_sum`` and the gathers' backward (the receiver and sender
    sums over the slot tables) give bit-equal results called twice, and equal
    ``index_add_`` within rounding."""
    rng = np.random.default_rng(9)
    _, pg = graphs[mode]
    e = pg.edges
    E = int(e.senders.shape[0])
    data = torch.from_numpy(rng.standard_normal((E, 5)).astype(np.float32))
    a, b = segment.segment_sum(data, e), segment.segment_sum(data, e)
    assert torch.equal(a, b)
    ref = torch.zeros(pg.n_node, 5).index_add_(0, e.receivers, data)
    np.testing.assert_allclose(a.numpy(), ref.numpy(), atol=1e-5)
    x = torch.from_numpy(rng.standard_normal((pg.n_node, 5)).astype(np.float32))
    for fn, idx in ((segment.gather, e.receivers), (segment.gather_src, e.senders)):
        grads = []
        for _ in range(2):
            xt = x.clone().requires_grad_(True)
            (fn(xt, e) * data).sum().backward()
            grads.append(xt.grad)
        assert torch.equal(grads[0], grads[1])
        assert torch.equal(fn(x, e), x[idx])
        ref = torch.zeros(pg.n_node, 5).index_add_(0, idx, data)
        np.testing.assert_allclose(grads[0].numpy(), ref.numpy(), atol=1e-5)
