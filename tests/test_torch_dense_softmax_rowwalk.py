"""PyTorch port: the dense softmax forward (``csrc/fused_attention.cu``) runs
v2's band row walk (``csrc/band_rowwalk.cuh``) on the band of one block (nB 1,
BLK = W = n, a_src as a_src_win [1, B, n, H], v as x_ext, the mask's
``MaskIndex`` as that band's ``BandIndex``), and the dense pair's bf16
instances (GATConv's ``attn_dtype=bfloat16`` with ``attn_impl="softmax"``).

A CUDA kernel cannot run here, so the walks are replayed in numpy on that
view of the index: the f32 forward by ``attention_replay`` of
``test_torch_band_rowlist.py`` (chunks of 32 entries, the running max and the
rescale past 32), held against ``fused_attention_plain`` (atol/rtol 1e-5)
and the JAX package's ``make_fused_attention`` (interpret mode, 1e-4), at the
shapes of ``test_torch_graph_attention.py`` on one-way masks with a third of
the nodes zeroed, so that a_dst + a_src == 0 (the >= side of the sign test)
occurs on set cells, and on rows of more than 32 entries.

The bf16 instances: the forward is v2's bf16 walk (the row's max, Z summed in
double and rounded once, the weights rounded to bf16, v read in bf16, the sum
not rounded); the backward v2's bf16 passes (the weights pass's p, the
columns pass on bf16 v and bf16 dO with bf16 p for d v) whose rows pass
rounds dp to bf16 before delta and dz. The layer's Function rounds the output
and d v to bf16. Those are where the JAX layer's XLA branch
(``gnn_pressure_estimation_tpu/models/layers.py``, the dense ``else``
branch) rounds: ``softmax(...).astype(bf16)``, ``xp.astype(bf16)``, a bf16
product whose output (and, in its VJP, dp and d xp) is bf16, accumulated in
f32 and rounded once. The replays are held against the bf16 plain versions
(1e-5) with v and dO on grids where every dp sum is exact in f32 in any
order, so the rounding of dp cannot land differently, and against
``jax.vjp`` of the JAX layer itself (identity projection, so xp = x) on
dyadic inputs: bit for bit where every sum is exact (uniform weights), else
within one bf16 step (2^-8 relative) on the rounded outputs and 1e-5 on the
f32 ones. Mutated replays (dp not rounded; the numerator rounded in place
of the normalised weight) must fail."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_pressure_estimation_tpu.models.layers import GATConv as JaxGATConv
from gnn_pressure_estimation_tpu.ops.pallas.graph_attention import make_fused_attention
from gnn_pressure_estimation_tpu_torch.ops import graph_attention as ga
from helpers import random_graph
from test_torch_band_rowlist import attention_replay
from test_torch_band_rowlist_bwd import F32, cells_pass, columns_pass, leaky, rows_pass
from test_torch_dense_softmax_band import _operands, one_block
from test_torch_graph_attention import SHAPES, _bhn, _mask

torch.set_num_threads(1)
PLAIN = dict(rtol=1e-5, atol=1e-5)
JAX_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_STEP = 2.0 ** -8          # a bf16 rounding that lands on the other side: one step


def _wide_mask(rng, n=70):
    """Rows and columns of more than 32 entries (the walk's streaming chunks,
    the bf16 walk's sweeps); one-way."""
    m = rng.random((n, n)) < 0.6
    np.fill_diagonal(m, True)
    assert int(m.sum(axis=1).max()) > 32 and not (m == m.T).all()
    return m


def bf16(a):
    """a rounded to bf16 (to nearest, ties to even), as f32."""
    return torch.from_numpy(np.ascontiguousarray(a, F32)).to(torch.bfloat16).float().numpy()


def _exp(a):
    """exp in f32 as the plain versions take it (torch's)."""
    return torch.from_numpy(np.ascontiguousarray(a, F32)).exp().numpy()


def forward_replay(mask, a_dst, a_src, v):
    """``csrc/fused_attention.cu`` in numpy: v2's row walk on the one-block
    view of the mask's index."""
    return attention_replay(one_block(ga.build_mask_index(mask)), a_dst, a_src[None], v, 0.2)


def _row_weights(view, a_dst, a_src, row):
    """The bf16 walks' softmax of one row: (its entries, exp(z − m), Z) with
    m the row's max and Z summed in double and rounded once."""
    ks = np.arange(view.row_ptr[row], view.row_ptr[row + 1])
    z = leaky(a_dst[:, row, None, :] + a_src[:, view.col[ks]])      # [B, cnt, H]
    e = _exp(z - z.max(axis=1, keepdims=True))
    return ks, e, e.astype(np.float64).sum(axis=1, keepdims=True).astype(F32)


def bf16_forward_replay(mask, a_dst, a_src, v, numerator=False):
    """The bf16 instance of ``csrc/fused_attention.cu`` (``bf16_rowwalk``):
    per row the weights bf16(exp(z − m) / Z), then acc += w · bf16(v) in list
    order (each product exact in f32, so one fmaf); out = acc, not rounded.
    ``numerator``: v4's instance instead, bf16(exp(z − m)) and out = acc / Z."""
    view = one_block(ga.build_mask_index(mask))
    vb = bf16(v)
    out = np.empty(v.shape, F32)
    for row in range(view.BLK):
        ks, e, Z = _row_weights(view, a_dst, a_src, row)
        w = bf16(e if numerator else e / Z)
        acc = np.zeros((v.shape[0],) + v.shape[2:], F32)
        for q, k in enumerate(ks):
            acc = acc + w[:, q, :, None] * vb[:, view.col[k]]
        out[:, row] = acc / Z[:, 0, :, None] if numerator else acc
    return out


def bf16_backward_replay(mask, a_dst, a_src, v, d_out, round_dp=True):
    """The bf16 instance of ``csrc/fused_attention_bwd.cu`` in numpy: the
    weights pass's f32 p; the columns pass on bf16 v and bf16 dO, with bf16 p
    for d v (the kernel rounds both as it reads them); the rows pass with dp
    rounded to bf16 (kRoundDp); the cells pass. (d a_dst, d a_src, d v), d v
    not rounded."""
    view = one_block(ga.build_mask_index(mask))
    B, n, H = a_dst.shape
    p = np.full((B, view.nnz, H), np.nan, F32)
    for row in range(n):
        ks, e, Z = _row_weights(view, a_dst, a_src, row)
        p[:, ks] = e / Z
    d_v, dp = columns_pass(view, bf16(v), bf16(d_out), bf16(p), {}, v.shape[-1] % 4 == 0)
    dz, d_ad = rows_pass(view, a_dst, a_src[None], p, bf16(dp) if round_dp else dp)
    return d_ad, cells_pass(view, dz, B, H)[0], d_v


def _grid(rng, shape, step, bound):
    """Values on the grid step·k in [−bound, bound]."""
    return (np.round(rng.uniform(-bound, bound, shape) / step) * step).astype(F32)


def _bf16_operands(rng, mask, B, H, C):
    """a_dst, a_src (a third of the nodes zeroed), and v, d_out off the bf16
    grid (multiples of 2^-11 within 1/4, up to 9 significant bits): their bf16
    roundings stay multiples of 2^-11, so each dp, a sum of at most 32
    products of them (multiples of 2^-22), is exact in f32 in any order
    (|dp| <= 2 < 2^24 · 2^-22)."""
    assert C <= 32
    a_dst, a_src, _, _ = _operands(rng, mask, B, H, C)
    v = _grid(rng, (B, mask.shape[0], H, C), 2.0 ** -11, 0.25)
    d_out = _grid(rng, (B, mask.shape[0], H, C), 2.0 ** -11, 0.25)
    assert not np.array_equal(bf16(v), v) and not np.array_equal(bf16(d_out), d_out)
    return a_dst, a_src, v, d_out


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---- the f32 forward on v2's row walk -------------------------------------------

@pytest.mark.parametrize("n,H,C,B", SHAPES)
def test_forward_replay_matches_plain(rng, n, H, C, B):
    mask = _mask(rng, n, "one_way")
    a_dst, a_src, v, _ = _operands(rng, mask, B, H, C)
    want = ga.fused_attention_plain(*_torch(a_dst, a_src, v, mask), 0.2).numpy()
    np.testing.assert_allclose(forward_replay(mask, a_dst, a_src, v), want,
                               err_msg=f"n{n} H{H} C{C} B{B}", **PLAIN)


@pytest.mark.parametrize("n,H,C,B", SHAPES)
def test_forward_replay_matches_pallas(rng, n, H, C, B):
    """Against make_fused_attention (interpret mode; layout [B, H, n, ·])."""
    mask = _mask(rng, n, "one_way")
    a_dst, a_src, v, _ = _operands(rng, mask, B, H, C)
    attend = make_fused_attention(mask, 0.2, interpret=True)
    ref = attend(jnp.asarray(a_dst), jnp.asarray(_bhn(a_src)), jnp.asarray(_bhn(v)))
    np.testing.assert_allclose(forward_replay(mask, a_dst, a_src, v), _bhn(np.asarray(ref)),
                               err_msg=f"n{n} H{H} C{C} B{B}", **JAX_TOL)


@pytest.mark.parametrize("H,C", [(2, 32), (3, 5)])
def test_forward_replay_on_rows_past_32_entries(rng, H, C):
    """The walk's running max and rescale at every chunk of 32 entries."""
    mask = _wide_mask(rng)
    a_dst, a_src, v, _ = _operands(rng, mask, 2, H, C)
    want = ga.fused_attention_plain(*_torch(a_dst, a_src, v, mask), 0.2).numpy()
    np.testing.assert_allclose(forward_replay(mask, a_dst, a_src, v), want, **PLAIN)


# ---- the bf16 instances against the plain versions ------------------------------

@pytest.mark.parametrize("n,H,C,B", SHAPES[::2])
def test_bf16_forward_replay_matches_plain(rng, n, H, C, B):
    """Random normal v (rounded by both); the sums are not rounded here."""
    mask = _mask(rng, n, "one_way")
    a_dst, a_src, v, _ = _operands(rng, mask, B, H, C)
    want = ga.fused_attention_plain(*_torch(a_dst, a_src, v, mask), 0.2, bf16=True).numpy()
    got = bf16_forward_replay(mask, a_dst, a_src, v)
    np.testing.assert_allclose(got, want, err_msg=f"n{n} H{H} C{C} B{B}", **PLAIN)
    f32 = forward_replay(mask, a_dst, a_src, v)
    assert np.abs(got - f32).max() >= 1e-3 * np.abs(want).max(), "the bf16 replay did not round"


@pytest.mark.parametrize("n,H,C,B", SHAPES[1::2])
def test_bf16_backward_replay_matches_plain(rng, n, H, C, B):
    mask = _mask(rng, n, "one_way")
    args = _bf16_operands(rng, mask, B, H, C)
    got = bf16_backward_replay(mask, *args)
    ref = ga.fused_attention_bwd_plain(*_torch(*args[:3], mask, args[3]), 0.2, bf16=True)
    f32 = ga.fused_attention_bwd_plain(*_torch(*args[:3], mask, args[3]), 0.2)
    for name, g, r, r32 in zip(("d a_dst", "d a_src", "d v"), got, ref, f32):
        np.testing.assert_allclose(g, r.numpy(), err_msg=f"n{n} H{H} C{C} B{B} {name}", **PLAIN)
        assert np.abs(g - r32.numpy()).max() >= 1e-3 * np.abs(r.numpy()).max(), name


def test_bf16_replays_on_rows_past_32_entries(rng):
    """The bf16 walk's sweeps (m, then Z, before any product) on a longer
    list; the backward's columns of more than 32 entries."""
    mask = _wide_mask(rng)
    a_dst, a_src, v, d_out = _bf16_operands(rng, mask, 2, 2, 32)
    ts = _torch(a_dst, a_src, v, mask)
    np.testing.assert_allclose(bf16_forward_replay(mask, a_dst, a_src, v),
                               ga.fused_attention_plain(*ts, 0.2, bf16=True).numpy(), **PLAIN)
    for g, r in zip(bf16_backward_replay(mask, a_dst, a_src, v, d_out),
                    ga.fused_attention_bwd_plain(*ts, torch.from_numpy(d_out), 0.2, bf16=True)):
        np.testing.assert_allclose(g, r.numpy(), **PLAIN)


def test_mutated_bf16_replays_fail(rng):
    """dp left unrounded, or the numerator exp(z − m) rounded in place of the
    normalised weight (v4's bf16 instance): the checks above must see
    either."""
    mask = _wide_mask(rng)
    a_dst, a_src, v, d_out = _bf16_operands(rng, mask, 2, 2, 32)
    ts = _torch(a_dst, a_src, v, mask)
    ref = ga.fused_attention_bwd_plain(*ts, torch.from_numpy(d_out), 0.2, bf16=True)
    got = bf16_backward_replay(mask, a_dst, a_src, v, d_out, round_dp=False)
    assert not all(np.allclose(g, r.numpy(), **PLAIN) for g, r in zip(got[:2], ref[:2]))
    got = bf16_forward_replay(mask, a_dst, a_src, v, numerator=True)
    assert not np.allclose(got, ga.fused_attention_plain(*ts, 0.2, bf16=True).numpy(), **PLAIN)


def test_bf16_wrappers_on_the_cpu_round_f32_v_once_and_refuse_bf16_v_in_f32(rng):
    """bf16=True takes f32 v (rounded once) or the Function's bf16 copy alike;
    a bf16 v to the f32 instance raises; the CPU runs the plain versions and
    counts no launch."""
    mask = _mask(rng, 26, "one_way")
    a_dst, a_src, v, d_out = (torch.from_numpy(a) for a in _operands(rng, mask, 2, 2, 4))
    mk = torch.from_numpy(mask)
    before = [ga.fused_attention_fwd.launches_bf16, ga.fused_attention_bwd.launches_bf16]
    vb = v.to(torch.bfloat16)
    assert torch.equal(ga.fused_attention_fwd(a_dst, a_src, v, mk, bf16=True),
                       ga.fused_attention_fwd(a_dst, a_src, vb, mk, bf16=True))
    for a, b in zip(ga.fused_attention_bwd(a_dst, a_src, v, mk, d_out, bf16=True),
                    ga.fused_attention_bwd(a_dst, a_src, vb, mk, d_out, bf16=True)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="bf16=True"):
        ga.fused_attention_fwd(a_dst, a_src, vb, mk)
    with pytest.raises(ValueError, match="bf16=True"):
        ga.fused_attention_bwd(a_dst, a_src, vb, mk, d_out)
    assert before == [ga.fused_attention_fwd.launches_bf16, ga.fused_attention_bwd.launches_bf16]


# ---- against the JAX layer's XLA branch --------------------------------------------

def _jax_layer(rng, n, H, C, B, uniform):
    """The JAX GATConv on a dense batch of a random graph with ``w`` the
    identity (xp = x, in_channels H·C), attention vectors on a dyadic grid
    (zero when ``uniform``: every logit 0, so p = 1/deg), x on 2^-3 up to 1
    and the cotangent on 2^-12 up to 1/8 (off the bf16 grid): the logit
    halves are exact in f32, and so is every sum of the forward and of d xp
    when the weights are uniform. Returns (mask, x, g, params, out, the VJP's
    d x, d att_src, d att_dst)."""
    jt = random_graph(rng, n=n, extra_edges=n // 2)
    jg = jt.batch(B, mode="dense")
    assert jg.dense and jg.fused_attn is None
    mask = np.asarray(jg.adj_sl_mask, bool)
    HC = H * C
    x = _grid(rng, (B * n, HC), 2.0 ** -3, 1.0)
    g = _grid(rng, (B * n, HC), 2.0 ** -12, 0.125)
    jl = JaxGATConv(out_channels=C, heads=H, concat=True, attn_impl="softmax",
                    attn_dtype=jnp.bfloat16)
    params = jax.tree.map(np.asarray, jl.init(jax.random.PRNGKey(0), jnp.asarray(x), jg))["params"]
    att = (lambda s: np.zeros(s, F32)) if uniform else (lambda s: _grid(rng, s, 2.0 ** -4, 0.5))
    params = {"w": np.eye(HC, dtype=F32), "att_src": att((1, H, C)), "att_dst": att((1, H, C)),
              "bias": np.zeros(HC, F32)}
    jp = {"params": jax.tree.map(jnp.asarray, params)}
    out, vjp = jax.vjp(lambda p, xx: jl.apply(p, xx, jg), jp, jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(g))
    return (mask, x, g, params, np.asarray(out), np.asarray(gx),
            np.asarray(gp["params"]["att_src"]), np.asarray(gp["params"]["att_dst"]))


def _replayed_layer(mask, x, g, params, B, H, C):
    """The port's layer on the same operands, its ops replayed: the logit
    halves, the bf16 forward and backward replays, the Function's roundings
    (output, d v), and the chain back to x and the attention vectors."""
    n = mask.shape[0]
    xp = x.reshape(B, n, H, C)
    a_s = (xp * params["att_src"]).sum(-1, dtype=F32)
    a_d = (xp * params["att_dst"]).sum(-1, dtype=F32)
    out = bf16(bf16_forward_replay(mask, a_d, a_s, xp)).reshape(B * n, H * C)
    d_ad, d_as, d_v = bf16_backward_replay(mask, a_d, a_s, xp, g.reshape(B, n, H, C))
    d_xp = bf16(d_v)
    d_x = d_xp + d_as[..., None] * params["att_src"] + d_ad[..., None] * params["att_dst"]
    d_att_src = (d_as[..., None] * xp).sum(axis=(0, 1))[None]
    d_att_dst = (d_ad[..., None] * xp).sum(axis=(0, 1))[None]
    return out, d_x.reshape(B * n, H * C), d_att_src, d_att_dst, d_xp.reshape(B * n, H * C)


@pytest.mark.parametrize("n,H,C,B", [(26, 2, 8, 2)])
def test_bf16_replays_are_the_jax_layer_bit_for_bit_on_uniform_weights(rng, n, H, C, B):
    """Every logit 0: p = 1/deg, rounded alike by both, and every sum of the
    forward and of d xp exact, so the rounded output and d x equal the JAX
    layer's to the bit (the attention vectors are 0, so no gradient reaches
    x through the logit halves)."""
    mask, x, g, params, out, gx, _, _ = _jax_layer(rng, n, H, C, B, uniform=True)
    got_out, got_dx, _, _, _ = _replayed_layer(mask, x, g, params, B, H, C)
    assert np.array_equal(got_out, out)
    assert np.array_equal(got_dx, gx)


@pytest.mark.parametrize("n,H,C,B", [(26, 2, 8, 2), (26, 3, 4, 2)])
def test_bf16_replays_match_the_jax_layer_vjp(rng, n, H, C, B):
    """Random (dyadic) attention vectors: the weights' sums are not exact,
    so a rounded output or d xp may land one bf16 step (2^-8 relative) from
    the JAX value where the two f32 sums differ in their last bit (at most 1%
    of the values); besides those steps, d x (d xp plus the f32 chain
    through the logit halves) and the gradients of the attention vectors
    within 1e-5 + 1e-5·max|ref|."""
    mask, x, g, params, out, gx, gs, gd = _jax_layer(rng, n, H, C, B, uniform=False)
    got_out, got_dx, got_s, got_d, got_dxp = _replayed_layer(mask, x, g, params, B, H, C)
    for name, a, r, rounded in (("out", got_out, out, got_out), ("d x", got_dx, gx, got_dxp)):
        err = np.abs(a - r)
        fine = 1e-5 + 1e-5 * float(np.abs(r).max())
        assert (err <= BF16_STEP * np.abs(rounded) + fine).all(), f"{name}: {err.max():.3e}"
        assert (err > fine).mean() <= 0.01, f"{name}: {(err > fine).sum()} values a step off"
    for name, a, r in (("d att_src", got_s, gs), ("d att_dst", got_d, gd)):
        top = float(np.abs(r).max())
        assert float(np.abs(a - r).max()) <= 1e-5 + 1e-5 * top, name
