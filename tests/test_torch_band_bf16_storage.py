"""PyTorch port: the extended rows of the bf16-operand band forwards stored in
bfloat16 (``attn_dtype`` bf16 on the "dma", "flash" and "acc" routes).

The glue writes x_ext once as bf16 from the f32 projected rows inside the
autograd Function, so no f32 x_ext is built for the attention; the
backward reads the saved rows and returns f32 gradients. Each x is the
float that rounding on load gave (the round-on-load path: f32 x_ext, each
element rounded as the product reads it), so a layer and a model through the stored
rows equal that path bit for bit on the real rows, gradients included. Only
rows with no set column (padded band rows, which feed no real row) change:
they are now the window mean of the bf16 rows. The reference below is that
round-on-load path, written out here: f32 x_ext, the weights and rows
rounded in the product, the padded rows' mean of the f32 rows, and the
package's backward plain versions given those f32 rows."""

import sys

import numpy as np
import pytest
import torch

from gnn_pressure_estimation_tpu_torch.core.graph import GraphTemplate
from gnn_pressure_estimation_tpu_torch.models import layers
from gnn_pressure_estimation_tpu_torch.models.gatres import GATRes
from gnn_pressure_estimation_tpu_torch.models.layers import GATConv
from gnn_pressure_estimation_tpu_torch.ops import band_attention as pba
from gnn_pressure_estimation_tpu_torch.ops import banded as bops
from helpers import random_graph

torch.set_num_threads(1)
ROUTES = ("dma", "flash", "acc")


def _mask(rng, nB=3, BLK=8, W=24, density=0.3):
    m = rng.random((nB, BLK, W)) < density
    m[-1, -3:] = False                                  # padded rows: no set column
    return torch.as_tensor(m)


def _operands(rng, mask, B, H, C):
    nB, BLK, W = mask.shape
    n_pad, n_ext = nB * BLK, nB * BLK + W - BLK
    a_dst = torch.as_tensor(rng.standard_normal((B, n_pad, H)), dtype=torch.float32)
    a_src = torch.as_tensor(rng.standard_normal((nB, B, W, H)), dtype=torch.float32)
    x_ext = torch.as_tensor(rng.standard_normal((B, n_ext, H, C)), dtype=torch.float32)
    return a_dst, a_src, x_ext


# ---- the glue --------------------------------------------------------------------------

@pytest.mark.parametrize("U,R", [(5, 3), (0, 4), (6, 0), (0, 0)])
def test_extend_rows_bf16_is_rounded_extend_rows(rng, U, R):
    x = torch.as_tensor(rng.standard_normal((2, 16, 2, 8)), dtype=torch.float32)
    got = bops.extend_rows_bf16(x, U, R)
    assert got.dtype == torch.bfloat16 and got.shape == (2, U + 16 + R, 2, 8)
    want = bops.extend_rows(x, U, R).to(torch.bfloat16)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert not got[:, :U].any() and not got[:, U + 16:].any()
    assert torch.equal(got[:, U:U + 16].float(), pba.round_bf16(x))


def test_vector_loads_rule_for_bf16_rows():
    """bf16 rows load 4 channels of one head as an 8-byte quad where f32 rows
    load a float4: the same rule, C % 4 == 0 on 16-byte aligned data."""
    for C, want in ((4, True), (12, True), (6, False), (3, False)):
        for dt in (torch.bfloat16, torch.float32):
            x = torch.zeros((1, 4, 3, C), dtype=dt)
            assert bops.vector_loads(x, C) is want
    x = torch.zeros(1 + 4 * 3 * 4, dtype=torch.bfloat16)[1:].view(1, 4, 3, 4)
    assert not bops.vector_loads(x, 4)                                 # 2 bytes off


# ---- the forward wrappers and plain versions --------------------------------------------

@pytest.mark.parametrize("flash", [False, True])
def test_forward_of_f32_rows_rounds_them_once(rng, flash):
    """Given f32 rows under mxu_bf16 the wrapper rounds them once and runs
    the same function as on the stored bf16 rows: equal on every row."""
    mask = _mask(rng)
    a_dst, a_src, x_ext = _operands(rng, mask, 2, 2, 8)
    fwd = pba.band_attention_flash_fwd if flash else pba.band_attention_fwd
    got = fwd(a_dst, a_src, x_ext.to(torch.bfloat16), mask, 0.2, None, True)
    ref = fwd(a_dst, a_src, x_ext, mask, 0.2, None, True)
    for g, r in zip(got if flash else (got,), ref if flash else (ref,)):
        assert g.dtype == torch.float32 and torch.equal(g, r)


@pytest.mark.parametrize("flash", [False, True])
def test_padded_rows_are_the_mean_of_the_bf16_rows(rng, flash):
    mask = _mask(rng)
    nB, BLK, W = mask.shape
    a_dst, a_src, x_ext = _operands(rng, mask, 2, 1, 8)
    xb = x_ext.to(torch.bfloat16)
    fwd = pba.band_attention_flash_plain if flash else pba.band_attention_plain
    out = fwd(a_dst, a_src, xb, mask, 0.2, True)
    out = out[0] if flash else out
    empty = ~mask.any(dim=2).reshape(-1)
    assert int(empty.sum()) == 3
    blk = nB - 1
    mean = xb[:, blk * BLK: blk * BLK + W].float().mean(dim=1)          # [B, H, C]
    for r in torch.nonzero(empty)[:, 0]:
        torch.testing.assert_close(out[:, r], mean, atol=1e-6, rtol=1e-6)
        assert not torch.allclose(out[:, r], x_ext[:, blk * BLK: blk * BLK + W].mean(dim=1),
                                  atol=1e-6, rtol=0)


@pytest.mark.parametrize("fn", ["band_attention_fwd", "band_attention_flash_fwd",
                                "band_attention_plain", "band_attention"])
def test_bf16_rows_without_mxu_bf16_raise(rng, fn):
    mask = _mask(rng)
    a_dst, a_src, x_ext = _operands(rng, mask, 1, 1, 8)
    with pytest.raises(ValueError, match="bfloat16"):
        getattr(pba, fn)(a_dst, a_src, x_ext.to(torch.bfloat16), mask, 0.2)


@pytest.mark.parametrize("fn", ["band_attention_fwd", "band_attention_flash_fwd"])
@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_kernel_path_refuses_rows_of_another_dtype(rng, monkeypatch, fn, dtype):
    """On the kernel's path the check holds x_ext to the instance's dtype (f32
    without mxu_bf16), not to its own: the C entry reads the rows as f32 or
    bf16 and nothing else. f32 rows pass it and stop at the device check."""
    monkeypatch.setattr(bops, "use_plain", lambda t: False)
    mask = _mask(rng)
    a_dst, a_src, x_ext = _operands(rng, mask, 1, 1, 8)
    with pytest.raises(ValueError, match="x must be contiguous torch.float32"):
        getattr(pba, fn)(a_dst, a_src, x_ext.to(dtype), mask, 0.2)
    with pytest.raises(ValueError, match="unsupported device"):
        getattr(pba, fn)(a_dst, a_src, x_ext, mask, 0.2)
    with pytest.raises(ValueError, match="unsupported device"):
        getattr(pba, fn)(a_dst, a_src, x_ext.to(dtype), mask, 0.2, None, True)


@pytest.mark.parametrize("route", ROUTES)
def test_function_saves_bf16_rows_and_returns_f32_gradients(rng, route):
    mask = _mask(rng)
    nB, BLK, W = mask.shape
    U, R = 5, W - 5 - BLK
    a_dst, a_src, _ = _operands(rng, mask, 2, 2, 8)
    xp = torch.as_tensor(rng.standard_normal((2, nB * BLK, 2, 8)), dtype=torch.float32)
    xp.requires_grad_()
    out = layers.BAND_ATTEND[route](a_dst, a_src, xp, mask, 0.2, None, True, (U, R))
    saved = [t for t in out.grad_fn.saved_tensors if t.dim() == 4 and t.shape[1] == U + nB * BLK + R]
    assert len(saved) == 1 and saved[0].dtype == torch.bfloat16
    assert torch.equal(saved[0], bops.extend_rows_bf16(xp.detach(), U, R))
    (g,) = torch.autograd.grad(out.square().sum(), [xp])
    assert g.dtype == torch.float32 and g.shape == xp.shape


# ---- the round-on-load reference ---------------------------------------------------------

class _RoundOnLoad(torch.autograd.Function):
    """The round-on-load band attention under mxu_bf16: f32 x_ext; forward Σ bf16(w)
    bf16(x) (v2/v3: w = p normalised; v4: w = exp(z − m), then / Z), padded
    rows the f32 window mean; the f32-row backward plain versions."""

    @staticmethod
    def forward(ctx, a_dst, a_src_win, x_ext, mask, route):
        nB, BLK, W = mask.shape
        x_win = bops.band_windows_ext(x_ext, nB, BLK, W)
        z, _, on = pba._logits(a_dst, a_src_win, mask, 0.2)
        e, Z, real = pba._bf16_weights(z, on)
        w = e if route == "flash" else e / Z
        eq = "nbiwh,nbwhc->nbihc"
        out = torch.einsum(eq, torch.where(real, pba.round_bf16(w), 0.0), pba.round_bf16(x_win))
        out = out + torch.einsum(eq, torch.where(real, 0.0, w), x_win)
        if route == "flash":
            out = out / Z[:, :, :, 0, :, None]
        B = x_ext.shape[0]
        out = pba._rows_of(out, B, nB, BLK)
        m = pba._rows_of(z.amax(dim=3), B, nB, BLK)
        ctx.save_for_backward(a_dst, a_src_win, x_ext, mask, m, pba._rows_of(Z[:, :, :, 0], B, nB, BLK),
                              out)
        ctx.route = route
        return out

    @staticmethod
    def backward(ctx, d_out):
        a_dst, a_src_win, x_ext, mask, m, Z, out = ctx.saved_tensors
        if ctx.route == "flash":
            delta = (d_out * out).sum(dim=-1)
            grads = pba.band_attention_flash_bwd_plain(a_dst, a_src_win, x_ext, mask, m, Z, delta,
                                                       d_out, 0.2, True)
        else:
            grads = pba.band_attention_bwd_plain(a_dst, a_src_win, x_ext, mask, d_out, 0.2, True)
        return (*grads, None, None)


def _round_on_load_attend(route):
    """The route's attention with the bf16-operand instance replaced by the
    reference (f32 x_ext through ``torch.cat``, as the layer built it)."""
    f32_attend = layers.BAND_ATTEND[route]

    def attend(a_dst, a_src_win, xp_b, mask, slope, index, halo, mxu_bf16):
        if not mxu_bf16:
            return f32_attend(a_dst, a_src_win, xp_b, mask, slope, index, halo=halo)
        return _RoundOnLoad.apply(a_dst, a_src_win, bops.extend_rows(xp_b, *halo), mask, route)
    return attend


def _graph(route, B=2, n=45, block=8):
    jt = random_graph(np.random.default_rng(5), n=n, extra_edges=25)
    tpl = GraphTemplate(n, jt.senders, jt.receivers)
    return tpl, tpl.batch(B, "banded", block, "cpu", band_attn=route)


def _forward_and_grads(model, g, x, w):
    xin = x.clone().requires_grad_()
    out = model(xin, g)
    grads = torch.autograd.grad((out * w).sum(), [xin, *model.parameters()])
    return out.detach(), grads


def _both(monkeypatch, route, make, x, w, g):
    """The model's output and gradients through the stored bf16 rows, then
    through the round-on-load reference."""
    model = make()
    got = _forward_and_grads(model, g, x, w)
    with monkeypatch.context() as mp:
        mp.setitem(layers.BAND_ATTEND, route, _round_on_load_attend(route))
        ref = _forward_and_grads(model, g, x, w)
    return got, ref


def _assert_bit_equal(got, ref, real, what):
    (out, grads), (rout, rgrads) = got, ref
    assert torch.equal(out[real], rout[real]), f"{what}: output"
    assert not torch.equal(out, rout), f"{what}: the padded rows should differ"
    for k, (a, b) in enumerate(zip(grads, rgrads)):
        assert a.dtype == torch.float32, f"{what}: gradient {k} is {a.dtype}"
        assert torch.equal(a, b), f"{what}: gradient {k} off by {float((a - b).abs().max()):.3e}"


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("H,C", [(2, 64), (1, 128)])
def test_gatconv_stored_rows_equal_round_on_load(rng, monkeypatch, route, H, C):
    tpl, g = _graph(route)
    n, cin = tpl.n_node, 6
    x = g.pack_nodes(torch.as_tensor(rng.standard_normal((2 * n, cin)), dtype=torch.float32), n)
    w = g.pack_nodes(torch.as_tensor(rng.standard_normal((2 * n, H * C if H == 2 else C)),
                                     dtype=torch.float32), n)

    def make():
        torch.manual_seed(0)
        layer = GATConv(cin, C, heads=H, concat=H == 2, attn_dtype=torch.bfloat16)
        with torch.no_grad():
            layer.bias.normal_()
        return layer
    real = g.pack_nodes(torch.ones(2 * n, 1, dtype=torch.bool), n)[:, 0]
    _assert_bit_equal(*_both(monkeypatch, route, make, x, w, g), real, f"GATConv {route}")


@pytest.mark.parametrize("route", ROUTES)
def test_gatres_two_blocks_stored_rows_equal_round_on_load(rng, monkeypatch, route):
    """Two blocks at nc 64: conv1 (H·C 128) takes the bf16 instance, conv2
    (64) the f32 one; the second block reads the first's output, whose
    padded rows differ between the two paths."""
    tpl, g = _graph(route)
    n = tpl.n_node
    x = g.pack_nodes(torch.as_tensor(rng.standard_normal((2 * n, 1)), dtype=torch.float32), n)
    w = g.pack_nodes(torch.as_tensor(rng.standard_normal((2 * n, 1)), dtype=torch.float32), n)

    def make():
        torch.manual_seed(1)
        return GATRes(2, 64, attn_impl="factored", attn_dtype=torch.bfloat16)
    real = g.pack_nodes(torch.ones(2 * n, 1, dtype=torch.bool), n)[:, 0]
    got, ref = _both(monkeypatch, route, make, x, w, g)
    assert torch.equal(got[0][real], ref[0][real])
    for k, (a, b) in enumerate(zip(got[1], ref[1])):
        assert a.dtype == torch.float32 and torch.equal(a, b), f"{route}: gradient {k}"


# ---- the model's path --------------------------------------------------------------------

@pytest.mark.parametrize("route", ROUTES)
def test_model_path_hands_bf16_rows_and_builds_no_f32_x_ext(rng, monkeypatch, route):
    """GATRes under attn_dtype bf16: every bf16-operand forward receives its
    x_ext in bf16, and ``extend_rows`` (f32) extends no projected rows
    [B, n_pad, H, C]: it runs only for SimpleMeanConv (through the banded
    aggregation ``_band_agg``, which it shares with the model zoo) and for
    the windows of the logit halves a_s [B, n_pad, H] (``band_windows``)."""
    tpl, g = _graph(route)
    n = tpl.n_node
    seen, callers = [], []
    name = "band_attention_flash_fwd" if route == "flash" else "band_attention_fwd"
    real_fwd, real_ext = getattr(pba, name), bops.extend_rows

    def spy_fwd(a_dst, a_src_win, x_ext, *args):
        seen.append((x_ext.dtype, args[-1]))
        return real_fwd(a_dst, a_src_win, x_ext, *args)

    def spy_ext(x_bp, U, R):
        caller = sys._getframe(1).f_code.co_qualname
        if caller == "_band_agg":       # called by _aggregate, called by the layer
            caller = f"{sys._getframe(3).f_code.co_qualname} > _band_agg"
        callers.append((caller, x_bp.dim()))
        return real_ext(x_bp, U, R)
    monkeypatch.setattr(pba, name, spy_fwd)
    monkeypatch.setattr(bops, "extend_rows", spy_ext)
    torch.manual_seed(2)
    model = GATRes(2, 128, attn_impl="factored", attn_dtype=torch.bfloat16)
    x = g.pack_nodes(torch.as_tensor(rng.standard_normal((2 * n, 1)), dtype=torch.float32), n)
    model(x.requires_grad_(), g).sum().backward()
    assert seen == [(torch.bfloat16, True)] * 4
    assert sorted(set(callers)) == [("SimpleMeanConv.forward > _band_agg", 3),
                                    ("band_windows", 3)]
    assert callers.count(("SimpleMeanConv.forward > _band_agg", 3)) == 2
