"""PyTorch port: the bf16-operand band backwards (``mxu_bf16=True`` on the
"dma", "acc" and "flash" routes: v2's, v3's and v4's bf16 instances) read the
extended rows stored in bfloat16, as the forwards do.

The autograd Functions hand the backward wrappers the bf16 rows they saved,
with no f32 copy; a wrapper given f32 rows under ``mxu_bf16`` rounds them
once, one given bf16 rows without it raises; the plain versions widen the
bf16 rows themselves (exactly), so the model's gradients are the bits of a
backward that took the rows widened to f32. Against the JAX package the
port's backward on the stored rows matches the v2, v3 and v4 Pallas
backwards built with ``mxu_bf16=True`` (interpret mode) on dyadic rows, with
a dyadic cotangent and with one off the bf16 grid."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gnn_pressure_estimation_tpu.ops.pallas import band_attention as jax_pallas
from gnn_pressure_estimation_tpu_torch.core.graph import GraphTemplate
from gnn_pressure_estimation_tpu_torch.models import layers
from gnn_pressure_estimation_tpu_torch.models.gatres import GATRes
from gnn_pressure_estimation_tpu_torch.ops import band_attention as pba
from gnn_pressure_estimation_tpu_torch.ops import banded as bops
from helpers import random_graph

torch.set_num_threads(1)
ROUTES = ("dma", "acc", "flash")
BWD = {"dma": "band_attention_bwd", "acc": "band_attention_acc_bwd",
       "flash": "band_attention_flash_bwd"}
PARTS = ("d a_dst", "d a_src_win", "d x_ext")


def _mask(rng, nB=3, BLK=8, W=24, density=0.3):
    m = rng.random((nB, BLK, W)) < density
    m[-1, -3:] = False                                  # padded rows: no set column
    return torch.as_tensor(m)


def _operands(rng, mask, B, H, C):
    """a_dst, a_src_win, f32 rows x_ext and a cotangent d_out."""
    nB, BLK, W = mask.shape
    n_pad, n_ext = nB * BLK, nB * BLK + W - BLK

    def f32(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)
    return f32(B, n_pad, H), f32(nB, B, W, H), f32(B, n_ext, H, C), f32(B, n_pad, H, C)


def _backward(route, a_dst, a_src, x_ext, mask, d_out, mxu_bf16=True):
    """The route's backward wrapper on these rows (v4's from its forward's
    m, Z and delta, taken on the bf16 rows)."""
    if route != "flash":
        return getattr(pba, BWD[route])(a_dst, a_src, x_ext, mask, d_out, 0.2, None, mxu_bf16)
    out, m, Z = pba.band_attention_flash_plain(a_dst, a_src, x_ext.to(torch.bfloat16), mask, 0.2,
                                               True)
    return pba.band_attention_flash_bwd(a_dst, a_src, x_ext, mask, m, Z, (d_out * out).sum(-1),
                                        d_out, 0.2, None, mxu_bf16)


# ---- the wrappers ------------------------------------------------------------------------

@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("C", [8, 6])
def test_plain_path_on_bf16_rows_is_the_widened_rows(rng, route, C):
    """The plain path of each bf16 backward on bf16 rows equals the same
    wrapper on those rows widened to f32, bit for bit, in f32."""
    mask = _mask(rng)
    a_dst, a_src, x_ext, d_out = _operands(rng, mask, 2, 2, C)
    xb = x_ext.to(torch.bfloat16)
    got = _backward(route, a_dst, a_src, xb, mask, d_out)
    ref = _backward(route, a_dst, a_src, xb.float(), mask, d_out)
    for part, g, r in zip(PARTS, got, ref):
        assert g.dtype == torch.float32, f"{route} {part}: {g.dtype}"
        assert torch.equal(g, r), f"{route} {part}"


@pytest.mark.parametrize("route", ROUTES)
def test_f32_rows_are_rounded_once_as_stored(rng, route):
    """Under mxu_bf16 f32 rows handed to a backward wrapper are rounded once:
    the gradients equal those of the rows ``extend_rows_bf16`` stores, and
    differ from the f32 instance's."""
    mask = _mask(rng)
    nB, BLK, W = mask.shape
    U, R = 5, W - 5 - BLK
    a_dst, a_src, _, d_out = _operands(rng, mask, 2, 2, 8)
    xp = torch.as_tensor(rng.standard_normal((2, nB * BLK, 2, 8)), dtype=torch.float32)
    got = _backward(route, a_dst, a_src, bops.extend_rows(xp, U, R), mask, d_out)
    ref = _backward(route, a_dst, a_src, bops.extend_rows_bf16(xp, U, R), mask, d_out)
    f32 = _backward(route, a_dst, a_src, bops.extend_rows(xp, U, R), mask, d_out, False)
    for part, g, r in zip(PARTS, got, ref):
        assert torch.equal(g, r), f"{route} {part}"
    assert not torch.equal(got[2], f32[2])


@pytest.mark.parametrize("route", ROUTES)
def test_kernel_path_holds_rows_to_the_instance_dtype(rng, monkeypatch, route):
    """On the kernel's path a backward wrapper refuses bf16 rows without
    mxu_bf16, and rows of another dtype without it; bf16 rows under mxu_bf16
    pass the dtype check and stop at the device check."""
    monkeypatch.setattr(bops, "use_plain", lambda t: False)
    mask = _mask(rng)
    a_dst, a_src, x_ext, d_out = _operands(rng, mask, 1, 1, 8)
    stats = (a_dst, a_dst, a_dst, d_out)                # m, Z, delta: only shapes matter here
    fn = getattr(pba, BWD[route])

    def call(x, mxu_bf16):
        if route == "flash":
            return fn(a_dst, a_src, x, mask, *stats, 0.2, None, mxu_bf16)
        return fn(a_dst, a_src, x, mask, d_out, 0.2, None, mxu_bf16)
    with pytest.raises(ValueError, match="bfloat16"):
        call(x_ext.to(torch.bfloat16), False)
    with pytest.raises(ValueError, match="x must be contiguous torch.float32"):
        call(x_ext.to(torch.float16), False)
    with pytest.raises(ValueError, match="unsupported device"):
        call(x_ext.to(torch.bfloat16), True)
    with pytest.raises(ValueError, match="unsupported device"):
        call(x_ext, True)


# ---- the autograd Functions ---------------------------------------------------------------

class _RowCopies(TorchDispatchMode):
    """Records every op that makes an f32 tensor of ``shape`` while not paused."""

    def __init__(self, shape):
        super().__init__()
        self.shape, self.seen, self.paused = shape, [], False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.paused:
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor) and t.dtype == torch.float32 \
                        and tuple(t.shape) == self.shape:
                    self.seen.append(str(func))
        return out


@pytest.mark.parametrize("route", ROUTES)
def test_function_hands_the_saved_bf16_rows_to_the_backward(rng, monkeypatch, route):
    """``band_attention(..., halo=(U, R), mxu_bf16=True)`` and its acc and
    flash counterparts: the backward wrapper receives x_ext in bf16 (the rows
    the Function saved), and outside the wrapper the backward makes no f32
    tensor of x_ext's shape."""
    mask = _mask(rng)
    nB, BLK, W = mask.shape
    U, R = 5, W - 5 - BLK
    B, H, C = 2, 2, 8
    a_dst, a_src, _, _ = _operands(rng, mask, B, H, C)
    xp = torch.as_tensor(rng.standard_normal((B, nB * BLK, H, C)), dtype=torch.float32)
    xp.requires_grad_()
    spy = _RowCopies((B, U + nB * BLK + R, H, C))
    seen, real = [], getattr(pba, BWD[route])

    def wrapper(a_dst, a_src_win, x_ext, *args):
        seen.append((x_ext.dtype, args[-1]))
        spy.paused = True
        try:
            return real(a_dst, a_src_win, x_ext, *args)
        finally:
            spy.paused = False
    monkeypatch.setattr(pba, BWD[route], wrapper)
    out = layers.BAND_ATTEND[route](a_dst, a_src, xp, mask, 0.2, None, True, (U, R))
    w = torch.as_tensor(rng.standard_normal(out.shape), dtype=torch.float32)
    with spy:
        (g,) = torch.autograd.grad((out * w).sum(), [xp])
    assert seen == [(torch.bfloat16, True)]
    assert spy.seen == [], f"{route}: the backward made f32 rows by {spy.seen}"
    assert g.dtype == torch.float32 and g.shape == xp.shape


def test_row_copy_spy_sees_a_widening(rng):
    """The spy of the test above records a Function that widens the saved
    rows before the wrapper: ``x_ext.float()`` of the saved bf16 rows."""
    spy = _RowCopies((2, 5, 1, 4))
    x = torch.zeros((2, 5, 1, 4), dtype=torch.bfloat16)
    with spy:
        x.float()
    assert spy.seen


# ---- the JAX package's bf16 backwards ----------------------------------------------------

MAKERS = {"dma": jax_pallas.make_band_attention_dma, "acc": jax_pallas.make_band_attention_acc,
          "flash": jax_pallas.make_band_attention_flash}


def _dyadic(rng, shape, step, bound):
    """Values on the grid ``step·k`` in [−bound, bound]: x on 2^-3 up to 1
    is exact in bf16, and the products dO·x sum exactly in f32 in any
    order."""
    return (np.round(rng.uniform(-bound, bound, shape) / step) * step).astype(np.float32)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("cotangent", ["dyadic", "normal"])
def test_backward_on_stored_rows_matches_pallas_bf16(route, cotangent):
    """The port's bf16 backward on the stored bf16 rows against the JAX
    Pallas backward built with mxu_bf16=True (interpret mode) on the same
    rows in f32: every cotangent within 1e-5 + 1e-5·max|ref| (the sums run in
    another order; the tolerance of tests/test_torch_band_bf16.py). The
    cotangent dO is dyadic (exact in bf16), or standard normal, off the bf16
    grid: rounding dO then moves the gradients by about 1e-3·max|ref|, so a
    backward that took dO in f32 fails. A zero cotangent on the rows with no
    set column, which the Pallas kernels average over another window."""
    rng = np.random.default_rng(14)
    nB, B, BLK, W, H, C = 3, 2, 16, 48, 2, 64
    U = (W - BLK) // 2
    adj = rng.random((nB, BLK, W)) < 0.15
    adj[:, np.arange(BLK), U + np.arange(BLK)] = True
    adj[-1, -3:, :] = False
    n_pad, n_ext = nB * BLK, nB * BLK + W - BLK
    a_dst = _dyadic(rng, (B, n_pad, H), 2.0 ** -4, 2.0)
    a_src = _dyadic(rng, (nB, B, W, H), 2.0 ** -4, 2.0)
    x_ext = _dyadic(rng, (B, n_ext, H, C), 2.0 ** -3, 1.0)
    real = adj.any(-1).reshape(-1)
    g = (_dyadic(rng, (B, n_pad, H, C), 2.0 ** -3, 1.0) if cotangent == "dyadic" else
         rng.standard_normal((B, n_pad, H, C)).astype(np.float32)) * real[None, :, None, None]
    gt = torch.from_numpy(g)
    assert torch.equal(gt.to(torch.bfloat16).float(), gt) == (cotangent == "dyadic")
    attend = MAKERS[route](nB, BLK, W, U, 0.2, interpret=True)
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(lambda *a: attend(*a, jnp.asarray(adj), mxu_bf16=True),
                         jnp.asarray(a_dst), jnp.asarray(a_src), jnp.asarray(x_ext))
        ref = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    xb = torch.from_numpy(x_ext).to(torch.bfloat16)
    assert torch.equal(xb.float(), torch.from_numpy(x_ext))        # the rows are exact in bf16
    got = _backward(route, torch.from_numpy(a_dst), torch.from_numpy(a_src), xb,
                    torch.from_numpy(adj), gt)
    for part, a, r in zip(PARTS, got, ref):
        top = float(np.abs(r).max())
        err = float(np.abs(a.numpy() - r).max())
        assert err <= 1e-5 + 1e-5 * top, f"{route} {part}: {err:.3e} from the Pallas bf16 backward"


# ---- the model -----------------------------------------------------------------------------

def _widening_backward(cls):
    """``cls.backward`` as it was when the Functions widened the saved bf16
    rows to f32 before the backward wrapper."""
    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_out):
        saved = list(ctx.saved_tensors)
        saved[2] = pba._widened(saved[2])
        if cls is pba.BandAttention:
            a_dst, a_src_win, x_ext, adj_mask = saved
            d = ctx.bwd(a_dst, a_src_win, x_ext, adj_mask, d_out, ctx.negative_slope, ctx.index,
                        ctx.mxu_bf16)
            return (d[0], d[1], pba._rows_grad(d[2], ctx.halo), *[None] * 6)
        a_dst, a_src_win, x_ext, adj_mask, m, Z, out = saved
        d = pba.band_attention_flash_bwd(a_dst, a_src_win, x_ext, adj_mask, m, Z,
                                         (d_out * out).sum(dim=-1), d_out, ctx.negative_slope,
                                         ctx.index, ctx.mxu_bf16)
        return (d[0], d[1], pba._rows_grad(d[2], ctx.halo), *[None] * 5)
    return backward


@pytest.mark.parametrize("route", ROUTES)
def test_gatres_gradients_equal_the_widening_functions(rng, monkeypatch, route):
    """A two-block GATRes with attn_dtype bf16 (conv1 at H·C 128 takes the
    bf16 instances): its gradients through the stored rows equal, bit for
    bit, those of the same model whose Functions widen the saved rows."""
    jt = random_graph(np.random.default_rng(5), n=45, extra_edges=25)
    tpl = GraphTemplate(45, jt.senders, jt.receivers)
    g = tpl.batch(2, "banded", 8, "cpu", band_attn=route)
    x = g.pack_nodes(torch.as_tensor(rng.standard_normal((90, 1)), dtype=torch.float32), 45)
    w = g.pack_nodes(torch.as_tensor(rng.standard_normal((90, 1)), dtype=torch.float32), 45)
    torch.manual_seed(1)
    model = GATRes(2, 64, attn_impl="factored", attn_dtype=torch.bfloat16)
    launched = []
    real = getattr(pba, BWD[route])

    def spy(*args):
        launched.append((args[2].dtype, args[-1]))      # the rows, mxu_bf16
        return real(*args)
    monkeypatch.setattr(pba, BWD[route], spy)

    def grads():
        xin = x.clone().requires_grad_()
        return torch.autograd.grad((model(xin, g) * w).sum(), [xin, *model.parameters()])
    got = grads()
    assert [dt for dt, bf in launched if bf] == [torch.bfloat16] * 2     # conv1 of each block
    del launched[:]
    cls = pba.BandAttentionFlash if route == "flash" else pba.BandAttention
    with monkeypatch.context() as mp:
        mp.setattr(cls, "backward", _widening_backward(cls))
        ref = grads()
    assert [dt for dt, bf in launched if bf] == [torch.float32] * 2
    for k, (a, b) in enumerate(zip(got, ref)):
        assert a.dtype == torch.float32 and torch.equal(a, b), f"{route}: gradient {k}"
