"""PyTorch port: the bf16-operand band attention (``mxu_bf16=True``: the v2,
v4 and v3 Pallas kernels built with ``mx = bfloat16``, which GATRes's
``attn_dtype=bfloat16`` reaches) against the JAX package. On the CPU the
port runs its plain versions; the JAX side runs the Pallas kernels in
interpret mode. Real rows only: the Pallas kernels average a padded row
over the padded window, the port over W (ROADMAP Queue 3).

Each comparison holds two ways: within ``atol 1e-5 + 1e-5·max|ref|`` of the
JAX bf16 kernel, and at least ``1e-3·max|ref|`` away from the JAX f32 kernel,
so the port rounds, and rounds the quantity the kernel rounds (v2 the
normalised weight, v4 the numerator exp(z − m)): rounding the other one
lands about as far from the reference as the whole bf16 effect."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_pressure_estimation_tpu.ops.pallas import band_attention as jax_pallas
from gnn_pressure_estimation_tpu_torch.ops.band_attention import (
    band_attention, band_attention_acc, band_attention_acc_bwd, band_attention_bwd,
    band_attention_bwd_plain, band_attention_flash, band_attention_flash_bwd,
    band_attention_flash_bwd_plain, band_attention_flash_fwd, band_attention_flash_plain,
    band_attention_fwd, band_attention_plain,
)

torch.set_num_threads(1)
NAMES = ("out", "d a_dst", "d a_src_win", "d x_ext")

# (nB, B, BLK, W, H, C, wide): H·C 128 and 256, W not a multiple of BLK,
# fully masked rows in the last block; ``wide``: one row of every block with
# more than 32 set columns, which the row walk takes in several chunks
SHAPES = {"hc128": (3, 2, 16, 48, 2, 64, False), "hc256": (2, 2, 8, 24, 2, 128, False),
          "hc128_one_head": (2, 1, 16, 40, 1, 128, False), "wide_rows": (2, 2, 16, 80, 2, 64, True)}
MAKERS = {"v2": jax_pallas.make_band_attention_dma, "v4": jax_pallas.make_band_attention_flash,
          "v3": jax_pallas.make_band_attention_acc}
PORT = {"v2": band_attention, "v4": band_attention_flash, "v3": band_attention_acc}


def inputs(seed, nB, B, BLK, W, H, C, wide):
    """A mask at 10-20% density with the self-loop set, a third of the logit
    halves zero (so a_dst + a_src == 0 occurs), the last three rows of the
    last block fully masked, and a cotangent that is zero on them."""
    rng = np.random.default_rng(seed)
    U = (W - BLK) // 2
    adj = rng.random((nB, BLK, W)) < rng.uniform(0.10, 0.20)
    adj[:, np.arange(BLK), U + np.arange(BLK)] = True
    if wide:
        adj[:, 1, : W - 8] = True
    adj[-1, -3:, :] = False
    n_pad, n_ext = nB * BLK, nB * BLK + W - BLK
    a_dst = rng.standard_normal((B, n_pad, H)).astype(np.float32)
    a_src = rng.standard_normal((nB, B, W, H)).astype(np.float32)
    a_dst[:, ::3] = 0.0
    a_src[:, :, ::3] = 0.0
    x_ext = rng.standard_normal((B, n_ext, H, C)).astype(np.float32)
    real = adj.any(-1).reshape(-1)
    g = rng.standard_normal((B, n_pad, H, C)).astype(np.float32) * real[None, :, None, None]
    return adj, a_dst, a_src, x_ext, g, real


def jax_values(route, shape, mxu_bf16, adj, a_dst, a_src, x_ext, g):
    nB, _, BLK, W, *_ = shape
    attend = MAKERS[route](nB, BLK, W, (W - BLK) // 2, 0.2, interpret=True)
    assert attend is not None
    adjj = jnp.asarray(adj)
    out, vjp = jax.vjp(lambda *a: attend(*a, adjj, mxu_bf16=mxu_bf16),
                       jnp.asarray(a_dst), jnp.asarray(a_src), jnp.asarray(x_ext))
    return [np.asarray(out), *map(np.asarray, vjp(jnp.asarray(g)))]


def port_values(route, adj, a_dst, a_src, x_ext, g):
    args = [torch.from_numpy(a).requires_grad_() for a in (a_dst, a_src, x_ext)]
    out = PORT[route](*args, torch.from_numpy(adj), 0.2, mxu_bf16=True)
    grads = torch.autograd.grad(out, args, torch.from_numpy(g))
    return [out.detach().numpy(), *(t.numpy() for t in grads)]


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("route", list(MAKERS))
def test_bf16_matches_pallas_bf16_and_not_f32(route, shape):
    dims = SHAPES[shape]
    adj, a_dst, a_src, x_ext, g, real = inputs(sorted(SHAPES).index(shape), *dims)
    with jax.default_matmul_precision("highest"):
        ref = jax_values(route, dims, True, adj, a_dst, a_src, x_ext, g)
        f32 = jax_values(route, dims, False, adj, a_dst, a_src, x_ext, g)
    got = port_values(route, adj, a_dst, a_src, x_ext, g)
    got[0], ref[0], f32[0] = got[0][:, real], ref[0][:, real], f32[0][:, real]
    for name, a, r, f in zip(NAMES, got, ref, f32):
        top = float(np.abs(r).max())
        err, gap = float(np.abs(a - r).max()), float(np.abs(a - f).max())
        assert err <= 1e-5 + 1e-5 * top, f"{route} {name}: {err:.3e} from the bf16 kernel"
        assert gap >= 1e-3 * top, f"{route} {name}: only {gap:.3e} from the f32 kernel"


def test_v3_bf16_backward_is_v2s(rng):
    adj, a_dst, a_src, x_ext, g, _ = inputs(1, *SHAPES["hc128"])
    t = [torch.from_numpy(a) for a in (a_dst, a_src, x_ext, adj, g)]
    for a, b in zip(band_attention_acc_bwd(*t, 0.2, mxu_bf16=True),
                    band_attention_bwd(*t, 0.2, mxu_bf16=True)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("route", ["v2", "v4"])
def test_bf16_wrappers_on_cpu_take_the_plain_versions(route):
    """The wrappers run the plain versions on CPU tensors with the flag,
    forward and backward, and count no launch of either instance."""
    adj, a_dst, a_src, x_ext, g, _ = inputs(2, *SHAPES["hc256"])
    t = [torch.from_numpy(a) for a in (a_dst, a_src, x_ext, adj)]
    d_out = torch.from_numpy(g)
    wrappers = ((band_attention_fwd, band_attention_bwd) if route == "v2"
                else (band_attention_flash_fwd, band_attention_flash_bwd))
    before = [(w.launches, w.launches_bf16) for w in wrappers]
    if route == "v2":
        got, want = [band_attention_fwd(*t, 0.2, None, True)], [band_attention_plain(*t, 0.2, True)]
        f32 = band_attention_fwd(*t, 0.2)
        dgot = band_attention_bwd(*t, d_out, 0.2, None, True)
        dwant = band_attention_bwd_plain(*t, d_out, 0.2, True)
    else:
        got = band_attention_flash_fwd(*t, 0.2, None, True)
        want = band_attention_flash_plain(*t, 0.2, True)
        f32 = band_attention_flash_fwd(*t, 0.2)[0]
        stats = (want[1], want[2], (d_out * want[0]).sum(-1), d_out)
        dgot = band_attention_flash_bwd(*t, *stats, 0.2, None, True)
        dwant = band_attention_flash_bwd_plain(*t, *stats, 0.2, True)
    for a, b in zip([*got, *dgot], [*want, *dwant]):
        assert torch.equal(a, b)
    assert not torch.equal(f32, got[0])
    assert [(w.launches, w.launches_bf16) for w in wrappers] == before


def test_bf16_flash_stats_are_the_row_max_and_the_unrounded_sum():
    """v4's bf16 forward returns m = the row maximum and Z = the sum of the
    unrounded numerators, and its out times Z is the bf16 product."""
    adj, a_dst, a_src, x_ext, _, real = inputs(3, *SHAPES["wide_rows"])
    t = [torch.from_numpy(a) for a in (a_dst, a_src, x_ext, adj)]
    out, m, Z = band_attention_flash_plain(*t, 0.2, True)
    out32, m32, Z32 = band_attention_flash_plain(*t, 0.2)
    assert torch.equal(m, m32)
    torch.testing.assert_close(Z, Z32, rtol=1e-6, atol=0)
    assert not torch.allclose(out[:, real], out32[:, real], rtol=1e-4, atol=1e-4)
