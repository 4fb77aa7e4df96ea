"""PyTorch port: the dense softmax backward (``csrc/fused_attention_bwd.cu``)
runs v2's band backward (``csrc/band_bwd.cuh``) on the band of one block:
nB 1, BLK = W = n, a_src as a_src_win [1, B, n, H], v as x_ext (n_ext = n),
and the mask's ``MaskIndex`` as that band's ``BandIndex``. A CUDA kernel
cannot run here, so the five passes are replayed in numpy (``backward_replay``
of ``test_torch_band_rowlist_bwd.py``, lane by lane in the columns pass) on
that view of the index, and held against ``fused_attention_bwd_plain`` and
against the VJP of the JAX package's ``make_fused_attention`` (its Pallas
kernel in interpret mode), at the shapes of ``test_torch_graph_attention.py``
on masks with one-way edges and a third of the nodes zeroed, so that
a_dst + a_src == 0 (the >= side of the sign test) occurs on set cells."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_pressure_estimation_tpu.ops.pallas.graph_attention import make_fused_attention
from gnn_pressure_estimation_tpu_torch.ops import banded as bops
from gnn_pressure_estimation_tpu_torch.ops import graph_attention as ga
from test_torch_band_rowlist_bwd import F32, backward_replay
from test_torch_graph_attention import SHAPES, _bhn, _mask

torch.set_num_threads(1)
FIELDS = ("row_ptr", "col", "t_ptr", "t_entry", "t_row", "empty_ptr", "empty_row")
PLAIN = dict(rtol=1e-5, atol=1e-5)
JAX_TOL = dict(rtol=1e-4, atol=1e-4)


def one_block(ix):
    """The ``MaskIndex`` as the kernel hands it to the band passes: the
    index of the band of one block, nB 1, BLK = W = n."""
    return types.SimpleNamespace(nB=1, BLK=ix.n, W=ix.n, nnz=ix.nnz,
                                 **{f: getattr(ix, f) for f in FIELDS})


def _operands(rng, mask, B, H, C):
    """a_dst, a_src [B, n, H], v, d_out [B, n, H, C]; every third node zeroed
    in both a's, so that a_dst + a_src == 0 where two of them meet."""
    n = mask.shape[0]
    a_dst = rng.standard_normal((B, n, H)).astype(F32)
    a_src = rng.standard_normal((B, n, H)).astype(F32)
    a_dst[:, ::3] = 0.0
    a_src[:, ::3] = 0.0
    s = a_dst[:, :, None, :] + a_src[:, None, :, :]
    assert ((s == 0) & mask[None, :, :, None]).any()
    return (a_dst, a_src, rng.standard_normal((B, n, H, C)).astype(F32),
            rng.standard_normal((B, n, H, C)).astype(F32))


def band_replay(mask, a_dst, a_src, v, d_out, **mutation):
    """``csrc/fused_attention_bwd.cu`` in numpy: (d a_dst, d a_src, d v)."""
    view = one_block(ga.build_mask_index(mask))
    (d_ad, d_as, d_v), _ = backward_replay(view, a_dst, a_src[None], v, d_out, **mutation)
    return d_ad, d_as[0], d_v


def _plain(mask, a_dst, a_src, v, d_out):
    return [t.numpy() for t in ga.fused_attention_bwd_plain(
        *(torch.from_numpy(a) for a in (a_dst, a_src, v, mask, d_out)), 0.2)]


@pytest.mark.parametrize("kind", ["symmetric", "one_way"])
@pytest.mark.parametrize("n", [26, 130])
def test_mask_index_is_the_one_block_band_index(rng, kind, n):
    """Field by field, the BandIndex of mask[None]: the same entries in the
    same order by row and by column, and no empty row."""
    mask = _mask(rng, n, kind)
    ix, bx = ga.build_mask_index(mask), bops.build_band_index(mask[None])
    assert (bx.nB, bx.BLK, bx.W, bx.nnz) == (1, n, n, ix.nnz)
    for f in FIELDS:
        a, b = getattr(ix, f), getattr(bx, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert ix.empty_row.size == 0 and ix.empty_ptr.tolist() == [0, 0]
    moved = ix.to("cpu")
    assert moved.empty_ptr.dtype == torch.int32 and moved.empty_row.numel() == 0


@pytest.mark.parametrize("n,H,C,B", SHAPES)
def test_band_replay_matches_plain(rng, n, H, C, B):
    mask = _mask(rng, n, "one_way")
    args = _operands(rng, mask, B, H, C)
    got = band_replay(mask, *args)
    for name, g, r in zip(("d a_dst", "d a_src", "d v"), got, _plain(mask, *args)):
        np.testing.assert_allclose(g, r, err_msg=f"n{n} H{H} C{C} B{B} {name}", **PLAIN)


@pytest.mark.parametrize("kind", ["symmetric", "one_way"])
@pytest.mark.parametrize("n,H,C,B", SHAPES)
def test_band_replay_matches_pallas_vjp(rng, kind, n, H, C, B):
    """Against jax.vjp through make_fused_attention (interpret mode), whose
    layout is [B, H, n, ·]."""
    mask = _mask(rng, n, kind)
    a_dst, a_src, v, d_out = _operands(rng, mask, B, H, C)
    got = band_replay(mask, a_dst, a_src, v, d_out)
    attend = make_fused_attention(mask, 0.2, interpret=True)
    _, vjp = jax.vjp(attend, jnp.asarray(a_dst), jnp.asarray(_bhn(a_src)), jnp.asarray(_bhn(v)))
    ref = vjp(jnp.asarray(_bhn(d_out)))
    for name, g, r in zip(("d a_dst", "d a_src", "d v"), got,
                          (ref[0], _bhn(np.asarray(ref[1])), _bhn(np.asarray(ref[2])))):
        np.testing.assert_allclose(g, np.asarray(r), err_msg=f"{kind} n{n} {name}", **JAX_TOL)


def test_a_replay_with_a_strict_sign_test_fails(rng):
    """The checks above see the sign test taken as > 0: the zeroed nodes put
    cells at exactly 0, where the slope must not apply."""
    mask = _mask(rng, 26, "one_way")
    args = _operands(rng, mask, 2, 2, 4)
    got = band_replay(mask, *args, sign=np.greater)
    ref = _plain(mask, *args)
    assert not all(np.allclose(g, r, **PLAIN) for g, r in zip(got[:2], ref[:2]))

