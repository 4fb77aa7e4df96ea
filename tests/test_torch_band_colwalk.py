"""PyTorch port: the two backwards that walk the band by extended row, the v4
(streaming-softmax) attention backward ``csrc/band_attention_flash_bwd.cu``
on the column walk it shares with v2's (``csrc/band_colwalk.cuh``), and the
band SpMM backward ``csrc/band_spmm_bwd.cu``. A CUDA kernel cannot run here,
so each is replayed in numpy in the kernel's order and held against the plain
versions on every row and against the JAX package's Pallas kernels (interpret
mode) on the real rows.

The v4 backward's replay follows its four passes: the weights p per entry
from the saved m and Z (one thread per row and head, one loop, no running
max or sum), with the padded rows' dO/W per block in the same launch; the
shared columns pass (d x_ext and dp per entry, ``columns_pass`` of
``test_torch_band_rowlist_bwd.py``, which replays that walk lane by lane);
the rows pass (dz = p (dp - delta) with the given delta, the slope where
a_dst + a_src < 0, d a_dst); the shared cells pass. The SpMM backward's
replay takes each extended row's entries in chunks of 32, four entries' dO
rows ahead of their FMAs, in 128-channel tiles of float4 or scalar slots,
with fmaf emulated in float64 (one rounding to f32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_pressure_estimation_tpu.ops.pallas.band_attention import (
    make_band_attention_flash,
    make_band_spmm_flash,
)
from gnn_pressure_estimation_tpu_torch.ops import band_attention as ba
from gnn_pressure_estimation_tpu_torch.ops import band_spmm as bs
from gnn_pressure_estimation_tpu_torch.ops import banded as bops
from test_torch_band_rowlist_bwd import (
    CHUNK, F32, LANES, SLOPE, TOL, _layout, _operands, cells_pass, columns_pass, empties_pass,
    leaky,
)

torch.set_num_threads(1)
GROUP = 4               # kGroup of the SpMM backward: dO rows loaded ahead
TILE = 128              # channels of one SpMM tile: one float4 (or four scalars) a lane


# ---- the v4 backward, pass by pass ------------------------------------------------

def flash_weights_pass(ix, a_dst, a_src, m, Z):
    """p [B, nnz, H] from the saved statistics: per row and head, one loop over
    the row's list, exp(LeakyReLU(a_dst + a_src) - m) / Z per entry."""
    B, n_pad, H = a_dst.shape
    p = np.full((B, ix.nnz, H), np.nan, F32)
    for row in range(n_pad):
        blk = row // ix.BLK
        for k in range(ix.row_ptr[row], ix.row_ptr[row + 1]):
            p[:, k] = np.exp(leaky(a_dst[:, row] + a_src[blk][:, ix.col[k]]) - m[:, row]) / Z[:, row]
    return p


def flash_rows_pass(ix, a_dst, a_src, m, Z, delta, dp, sign=np.greater_equal):
    """dz [B, nnz, H] over dp and d a_dst, one thread per row and head: p
    rebuilt as the weights pass builds it, dz = p (dp - delta), the slope
    where the pre-activation fails ``sign`` (>= 0)."""
    B, n_pad, H = a_dst.shape
    dz = dp.copy()
    d_ad = np.zeros((B, n_pad, H), F32)
    for row in range(n_pad):
        blk = row // ix.BLK
        for k in range(ix.row_ptr[row], ix.row_ptr[row + 1]):
            zpre = a_dst[:, row] + a_src[blk][:, ix.col[k]]
            d = np.exp(leaky(zpre) - m[:, row]) / Z[:, row] * (dp[:, k] - delta[:, row])
            dz[:, k] = np.where(sign(zpre, 0), d, SLOPE * d)
            d_ad[:, row] += dz[:, k]
    return dz, d_ad


def flash_backward_replay(ix, a_dst, a_src, x_ext, m, Z, delta, d_out, vec=True,
                          sign=np.greater_equal, padded_rows=True):
    """``csrc/band_attention_flash_bwd.cu`` in numpy: (d a_dst, d a_src_win,
    d x_ext) and the [B, nnz, H] scratch (p, dz). ``sign`` and
    ``padded_rows`` (whether S of the blocks with padded rows is added) are
    there for mutations."""
    p = flash_weights_pass(ix, a_dst, a_src, m, Z)
    S = empties_pass(ix, d_out) if padded_rows else {}
    d_x, dp = columns_pass(ix, x_ext, d_out, p, S, vec and x_ext.shape[-1] % 4 == 0)
    dz, d_ad = flash_rows_pass(ix, a_dst, a_src, m, Z, delta, dp, sign)
    return (d_ad, cells_pass(ix, dz, *a_dst.shape[::2]), d_x), (p, dz)


def _flash_inputs(rng, adj, B, H, C):
    """The operands, and m, Z, delta as the model's path hands them over: the
    forward's statistics and delta = sum_c dO * out."""
    a_dst, a_src, x_ext, d_out = _operands(rng, adj, B, H, C)
    out, m, Z = ba.band_attention_flash_plain(
        *(torch.from_numpy(a) for a in (a_dst, a_src, x_ext, adj)), 0.2)
    delta = (torch.from_numpy(d_out) * out).sum(-1)
    return a_dst, a_src, x_ext, m.numpy(), Z.numpy(), delta.numpy(), d_out


def _plain_flash_backward(a_dst, a_src, x_ext, adj, m, Z, delta, d_out):
    return [t.numpy() for t in ba.band_attention_flash_bwd_plain(
        *(torch.from_numpy(np.ascontiguousarray(a))
          for a in (a_dst, a_src, x_ext, adj, m, Z, delta, d_out)), negative_slope=0.2)]


# (B, H, C): C 128 at H 1-3 (the butterfly; one and two float4 a lane), C 256
# of one head, C 160 (past one 128-channel tile), C 4 at H 1, 2 and 40 (float4
# slots inside a row of lanes; five head groups), C 3 and 33 (scalar slots)
FLASH_SHAPES = {
    "padded": [(2, 1, 128), (1, 2, 128), (1, 3, 128), (1, 1, 256), (2, 1, 160), (2, 1, 4),
               (2, 2, 4), (1, 40, 4), (2, 3, 3), (1, 1, 3), (2, 2, 33)],
    "wide": [(1, 2, 128), (2, 3, 3)],
    "dense": [(1, 1, 128), (2, 2, 4), (1, 3, 3)],
    "minitown": [(2, 1, 128), (2, 3, 33)],
    "random": [(1, 2, 128), (1, 40, 4)],
}


@pytest.mark.parametrize("layout", list(FLASH_SHAPES))
def test_flash_backward_replay_matches_plain_on_every_row(rng, layout):
    adj = _layout(layout, rng)
    ix = bops.build_band_index(adj)
    if layout == "dense":
        assert int(np.diff(ix.t_ptr).max()) > CHUNK            # two chunks in the columns pass
    if layout == "wide":
        assert int(np.diff(ix.row_ptr).max()) > 2 * CHUNK      # rows past 32 entries
    if layout in ("padded", "random"):
        assert ix.empty_row.size > 0                            # S of the padded rows
    for B, H, C in FLASH_SHAPES[layout]:
        args = _flash_inputs(rng, adj, B, H, C)
        got, _ = flash_backward_replay(ix, *args)
        ref = _plain_flash_backward(*args[:3], adj, *args[3:])
        for name, g, r in zip(("d a_dst", "d a_src_win", "d x_ext"), got, ref):
            np.testing.assert_allclose(g, r, err_msg=f"{layout} B{B} H{H} C{C} {name}", **TOL)


def test_flash_backward_scalar_slots_for_an_offset_view(rng):
    """An x_ext or d_out off 16-byte alignment takes the scalar slots (the
    wrapper's vector_loads on both); that branch's replay gives the same."""
    adj = _layout("padded", rng)
    ix = bops.build_band_index(adj)
    args = _flash_inputs(rng, adj, 2, 2, 64)
    got, _ = flash_backward_replay(ix, *args, vec=False)
    for g, r in zip(got, _plain_flash_backward(*args[:3], adj, *args[3:])):
        np.testing.assert_allclose(g, r, **TOL)
    d_off = torch.zeros(args[-1].size + 1)[1:].view(args[-1].shape)
    assert not bops.vector_loads(d_off, 64)


def test_flash_scratch_holds_the_plain_weights_by_entry(rng):
    """p of the weights pass, entry k of the index, is the plain version's
    exp(z - m) / Z of its (block, row, column) for every head; dz sums to
    d a_dst row by row."""
    adj = _layout("padded", rng)
    ix = bops.build_band_index(adj)
    a_dst, a_src, x_ext, m, Z, delta, d_out = _flash_inputs(rng, adj, 2, 3, 8)
    (d_ad, _, _), (p, dz) = flash_backward_replay(ix, a_dst, a_src, x_ext, m, Z, delta, d_out)
    z, _, _ = ba._logits(torch.from_numpy(a_dst), torch.from_numpy(a_src), torch.from_numpy(adj), 0.2)
    nB, BLK, W = adj.shape
    p_ref = (torch.exp(z - ba._blocks_of(torch.from_numpy(m), nB, BLK)[:, :, :, None, :])
             / ba._blocks_of(torch.from_numpy(Z), nB, BLK)[:, :, :, None, :]).numpy()
    g = np.repeat(np.arange(nB * BLK), np.diff(ix.row_ptr))
    np.testing.assert_allclose(p, p_ref[g // BLK, :, g % BLK, ix.col].transpose(1, 0, 2), **TOL)
    rows_sum = np.stack([dz[:, ix.row_ptr[r]: ix.row_ptr[r + 1]].sum(1) for r in range(nB * BLK)], 1)
    np.testing.assert_allclose(rows_sum, d_ad, **TOL)


@pytest.mark.parametrize("bfold", ["0", "1"])
@pytest.mark.parametrize("H,C", [(1, 128), (2, 64)])
def test_flash_backward_replay_matches_pallas_flash_on_real_rows(rng, monkeypatch, bfold, H, C):
    """Against jax.vjp through make_band_attention_flash (interpret mode),
    unfolded and batch-folded, the padded rows' cotangent zeroed: the Pallas
    kernel averages them over the chunk-padded W, the port over W."""
    monkeypatch.setenv("GNN_TPU_BAND_BFOLD", bfold)
    adj = _layout("padded", rng)
    nB, BLK, W = adj.shape
    ix = bops.build_band_index(adj)
    a_dst, a_src, x_ext, d_out = _operands(rng, adj, 2, H, C)
    d_out = d_out * adj.any(-1).reshape(-1)[None, :, None, None].astype(F32)
    out, m, Z = ba.band_attention_flash_plain(
        *(torch.from_numpy(a) for a in (a_dst, a_src, x_ext, adj)), 0.2)
    delta = (torch.from_numpy(d_out) * out).sum(-1).numpy()
    got, _ = flash_backward_replay(ix, a_dst, a_src, x_ext, m.numpy(), Z.numpy(), delta, d_out)
    v4 = make_band_attention_flash(nB, BLK, W, (W - BLK) // 2, 0.2, interpret=True)
    jargs = (jnp.asarray(a_dst), jnp.asarray(a_src), jnp.asarray(x_ext))
    _, vjp = jax.vjp(lambda *a: v4(*a, jnp.asarray(adj)), *jargs)
    for name, g, r in zip(("d a_dst", "d a_src_win", "d x_ext"), got, vjp(jnp.asarray(d_out))):
        np.testing.assert_allclose(g, np.asarray(r), err_msg=name, **TOL)


# ---- the band SpMM backward ---------------------------------------------------------

def fmaf(w, x, acc):
    """f32 w * x + acc with one rounding, as the card's fmaf (the product of
    two f32 is exact in float64)."""
    return (np.float64(w) * x.astype(np.float64) + acc.astype(np.float64)).astype(F32)


def spmm_bwd_replay(ix, d_out, vec=True, summed_past_cnt=False):
    """``csrc/band_spmm_bwd.cu`` in numpy: per extended row, its entries
    (t_row, t_val) in chunks of 32, GROUP entries' dO rows loaded (a repeat of
    the chunk's last past its end) before their FMAs, per 128-channel tile
    whose lane owns channels c0 + 4 lane + (0..3) (vec) or c0 + lane + 32 (0..3).
    ``summed_past_cnt`` adds the repeats: a mutation."""
    B, _, C = d_out.shape
    n_ext = len(ix.t_ptr) - 1
    out = np.full((B, n_ext, C), np.nan, F32)
    for e in range(n_ext):
        t0, t1 = int(ix.t_ptr[e]), int(ix.t_ptr[e + 1])
        for c0 in range(0, C, TILE):
            lane_c = 4 * LANES[:, None] + np.arange(4) if vec else LANES[:, None] + 32 * np.arange(4)
            chan = c0 + lane_c                                              # [32, 4]
            valid = chan < C
            cc = np.where(valid, chan, 0)
            acc = np.zeros((B, 32, 4), F32)
            for s0 in range(t0, t1, CHUNK):
                cnt = min(CHUNK, t1 - s0)
                gl, wl = ix.t_row[s0:s0 + cnt], ix.t_val[s0:s0 + cnt]
                for g in range(0, cnt, GROUP):
                    s = [min(g + q, cnt - 1) for q in range(GROUP)]
                    dv = [np.where(valid, d_out[:, gl[sq]][:, cc], 0).astype(F32) for sq in s]
                    for q in range(GROUP):
                        if g + q < cnt or summed_past_cnt:
                            acc = fmaf(wl[s[q]], dv[q], acc)
            out[:, e][:, cc[valid]] = acc[:, valid]
    return out


def ascending_sum(band, d_out):
    """d x_ext from the dense band: per extended row e and channel, the band's
    entries in column e - blk*BLK of every block, by ascending band row g,
    one fmaf each from 0."""
    nB, BLK, W = band.shape
    B, _, C = d_out.shape
    out = np.zeros((B, nB * BLK + W - BLK, C), F32)
    for e in range(out.shape[1]):
        acc = np.zeros((B, C), F32)
        for blk in range(nB):
            j = e - blk * BLK
            if 0 <= j < W:
                for r in np.nonzero(band[blk, :, j])[0]:
                    acc = fmaf(F32(band[blk, r, j]), d_out[:, blk * BLK + r], acc)
        out[:, e] = acc
    return out


def _spmm_bands(rng):
    """(label, band): a template's int8 counts and f32 weights of the same
    pattern, rows of ~80 entries, padded rows, extended rows read by more
    than 32 entries."""
    out = []
    for kind in ("minitown", "wide", "padded", "dense"):
        on = _layout(kind, rng)
        out.append((f"{kind} int8", (on * rng.integers(1, 4, on.shape)).astype(np.int8)))
        out.append((f"{kind} f32", (on * rng.random(on.shape)).astype(np.float32)))
    return out


# (C, float4 slots): the scalar slots take any C, the float4 ones C % 4 == 0
@pytest.mark.parametrize("C,vec", [(3, False), (4, True), (4, False), (128, True), (128, False),
                                   (300, True), (300, False)])
def test_spmm_bwd_replay_is_the_ascending_sum_bit_for_bit(rng, C, vec):
    """The chunks, the loads ahead and either slot order leave each channel's
    sum in ascending g, one fmaf an entry: bit-equal to that sum (and so to
    the kernel before the redesign, which took the entries one by one)."""
    for label, band in _spmm_bands(rng):
        nB, BLK, W = band.shape
        d_out = rng.standard_normal((2, nB * BLK, C)).astype(F32)
        got = spmm_bwd_replay(bops.build_band_index(band), d_out, vec)
        np.testing.assert_array_equal(got, ascending_sum(band, d_out), err_msg=f"{label} C{C}")


@pytest.mark.parametrize("C", [4, 33, 128])
def test_spmm_bwd_replay_matches_plain_on_every_row(rng, C):
    for label, band in _spmm_bands(rng):
        nB, BLK, W = band.shape
        ix = bops.build_band_index(band)
        if label.startswith("dense"):
            assert int(np.diff(ix.t_ptr).max()) > CHUNK
        d_out = rng.standard_normal((2, nB * BLK, C)).astype(F32)
        got = spmm_bwd_replay(ix, d_out, vec=C % 4 == 0)
        ref = bs.band_spmm_bwd_plain(torch.from_numpy(band), torch.from_numpy(d_out)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5, err_msg=f"{label} C{C}")


@pytest.mark.parametrize("layout", ["minitown", "random"])
def test_spmm_bwd_replay_matches_pallas_spmm_vjp(rng, layout):
    """An int8 count band and its f32 copy share one index (the values ride
    in it as f32); the replay over it against the vjp of make_band_spmm_flash
    (interpret mode) for either band."""
    adj = _layout(layout, rng)
    cnt = (adj * rng.integers(1, 4, adj.shape)).astype(np.int8)
    ix = bops.build_band_index(cnt)
    np.testing.assert_array_equal(ix.t_val, bops.build_band_index(cnt.astype(F32)).t_val)
    nB, BLK, W = cnt.shape
    d_out = rng.standard_normal((2, nB * BLK, 128)).astype(F32)
    got = spmm_bwd_replay(ix, d_out)
    spmm = make_band_spmm_flash(nB, BLK, W, (W - BLK) // 2, interpret=True)
    x0 = jnp.zeros((2, nB * BLK + W - BLK, 128), jnp.float32)
    for band in (cnt, cnt.astype(F32)):
        _, vjp = jax.vjp(lambda x: spmm(jnp.asarray(band), x), x0)
        (ref,) = vjp(jnp.asarray(d_out))
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=3e-5, err_msg=str(band.dtype))


# ---- the index, and the replays' power to fail ----------------------------------------

@pytest.mark.parametrize("dtype", [np.int8, np.float32])
def test_band_index_carries_the_values_in_column_order(rng, dtype):
    on = _layout("wide", rng)
    band = (on * (rng.integers(1, 4, on.shape) if dtype == np.int8 else rng.random(on.shape)))
    ix = bops.build_band_index(band.astype(dtype))
    assert ix.t_val.dtype == np.float32 and ix.t_val.shape == (ix.nnz,)
    np.testing.assert_array_equal(ix.t_val, ix.val[ix.t_entry])
    blk, r = ix.t_row // ix.BLK, ix.t_row % ix.BLK
    e = np.repeat(np.arange(len(ix.t_ptr) - 1), np.diff(ix.t_ptr))
    np.testing.assert_array_equal(ix.t_val, band.astype(dtype)[blk, r, e - blk * ix.BLK].astype(F32))
    moved = ix.to("cpu")
    assert isinstance(moved.t_val, torch.Tensor) and moved.t_val.dtype == torch.float32
    assert torch.equal(moved.t_val, torch.from_numpy(ix.t_val))


@pytest.mark.parametrize("mutation", ["sign", "padded_rows", "summed_past_cnt"])
def test_a_mutated_replay_fails(rng, mutation):
    """The checks above see a wrong sign test (> for >=: a third of the
    nodes are zeroed, so a_dst + a_src == 0 occurs), a dropped S term, and
    the repeated loads past a chunk's end summed."""
    adj = _layout("padded", rng)
    if mutation == "summed_past_cnt":
        d_out = rng.standard_normal((2, adj.shape[0] * adj.shape[1], 8)).astype(F32)
        got = spmm_bwd_replay(bops.build_band_index(adj.astype(F32)), d_out, summed_past_cnt=True)
        assert not np.array_equal(got, ascending_sum(adj.astype(F32), d_out))
        return
    ix = bops.build_band_index(adj)
    args = _flash_inputs(rng, adj, 2, 2, 4)
    kw = {"sign": np.greater} if mutation == "sign" else {"padded_rows": False}
    got, _ = flash_backward_replay(ix, *args, **kw)
    ref = _plain_flash_backward(*args[:3], adj, *args[3:])
    assert not all(np.allclose(g, r, **TOL) for g, r in zip(got, ref))
