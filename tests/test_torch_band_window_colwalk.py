"""PyTorch port: the two band-attention backwards that now run v2's passes
(``csrc/band_bwd.cuh``): the window route's ``csrc/band_attention_window_bwd.cu``
(v1), whose columns pass walks the column in window layout, and the acc
route's ``csrc/band_attention_acc_bwd.cu`` (v3), which is v2's backward under
its own entry point. A CUDA kernel cannot run here, so each is replayed in
numpy in the kernel's order and held against the plain versions on every row
and against the JAX package's Pallas kernels (interpret mode) on the real
rows.

The window replay is v2's (``test_torch_band_rowlist_bwd.py``: its weights,
rows and cells passes, and its column walk lane by lane) with the columns
pass in window layout: the warp that owns extended row e takes the covering
blocks in ascending order, finds each block's run of e's entries (a ballot
over 32 at a time: the entries are sorted by (e, g)), loads x_win[blk, b, j]
where the run holds an entry, walks the run, adds S of the block and writes
d x_win[blk, b, j] once, a zero row where the run is empty."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_pressure_estimation_tpu.ops.pallas.band_attention import (
    make_band_attention,
    make_band_attention_acc,
)
from gnn_pressure_estimation_tpu_torch.ops import band_attention as ba
from gnn_pressure_estimation_tpu_torch.ops import banded as bops
from test_torch_band_rowlist_bwd import (
    CHUNK, F32, TOL, _layout, _operands, _plain_backward, backward_replay, cells_pass,
    column_tiles, covering_blocks, empties_pass, rows_pass, walk_run, weights_pass,
)

torch.set_num_threads(1)


def run_end(ix, s, t1, blk):
    """The end of block blk's run of entries from s: per 32 entries, the
    lanes whose entry (before t1) lies in a block up to blk are a prefix."""
    while True:
        t = np.arange(s, s + CHUNK)
        n = int(np.count_nonzero((t < t1) & (ix.t_row[np.minimum(t, t1 - 1)] // ix.BLK <= blk)))
        if n < CHUNK:
            return s + n
        s += CHUNK


def window_columns_pass(ix, x_win, d_out, p, S, vec, summed_across_blocks=False,
                        empty_runs_skipped=False):
    """d x_win [nB, B, W, H, C] and dp [B, nnz, H], one warp per extended row
    e, one run per covering block. The two flags are mutations: the sums
    carried from one block's cell into the next, and the cells of a block with
    no entry at e left unwritten."""
    nB, B, W, H, C = x_win.shape
    HC, n_pad = H * C, ix.nB * ix.BLK
    xw, d2 = x_win.reshape(nB, B, W, HC), d_out.reshape(B, n_pad, HC)
    whole = vec and C % 128 == 0
    dp = np.full((B, ix.nnz, H), np.nan, F32)
    dx = np.full((nB, B, W, HC), np.nan, F32)
    for e in range(n_pad + W - ix.BLK):
        t0, t1 = int(ix.t_ptr[e]), int(ix.t_ptr[e + 1])
        for h0, hg, c0, tile in column_tiles(H, C, vec):
            valid, cc = tile["valid"], tile["cc"]
            s, acc = t0, np.zeros((B,) + cc.shape, F32)
            for blk in covering_blocks(ix, e):
                j = e - blk * ix.BLK
                r_hi = run_end(ix, s, t1, blk)
                if r_hi > s:
                    xv = np.where(valid, xw[blk, :, j][:, cc], 0).astype(F32)
                    acc = walk_run(ix, d2, p, dp, tile, h0, hg, c0 == h0 * C, xv, acc, s, r_hi, whole)
                if blk in S:
                    acc = (acc + np.where(valid, S[blk][:, cc], 0)).astype(F32)
                if r_hi > s or not empty_runs_skipped:
                    dx[blk, :, j][:, cc[valid]] = acc[:, valid]
                if not summed_across_blocks:
                    acc = np.zeros_like(acc)
                s = r_hi
            assert s == t1, "the runs did not cover the column"
    return dx.reshape(nB, B, W, H, C), dp


def window_backward_replay(ix, a_dst, a_src, x_win, d_out, vec=True, **mutation):
    """``csrc/band_attention_window_bwd.cu`` in numpy: (d a_dst, d a_src_win,
    d x_win) and the [B, nnz, H] scratch (p, dz)."""
    p = weights_pass(ix, a_dst, a_src)
    d_x, dp = window_columns_pass(ix, x_win, d_out, p, empties_pass(ix, d_out),
                                  vec and x_win.shape[-1] % 4 == 0, **mutation)
    dz, d_ad = rows_pass(ix, a_dst, a_src, p, dp)
    return (d_ad, cells_pass(ix, dz, *a_dst.shape[::2]), d_x), (p, dz)


def _window_layout(kind, rng):
    """The layouts of ``test_torch_band_rowlist_bwd``, and ``tall``: blocks of
    40 rows, 90% dense, so a block's run at one extended row passes 32 entries
    (a run holds at most BLK entries)."""
    if kind == "tall":
        return rng.random((3, 40, 72)) < 0.9
    return _layout(kind, rng)


def _windows(ix, x_ext):
    return bops.band_windows_ext(torch.from_numpy(x_ext), ix.nB, ix.BLK, ix.W).contiguous().numpy()


def _plain_window_backward(a_dst, a_src, x_win, adj, d_out):
    return [t.numpy() for t in ba.band_attention_window_bwd_plain(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in (a_dst, a_src, x_win, adj, d_out)),
        negative_slope=0.2)]


# (B, H, C) per layout: C 128 at H 1-2 (the butterfly), C 160 and 256 (past
# one 128-channel tile; two float4 a lane), C 32 (segments inside a row of
# lanes), C 4 at H 40 (five head groups), C 33 and 3 (scalar slots). The
# padded layout has fully masked rows and W 70, not a multiple of BLK 16;
# wide rows of ~80 entries; random a template's sparse band (most cells of
# d x_win have no entry); tall runs of more than 32 entries, so a block's
# run crosses a chunk of 32 and its end takes two ballots
WINDOW_SHAPES = {
    "padded": [(2, 1, 128), (1, 2, 128), (2, 1, 160), (2, 2, 32), (1, 40, 4), (2, 3, 33)],
    "wide": [(1, 2, 128), (1, 1, 256), (2, 3, 3)],
    "random": [(1, 2, 128), (2, 3, 33)],
    "tall": [(1, 2, 128), (2, 2, 4), (1, 3, 3)],
}


@pytest.mark.parametrize("layout", list(WINDOW_SHAPES))
def test_window_replay_matches_plain_on_every_row(rng, layout):
    adj = _window_layout(layout, rng)
    ix = bops.build_band_index(adj)
    if layout == "tall":
        runs = [run_end(ix, int(ix.t_ptr[e]), int(ix.t_ptr[e + 1]), 0) - int(ix.t_ptr[e])
                for e in range(ix.BLK)]
        assert max(runs) > CHUNK                                # a run of block 0 past 32 entries
    if layout == "wide":
        assert int(np.diff(ix.row_ptr).max()) > 2 * CHUNK      # rows past 32 entries
    if layout in ("padded", "random"):
        assert ix.empty_row.size > 0                            # S of the padded rows
    for B, H, C in WINDOW_SHAPES[layout]:
        a_dst, a_src, x_ext, d_out = _operands(rng, adj, B, H, C)
        x_win = _windows(ix, x_ext)
        got, _ = window_backward_replay(ix, a_dst, a_src, x_win, d_out)
        ref = _plain_window_backward(a_dst, a_src, x_win, adj, d_out)
        for name, g, r in zip(("d a_dst", "d a_src_win", "d x_win"), got, ref):
            np.testing.assert_allclose(g, r, err_msg=f"{layout} B{B} H{H} C{C} {name}", **TOL)


@pytest.mark.parametrize("layout,vec", [("padded", True), ("tall", False)])
def test_window_d_as_are_the_v2_replays_bit_for_bit(rng, layout, vec):
    """On x_win = band_windows_ext(x_ext) the window walk forms each dp from
    the same values in the same lane order as v2's: d a_dst and d a_src_win
    equal the v2 replay's bit for bit, and the folded d x_win lies within
    1e-4 of v2's d x_ext (the covering blocks' sums add in another order)."""
    adj = _window_layout(layout, rng)
    ix = bops.build_band_index(adj)
    for B, H, C in ((2, 2, 128), (1, 3, 33), (2, 1, 160)):
        a_dst, a_src, x_ext, d_out = _operands(rng, adj, B, H, C)
        (d_ad, d_as, d_xw), (p, dz) = window_backward_replay(ix, a_dst, a_src, _windows(ix, x_ext),
                                                             d_out, vec=vec)
        (v2_ad, v2_as, v2_x), (v2_p, v2_dz) = backward_replay(ix, a_dst, a_src, x_ext, d_out, vec=vec)
        label = f"{layout} B{B} H{H} C{C}"
        for name, g, r in (("d a_dst", d_ad, v2_ad), ("d a_src_win", d_as, v2_as), ("p", p, v2_p),
                           ("dz", dz, v2_dz)):
            np.testing.assert_array_equal(g, r, err_msg=f"{label} {name}")
        folded = bops.fold_windows_ext(torch.from_numpy(d_xw), ix.BLK).numpy()
        np.testing.assert_allclose(folded, v2_x, rtol=1e-4, atol=1e-4, err_msg=f"{label} d x")


@pytest.mark.parametrize("H,C", [(1, 128), (2, 64)])
def test_window_replay_matches_pallas_v1_on_real_rows(rng, H, C):
    """Against jax.vjp through make_band_attention (v1, interpret mode), in
    window layout on both sides, the padded rows' cotangent zeroed: the
    Pallas kernel averages them over W padded to 128, the port over W."""
    adj = _layout("padded", rng)
    nB, BLK, W = adj.shape
    ix = bops.build_band_index(adj)
    a_dst, a_src, x_ext, d_out = _operands(rng, adj, 2, H, C)
    d_out = d_out * adj.any(-1).reshape(-1)[None, :, None, None].astype(F32)
    x_win = _windows(ix, x_ext)
    got, _ = window_backward_replay(ix, a_dst, a_src, x_win, d_out)
    v1 = make_band_attention(nB, BLK, W, 0.2, interpret=True)
    _, vjp = jax.vjp(lambda *a: v1(*a, jnp.asarray(adj)),
                     jnp.asarray(a_dst), jnp.asarray(a_src), jnp.asarray(x_win))
    for name, g, r in zip(("d a_dst", "d a_src_win", "d x_win"), got, vjp(jnp.asarray(d_out))):
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g, np.asarray(r), err_msg=name, **TOL)


@pytest.mark.parametrize("H,C", [(1, 128), (2, 64)])
def test_v2_replay_matches_pallas_acc_on_real_rows(rng, H, C):
    """The acc route's backward is v2's passes: their replay against jax.vjp
    through make_band_attention_acc (v3, interpret mode), whose sliding
    accumulator writes d x_ext with no fold, the padded rows' cotangent zeroed
    (the Pallas kernel averages them over W padded to 128)."""
    adj = _layout("padded", rng)
    nB, BLK, W = adj.shape
    ix = bops.build_band_index(adj)
    a_dst, a_src, x_ext, d_out = _operands(rng, adj, 2, H, C)
    d_out = d_out * adj.any(-1).reshape(-1)[None, :, None, None].astype(F32)
    got, _ = backward_replay(ix, a_dst, a_src, x_ext, d_out)
    v3 = make_band_attention_acc(nB, BLK, W, (W - BLK) // 2, 0.2, interpret=True)
    assert v3 is not None
    _, vjp = jax.vjp(lambda *a: v3(*a, jnp.asarray(adj)),
                     jnp.asarray(a_dst), jnp.asarray(a_src), jnp.asarray(x_ext))
    for name, g, r in zip(("d a_dst", "d a_src_win", "d x_ext"), got, vjp(jnp.asarray(d_out))):
        np.testing.assert_allclose(g, np.asarray(r), err_msg=name, **TOL)
    # and on every row against the plain version, which the acc wrapper takes on the CPU
    ref = _plain_backward(a_dst, a_src, x_ext, adj, d_out)
    for name, g, r in zip(("d a_dst", "d a_src_win", "d x_ext"), got, ref):
        np.testing.assert_allclose(g, r, err_msg=name, **TOL)


@pytest.mark.parametrize("mutation", ["summed_across_blocks", "empty_runs_skipped"])
def test_a_mutated_window_replay_fails(rng, mutation):
    """The checks above see a walk that carries one block's sums into the
    next block's cell, and one that leaves the cells of a block with no entry
    at e (the zero rows, and the S rows of a block with padded rows)
    unwritten; on a template's sparse band, where most cells have no entry."""
    adj = _layout("random", rng)
    ix = bops.build_band_index(adj)
    assert ix.empty_row.size > 0
    a_dst, a_src, x_ext, d_out = _operands(rng, adj, 2, 2, 32)
    x_win = _windows(ix, x_ext)
    got, _ = window_backward_replay(ix, a_dst, a_src, x_win, d_out, **{mutation: True})
    ref = _plain_window_backward(a_dst, a_src, x_win, adj, d_out)
    assert not np.allclose(got[2], ref[2], **TOL)
