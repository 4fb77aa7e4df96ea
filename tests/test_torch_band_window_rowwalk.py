"""PyTorch port: the window route's forward (``csrc/band_attention_window.cu``,
v1), which runs v2's row walk (``csrc/band_rowwalk.cuh``) with x read in
window layout (``kWindow``): row j of block blk's window is x_win[blk, b, j]
where v2 reads x_ext[b, blk·BLK + j], in the walk and in the padded rows'
window-mean pre-pass alike. A CUDA kernel cannot run here, so the walk is
replayed in numpy: v2's replay (``test_torch_band_rowlist.py``) with its row
reader switched to x_win. It is held against the plain version on every row,
against the JAX package's v1 Pallas kernel (``make_band_attention``,
interpret mode) on the real rows, and against v2's replay on an x_win cut
from x_ext, bit for bit: the same walk, summed in the same order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_pressure_estimation_tpu.ops.pallas.band_attention import make_band_attention
from gnn_pressure_estimation_tpu_torch.ops import band_attention as ba
from gnn_pressure_estimation_tpu_torch.ops import banded as bops
from test_torch_band_rowlist import (
    ATTN_SHAPES, CHUNK, FWD, _layout_masks, _operands, attention_replay,
)

torch.set_num_threads(1)
LAYOUTS = ["minitown", "random", "wide", "padded"]


def window_replay(ix, a_dst, a_src, x_win, slope, block_of=lambda blk: blk):
    """``csrc/band_attention_window.cu`` in numpy: v2's walk reading the rows
    of block blk's window from x_win[blk]. ``block_of`` is a mutation: the
    window whose rows a block reads."""
    return attention_replay(ix, a_dst, a_src, x_win, slope,
                            rows=lambda blk, js: x_win[block_of(blk)][:, js])


def _layout(rng, layout):
    return next(t for t in _layout_masks(rng) if t[0] == layout)[1]


def _windows(ix, x_ext):
    return bops.band_windows_ext(torch.from_numpy(x_ext), ix.nB, ix.BLK, ix.W).contiguous().numpy()


def _plain(a_dst, a_src, x_win, adj):
    return ba.band_attention_window_plain(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in (a_dst, a_src, x_win, adj)), 0.2).numpy()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_window_replay_matches_plain_on_every_row(rng, layout):
    adj = _layout(rng, layout)
    ix = bops.build_band_index(adj)
    if layout == "wide":
        assert int(np.diff(ix.row_ptr).max()) > 2 * CHUNK       # three chunks: two rescales
    if layout in ("random", "padded"):
        assert ix.empty_row.size > 0                            # padded rows: the pre-pass runs
    for B, H, C in ATTN_SHAPES:
        a_dst, a_src, x_ext = _operands(rng, adj, B, H, C)
        x_win = _windows(ix, x_ext)
        got = window_replay(ix, a_dst, a_src, x_win, 0.2)
        np.testing.assert_allclose(got, _plain(a_dst, a_src, x_win, adj),
                                   err_msg=f"{layout} B{B} H{H} C{C}", **FWD)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_window_replay_equals_the_v2_replay_bit_for_bit(rng, layout):
    """On x_win = band_windows_ext(x_ext) the window walk reads the same
    values in the same order as v2's, padded rows' means included."""
    adj = _layout(rng, layout)
    ix = bops.build_band_index(adj)
    for B, H, C in ATTN_SHAPES:
        a_dst, a_src, x_ext = _operands(rng, adj, B, H, C)
        got = window_replay(ix, a_dst, a_src, _windows(ix, x_ext), 0.2)
        np.testing.assert_array_equal(got, attention_replay(ix, a_dst, a_src, x_ext, 0.2),
                                      err_msg=f"{layout} B{B} H{H} C{C}")


@pytest.mark.parametrize("layout", ["random", "wide", "padded"])
@pytest.mark.parametrize("H,C", [(1, 128), (2, 64)])
def test_window_replay_matches_pallas_v1_on_real_rows(rng, layout, H, C):
    """Real rows only: the Pallas kernel averages a padded row over W padded
    to 128, the port over W (``ROADMAP.md``, divergences in force). ``wide``
    has rows past 32 entries; ``random`` and ``padded`` have padded rows."""
    adj = _layout(rng, layout)
    nB, BLK, W = adj.shape
    ix = bops.build_band_index(adj)
    a_dst, a_src, x_ext = _operands(rng, adj, 2, H, C)
    x_win = _windows(ix, x_ext)
    got = window_replay(ix, a_dst, a_src, x_win, 0.2)
    v1 = make_band_attention(nB, BLK, W, 0.2, interpret=True)
    ker = np.asarray(v1(jnp.asarray(a_dst), jnp.asarray(a_src), jnp.asarray(x_win), jnp.asarray(adj)))
    valid = adj.any(-1).reshape(-1)
    assert not valid.all() or layout == "wide"
    np.testing.assert_allclose(got[:, valid], ker[:, valid], **FWD)


def test_a_replay_that_reads_another_blocks_window_fails(rng):
    """The checks above see a walk that reads block blk's rows from the
    window of block blk − 1 (a window offset off by one block): on a
    template's band, whose windows overlap by W − BLK rows."""
    adj = _layout(rng, "random")
    ix = bops.build_band_index(adj)
    a_dst, a_src, x_ext = _operands(rng, adj, 2, 2, 32)
    x_win = _windows(ix, x_ext)
    got = window_replay(ix, a_dst, a_src, x_win, 0.2, block_of=lambda blk: max(blk - 1, 0))
    assert not np.allclose(got, _plain(a_dst, a_src, x_win, adj), **FWD)

