"""PyTorch port: the walk of the dense factored pair, ``csrc/dense_walk.cuh``
(run by ``csrc/fused_factored.cu`` over the mask index's row lists and by
``csrc/fused_factored_bwd.cu`` over its column lists), replayed lane by lane
in numpy: one warp per (graph, node) for all heads, head groups of 32 gate
bits, channel tiles of at most 256 channels, a lane's channels 32 apart,
the list in chunks of 32 entries with the first chunk kept across tiles,
and the rows of several entries loaded ahead of their adds.

The replay is held bit for bit to the walk of one (graph, row, head) at a
time (``walk_the_index`` in ``test_torch_graph_attention.py``), to the plain
versions at rtol / atol 1e-5, and to the Pallas kernel ``make_fused_factored``
(interpret mode) at that file's tolerances. Mutated replays must fail.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_pressure_estimation_tpu.ops.pallas.graph_attention import make_fused_factored
from gnn_pressure_estimation_tpu_torch.ops import graph_attention as ga
from test_torch_graph_attention import F_ATOL, F_RTOL, G_ATOL, G_RTOL, _bhn, _mask, walk_the_index

torch.set_num_threads(1)

# csrc/dense_walk.cuh: kGateHeads, kFloatsAhead, kMaxTile
GATE_HEADS, FLOATS_AHEAD, MAX_TILE = 32, 8, 256


def walk_plan(H, D):
    """(NE, ahead): elements a lane in one channel tile (32·NE channels) and
    entries loaded ahead, as ``dense_walk`` picks them: the widest head
    group's channels spread evenly over as few tiles of at most 256 as that
    allows."""
    gw = min(H, GATE_HEADS) * D
    tiles = -(-gw // MAX_TILE)
    ne = -(-(-(-gw // tiles)) // 32)
    return ne, max(1, FLOATS_AHEAD // ne)


def replay(ptr, idx, own, other, x_pos, x_neg, mutation=None):
    """``dense_walk_kernel`` over every warp (graph b vectorised), lane by
    lane. Returns (out_pos, out_neg) [B, n, H, D]; fails unless each output
    element is written exactly once. ``mutation`` breaks one step on purpose:
    "strict_gate" (> for >=), "stale_chunk" (every chunk reuses the first
    chunk's entries), "unguarded_ahead" (the clamped entries past the chunk's
    end are added)."""
    B, n, H, D = x_pos.shape
    HD = H * D
    xp, xn = x_pos.reshape(B, n, HD), x_neg.reshape(B, n, HD)
    out_p = np.full((B, n, HD), np.nan, np.float32)
    out_n = np.full((B, n, HD), np.nan, np.float32)
    writes = np.zeros((n, HD), np.int64)
    ne, ahead = walk_plan(H, D)
    lanes = np.arange(32)

    def gate_chunk(u, k, k1, h0, hg):
        on = k < k1
        w = np.where(on, idx[np.clip(k, 0, max(len(idx) - 1, 0))], 0)
        word = np.zeros((B, 32), np.int64)
        for h in range(hg):
            s = own[:, u, h0 + h][:, None] + other[:, w, h0 + h]      # [B, 32], one f32 add
            bit = s > 0 if mutation == "strict_gate" else s >= 0
            word |= np.where(on & bit, 1 << h, 0)
        return w, word

    for u in range(n):
        k0, k1 = int(ptr[u]), int(ptr[u + 1])
        for h0 in range(0, H, GATE_HEADS):
            hg = min(GATE_HEADS, H - h0)
            ce = (h0 + hg) * D
            w_first, word_first = gate_chunk(u, k0 + lanes, k1, h0, hg)
            for c0 in range(h0 * D, ce, 32 * ne):
                ch = c0 + 32 * np.arange(ne)[:, None] + lanes[None, :]     # [ne, 32]
                inr = ch < ce
                chc = np.where(inr, ch, 0)
                hbit = np.where(inr, 1 << (chc // D - h0), 0)
                accp = np.zeros((B, *ch.shape), np.float32)
                accn = np.zeros((B, *ch.shape), np.float32)
                for s0 in range(k0, k1, 32):
                    if s0 == k0 or mutation == "stale_chunk":
                        wl, wordl = w_first, word_first
                    else:
                        wl, wordl = gate_chunk(u, s0 + lanes, k1, h0, hg)
                    cnt = min(32, k1 - s0)
                    for g in range(0, cnt, ahead):
                        loaded = []                    # every load of the group before any add
                        for q in range(ahead):
                            if g + q >= cnt and mutation != "unguarded_ahead":
                                continue
                            s = min(g + q, cnt - 1)
                            pos = (wordl[:, s][:, None, None] & hbit) != 0
                            row = wl[s]
                            loaded.append((pos, np.where(pos, xp[:, row][:, chc], xn[:, row][:, chc])))
                        for pos, x in loaded:
                            accp = np.where(inr & pos, accp + x, accp)
                            accn = np.where(inr & ~pos, accn + x, accn)
                out_p[:, u, ch[inr]] = accp[:, inr]
                out_n[:, u, ch[inr]] = accn[:, inr]
                np.add.at(writes[u], ch[inr], 1)
    assert (writes == 1).all(), "an output element was written twice or not at all"
    return out_p.reshape(B, n, H, D), out_n.reshape(B, n, H, D)


def replay_pair(ix, a_dst, a_src, rv, rq, g_pv, g_nq, mutation=None):
    """(t_pv, t_nq, d_rv, d_rq) as the two kernels compute them."""
    fwd = replay(ix.row_ptr, ix.col, a_dst, a_src, rv, rq, mutation)
    bwd = replay(ix.t_ptr, ix.t_row, a_src, a_dst, g_pv, g_nq, mutation)
    return (*fwd, *bwd)


def _dense_mask(rng, n, p):
    """A one-way random mask of density ``p`` with its diagonal: rows and
    columns of more than 32 entries at n 70, p 0.6."""
    m = rng.random((n, n)) < p
    np.fill_diagonal(m, True)
    assert not (m == m.T).all()
    return m


def _operands(rng, B, n, H, D):
    """a_dst, a_src with every third node zeroed (a_d + a_s == 0 where two
    of them meet), and four wide operands [B, n, H, D]."""
    a_dst = rng.standard_normal((B, n, H)).astype(np.float32)
    a_src = rng.standard_normal((B, n, H)).astype(np.float32)
    a_dst[:, ::3] = 0.0
    a_src[:, ::3] = 0.0
    wide = [rng.standard_normal((B, n, H, D)).astype(np.float32) for _ in range(4)]
    return a_dst, a_src, wide


# n, H, D, B, mask (density or kind)
CASES = [
    (26, 1, 5, 2, "one_way"),           # H 1, one element a lane
    (26, 2, 33, 2, "one_way"),          # small conv1: H·D 66, NE 3
    (26, 1, 129, 2, "symmetric"),       # large conv2: NE 5
    (24, 2, 129, 1, "symmetric"),       # large conv1: H·D 258, two tiles (160 + 98)
    (24, 1, 300, 1, "one_way"),         # two tiles of one head
    (20, 33, 3, 2, "one_way"),          # past a head group: groups of 96 and 3 channels
    (20, 34, 3, 1, "symmetric"),        # groups of 96 and 6 channels
    (70, 2, 5, 2, 0.6),                 # rows and columns past 32 entries
    (70, 2, 33, 1, 0.6),
]


def _case(rng, n, H, D, B, kind):
    mask = _dense_mask(rng, n, kind) if isinstance(kind, float) else _mask(rng, n, kind)
    ix = ga.build_mask_index(mask)
    a_dst, a_src, wide = _operands(rng, B, n, H, D)
    s = a_dst[:, :, None, :] + a_src[:, None, :, :]
    assert ((s == 0) & mask[None, :, :, None]).any()           # the >= side of the sign test
    return mask, ix, a_dst, a_src, wide


@pytest.mark.parametrize("n,H,D,B,kind", CASES)
def test_replay_equals_the_one_head_walk_and_the_plain_versions(rng, n, H, D, B, kind):
    mask, ix, a_dst, a_src, wide = _case(rng, n, H, D, B, kind)
    if isinstance(kind, float):
        assert np.diff(ix.row_ptr).max() > 32 and np.diff(ix.t_ptr).max() > 32
    got = replay_pair(ix, a_dst, a_src, *wide)
    want = walk_the_index(ix, a_dst, a_src, *wide)
    for name, g, w in zip(("t_pv", "t_nq", "d rhs_v", "d rhs_q"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    tm = torch.from_numpy(mask)
    a, b, rv, rq, g_pv, g_nq = (torch.from_numpy(x) for x in (a_dst, a_src, *wide))
    plain = (*ga.fused_factored_plain(a, b, rv, rq, tm), *ga.fused_factored_bwd_plain(a, b, tm, g_pv, g_nq))
    for name, g, w in zip(("t_pv", "t_nq", "d rhs_v", "d rhs_q"), got, plain):
        np.testing.assert_allclose(g, w.numpy(), rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("n,H,D,B,kind", [CASES[1], CASES[3], CASES[6]])
def test_replay_matches_pallas_kernel(rng, n, H, D, B, kind):
    """At water-network densities (a few entries a row). The rows of 40-odd
    entries of the 0.6-dense masks sum in another order than the kernel's
    MXU product, beyond F_ATOL on an element that nearly cancels; those shapes
    are held to the one-head walk bit for bit and to the plain versions."""
    mask, ix, a_dst, a_src, (rv, rq, g_pv, g_nq) = _case(rng, n, H, D, B, kind)
    t_pv, t_nq, d_rv, d_rq = replay_pair(ix, a_dst, a_src, rv, rq, g_pv, g_nq)
    agg = make_fused_factored(mask, interpret=True)
    out, vjp = jax.vjp(agg, jnp.asarray(a_dst), jnp.asarray(_bhn(a_src)), jnp.asarray(_bhn(rv)),
                       jnp.asarray(_bhn(rq)))
    _, _, j_rv, j_rq = vjp((jnp.asarray(_bhn(g_pv)), jnp.asarray(_bhn(g_nq))))
    for name, g, w in (("t_pv", t_pv, out[0]), ("t_nq", t_nq, out[1])):
        np.testing.assert_allclose(g, _bhn(np.asarray(w)), rtol=F_RTOL, atol=F_ATOL, err_msg=name)
    for name, g, w in (("d rhs_v", d_rv, j_rv), ("d rhs_q", d_rq, j_rq)):
        np.testing.assert_allclose(g, _bhn(np.asarray(w)), rtol=G_RTOL, atol=G_ATOL, err_msg=name)


@pytest.mark.parametrize("mutation", ["strict_gate", "stale_chunk", "unguarded_ahead"])
def test_mutated_replay_fails(rng, mutation):
    """The replay sees each slip it stands guard for: the sign test's edge,
    rows past one chunk, the clamped entries of a group of loads ahead."""
    mask, ix, a_dst, a_src, wide = _case(rng, 70, 2, 5, 2, 0.6)
    got = replay_pair(ix, a_dst, a_src, *wide, mutation)
    want = walk_the_index(ix, a_dst, a_src, *wide)
    assert not any(np.allclose(g, w, rtol=1e-5, atol=1e-5) for g, w in zip(got, want))


def test_walk_plan_at_the_dense_layers():
    """Elements a lane and loads ahead at GATRes's dense convs (D = C + 1):
    small conv1 and conv2, large conv2 and conv1 (two tiles of 160 and 98
    channels), and a head group of 32 heads."""
    assert [walk_plan(H, D) for H, D in ((2, 33), (1, 33), (1, 129), (2, 129), (40, 4))] == [
        (3, 2), (2, 4), (5, 1), (5, 1), (4, 2)]
