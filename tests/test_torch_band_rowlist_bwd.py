"""PyTorch port: v2's band-attention backward (``csrc/band_attention_bwd.cu``)
and the row statistics of the flash forward (``csrc/band_rowwalk.cuh``
through ``csrc/band_attention_flash.cu``). A CUDA kernel cannot run here, so
each walk is replayed in numpy in the kernel's order and held against the
plain versions on every row, and against the JAX package (its plain band ops
on every row, its Pallas kernels in interpret mode on the real rows).

The backward's replay follows its five passes: the weights p per entry (one
thread per row and head: a running max and sum over the row's list), the
padded rows' dO/W per block (8 warps, partials added in warp order), the
columns pass (one warp per extended row, chunks of 32 entries, dO rows staged
``stage_depth`` at a time, d x_ext = sum p dO + S, and dp per entry and head
reduced over the lanes that hold the head's channels: a segmented shuffle
scan, or the transposed butterfly when C is a multiple of 128), the rows
pass (delta, dz with the sign of a_dst + a_src, d a_dst) and the cells pass
(d a_src_win, segmented by block, every cell written). p, dp and dz are kept
as the kernel keeps them, ``[B, nnz, H]``."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_pressure_estimation_tpu.ops import banded as jax_bops
from gnn_pressure_estimation_tpu.ops.pallas.band_attention import (
    make_band_attention_dma,
    make_band_attention_flash,
)
from gnn_pressure_estimation_tpu_torch.core.graph import GraphTemplate
from gnn_pressure_estimation_tpu_torch.data.dataset import build_template, get_keep_list
from gnn_pressure_estimation_tpu_torch.data.inp import parse_inp
from gnn_pressure_estimation_tpu_torch.ops import band_attention as ba
from gnn_pressure_estimation_tpu_torch.ops import banded as bops
from helpers import random_graph

torch.set_num_threads(1)
MINITOWN = Path(__file__).resolve().parents[1] / "inputs" / "minitown.inp"
F32 = np.float32
SLOPE = F32(0.2)
CHUNK = 32              # entries a warp takes at once: one a lane
HEAD_GROUP = 8          # kHeadGroup of the backward
EMPTY_WARPS = 8         # warps of a thread block of the backward's first launch
LANES = np.arange(32)
TOL = dict(rtol=1e-4, atol=1e-5)


def stage_depth(NV):
    return 8 if NV == 1 else 6


def leaky(z):
    return np.where(z >= 0, z, SLOPE * z).astype(F32)


# ---- layouts and operands -----------------------------------------------------

def _layout(kind, rng):
    """[nB, BLK, W] bool masks: two templates' band layouts; ``wide``: rows of
    ~80 entries; ``padded``: fully masked rows at the end; ``dense``: columns
    that more than 32 entries read (two chunks of the columns pass)."""
    if kind == "minitown":
        wn = parse_inp(str(MINITOWN))
        tpl = build_template(wn, get_keep_list(wn, "keep_junction", None, "pressure"), None)[0]
        return tpl.band_layout(8).adj_mask
    if kind == "random":
        jt = random_graph(np.random.default_rng(3), n=70, extra_edges=40)
        return GraphTemplate(jt.n_node, jt.senders, jt.receivers).band_layout(16).adj_mask
    if kind == "wide":
        return rng.random((2, 16, 200)) < 0.4
    if kind == "dense":
        return rng.random((4, 16, 48)) < 0.95
    adj = rng.random((3, 16, 70)) < 0.3
    adj[-1, -5:] = False
    return adj


def _operands(rng, adj, B, H, C):
    """a_dst, a_src_win, x_ext, d_out from the seed; a third of the nodes
    zeroed so that a_dst + a_src == 0 occurs."""
    nB, BLK, W = adj.shape
    n_pad, n_ext = nB * BLK, nB * BLK + W - BLK
    a_dst = rng.standard_normal((B, n_pad, H)).astype(F32)
    a_src = rng.standard_normal((nB, B, W, H)).astype(F32)
    a_dst[:, ::3] = 0.0
    a_src[:, :, ::3] = 0.0
    return (a_dst, a_src, rng.standard_normal((B, n_ext, H, C)).astype(F32),
            rng.standard_normal((B, n_pad, H, C)).astype(F32))


# ---- the backward, pass by pass -------------------------------------------------

def weights_pass(ix, a_dst, a_src):
    """p [B, nnz, H]: per row and head a running max and sum over the list in
    order, then exp(z - m) / Z per entry."""
    B, n_pad, H = a_dst.shape
    p = np.full((B, ix.nnz, H), np.nan, F32)
    for row in range(n_pad):
        blk = row // ix.BLK
        ks = range(ix.row_ptr[row], ix.row_ptr[row + 1])
        m, Z = np.full((B, H), -3e38, F32), np.zeros((B, H), F32)
        for k in ks:
            z = leaky(a_dst[:, row] + a_src[blk][:, ix.col[k]])
            m_new = np.maximum(m, z)
            Z = Z * np.exp(m - m_new) + np.exp(z - m_new)
            m = m_new
        for k in ks:
            p[:, k] = np.exp(leaky(a_dst[:, row] + a_src[blk][:, ix.col[k]]) - m) / Z
    return p


def empties_pass(ix, d_out):
    """S per block that holds padded rows: dO summed over them by 8 warps,
    each taking every 8th row, partials added in warp order, / W."""
    B, n_pad = d_out.shape[:2]
    d2 = d_out.reshape(B, n_pad, -1)
    S = {}
    for blk in range(ix.nB):
        rows = ix.empty_row[ix.empty_ptr[blk]: ix.empty_ptr[blk + 1]]
        if len(rows) == 0:
            continue
        total = np.zeros((B, d2.shape[2]), F32)
        for w in range(EMPTY_WARPS):
            part = np.zeros_like(total)
            for r in rows[w::EMPTY_WARPS]:
                part = part + d2[:, r]
            total = total + part
        S[blk] = total / F32(ix.W)
    return S


def segment_of(rb, width, h0, hg, ce, C):
    """Per lane of a row of lanes whose channels start at rb, `width` apart:
    (head, first lane of its segment, last lane of it?); head hg past ce."""
    c = rb + width * LANES
    hd = np.where(c < ce, c // C - h0, hg)
    lo = np.where(c < ce, np.maximum(0, ((h0 + hd) * C - rb) // width), LANES)
    last = (c < ce) & ((LANES == 31) | ((c + width) % C == 0))
    return hd, lo, last


def seg_scan(v, lo):
    """v [..., 32] summed over the lanes lo .. lane, Kogge-Stone with shfl_up."""
    for o in (1, 2, 4, 8, 16):
        u = np.concatenate([v[..., :o], v[..., :-o]], axis=-1)      # shfl_up: own value below o
        v = np.where(LANES - o >= lo, v + u, v).astype(F32)
    return v


def reduce_scatter(val):
    """val [B, V, 32] → [B, 32]: lane l holds the warp sum of value l >> (5 - log2 V)."""
    V = n = val.shape[1]
    o = 16
    while n > 1:
        up = (LANES & o) != 0
        val = np.stack([np.where(up, val[:, i + n // 2], val[:, i])
                        + np.where(up, val[:, i], val[:, i + n // 2])[:, LANES ^ o]
                        for i in range(n // 2)], axis=1)
        n, o = n // 2, o // 2
    r = val[:, 0]
    o = 32 // V // 2
    while o > 0:
        r = r + r[:, LANES ^ o]
        o //= 2
    return r


def column_tiles(H, C, vec):
    """The columns pass's tiles: per head group h0 .. h0+hg-1, its 128·NV
    channel tiles, each as the lanes hold it: the channels ``cc`` [R, 32,
    width] (R rows of lanes; float4 slots or scalars; 0 past the group) and
    where they are ``valid``, each channel's head in the group, each row's
    segments and, for the butterfly, each row's head. Yields (h0, hg, c0,
    tile)."""
    G = min(H, HEAD_GROUP)
    NV = 1 if G * C <= 128 else 2
    for h0 in range(0, H, G):
        hg = min(G, H - h0)
        ce = (h0 + hg) * C
        for c0 in range(h0 * C, ce, 128 * NV):
            if vec:
                rb = [c0 + 128 * v for v in range(NV)]
                chan = np.array([[b_ + 4 * LANES + w for w in range(4)] for b_ in rb]).transpose(0, 2, 1)
            else:
                rb = [c0 + 128 * v + 32 * j for v in range(NV) for j in range(4)]
                chan = np.array([b_ + LANES for b_ in rb])[..., None]
            width = 4 if vec else 1
            valid = chan < ce
            cc = np.where(valid, chan, 0)
            yield h0, hg, c0, dict(
                NV=NV, width=width, valid=valid, cc=cc, head=np.where(valid, cc // C - h0, 0),
                segs=[segment_of(b_, width, h0, hg, ce, C) for b_ in rb],
                head_row=[min(b_, ce - 1) // C - h0 for b_ in rb])


def walk_run(ix, d2, p, dp, tile, h0, hg, first, xv, acc, t0, t1, whole):
    """One run of a column walk: the entries t0 .. t1-1 (t_* order) in chunks
    of 32, their dO rows staged ``stage_depth`` at a time; returns acc + sum
    p dO over them, and adds this tile's part of their dp (against xv) into
    dp [B, nnz, H], the same lane owning an entry in every tile."""
    B = d2.shape[0]
    NV, width, valid, cc, head = (tile[k] for k in ("NV", "width", "valid", "cc", "head"))
    segs, head_row = tile["segs"], tile["head_row"]
    kA, depth = 4 // NV, stage_depth(NV)
    for s0 in range(t0, t1, CHUNK):
        ts = np.arange(s0, min(s0 + CHUNK, t1))
        g, k, cnt = ix.t_row[ts], ix.t_entry[ts], len(ts)
        p_sh = p[:, k, h0:h0 + hg]
        dp_sh = np.zeros((B, cnt, hg), F32)
        for r0 in range(0, cnt, depth):
            n = min(depth, cnt - r0)
            for gq in range(0, n, kA):
                qq = [min(gq + q, n - 1) for q in range(kA)]
                a = np.where(valid, d2[:, g[[r0 + q for q in qq]]][:, :, cc], 0).astype(F32)
                part = ((a[..., 0] * xv[:, None, ..., 0]).astype(F32))
                for w in range(1, width):                          # the fma chain
                    part = (part + a[..., w] * xv[:, None, ..., w]).astype(F32)
                for q in range(kA):
                    if gq + q < n:
                        ps = p_sh[:, r0 + qq[q]]                    # [B, hg]
                        acc = (acc + ps[:, head] * a[:, q]).astype(F32)
                if whole:
                    r = reduce_scatter(part.reshape(B, kA * NV, 32))
                    for w_ in range(NV):                            # rows add in turn
                        for lane in (0, 8, 16, 24):
                            q, v = divmod(lane >> 3, NV)
                            if v == w_ and gq + q < n:
                                dp_sh[:, r0 + gq + q, head_row[v]] += r[:, lane]
                else:
                    t = seg_scan(part, np.stack([lo for _, lo, _ in segs]))
                    for q in range(kA):
                        if gq + q >= n:
                            continue
                        for row_, (hd, _, last) in enumerate(segs):
                            dp_sh[:, r0 + qq[q], hd[last]] += t[:, q, row_, last]
        prev = 0 if first else dp[:, k, h0:h0 + hg]
        dp[:, k, h0:h0 + hg] = prev + dp_sh
    return acc


def covering_blocks(ix, e):
    """The blocks whose window [blk·BLK, blk·BLK + W) holds extended row e."""
    blk_hi = min(ix.nB - 1, e // ix.BLK)
    return range((e - ix.W) // ix.BLK + 1 if e >= ix.W else 0, blk_hi + 1)


def columns_pass(ix, x_ext, d_out, p, S, vec):
    """d x_ext [B, n_ext, H, C] and dp [B, nnz, H], one warp per extended row."""
    B, n_ext, H, C = x_ext.shape
    HC, n_pad = H * C, ix.nB * ix.BLK
    x2, d2 = x_ext.reshape(B, n_ext, HC), d_out.reshape(B, n_pad, HC)
    whole = vec and C % 128 == 0
    dp = np.full((B, ix.nnz, H), np.nan, F32)
    dx = np.full((B, n_ext, HC), np.nan, F32)
    for e in range(n_ext):
        t0, t1 = int(ix.t_ptr[e]), int(ix.t_ptr[e + 1])
        for h0, hg, c0, tile in column_tiles(H, C, vec):
            valid, cc = tile["valid"], tile["cc"]
            xv = np.where(valid, x2[:, e][:, cc], 0).astype(F32)            # [B, R, 32, w]
            acc = walk_run(ix, d2, p, dp, tile, h0, hg, c0 == h0 * C, xv, np.zeros_like(xv),
                           t0, t1, whole)
            for blk in covering_blocks(ix, e):
                if blk in S:
                    acc = (acc + np.where(valid, S[blk][:, cc], 0)).astype(F32)
            dx[:, e][:, cc[valid]] = acc[:, valid]
    return dx.reshape(B, n_ext, H, C), dp


def rows_pass(ix, a_dst, a_src, p, dp, sign=np.greater_equal):
    """dz [B, nnz, H] over dp and d a_dst, one thread per row and head; the
    slope where the pre-activation a_dst + a_src fails ``sign`` (>= 0)."""
    B, n_pad, H = a_dst.shape
    dz = dp.copy()
    d_ad = np.zeros((B, n_pad, H), F32)
    for row in range(n_pad):
        blk = row // ix.BLK
        ks = range(ix.row_ptr[row], ix.row_ptr[row + 1])
        delta = np.zeros((B, H), F32)
        for k in ks:
            delta = (delta + p[:, k] * dp[:, k]).astype(F32)
        for k in ks:
            d = (p[:, k] * (dp[:, k] - delta)).astype(F32)
            zpre = a_dst[:, row] + a_src[blk][:, ix.col[k]]
            dz[:, k] = np.where(sign(zpre, 0), d, SLOPE * d)
            d_ad[:, row] += dz[:, k]
    return dz, d_ad


def cells_pass(ix, dz, B, H, block_of=lambda g, BLK: g // BLK):
    """d a_src_win [nB, B, W, H]: per extended row, its entries in order,
    summed block by block into each covering block's cell (0 where none)."""
    out = np.full((ix.nB, B, ix.W, H), np.nan, F32)
    for e in range(ix.nB * ix.BLK + ix.W - ix.BLK):
        blk_hi = min(ix.nB - 1, e // ix.BLK)
        blk = (e - ix.W) // ix.BLK + 1 if e >= ix.W else 0
        acc = np.zeros((B, H), F32)
        for t in range(ix.t_ptr[e], ix.t_ptr[e + 1]):
            bt = block_of(int(ix.t_row[t]), ix.BLK)
            while blk < bt:
                out[blk, :, e - blk * ix.BLK], acc, blk = acc, np.zeros((B, H), F32), blk + 1
            acc = acc + dz[:, ix.t_entry[t]]
        while blk <= blk_hi:
            out[blk, :, e - blk * ix.BLK], acc, blk = acc, np.zeros((B, H), F32), blk + 1
    assert not np.isnan(out).any(), "a cell of d a_src_win was not written"
    return out


def backward_replay(ix, a_dst, a_src, x_ext, d_out, vec=True, **mut):
    """``csrc/band_attention_bwd.cu`` in numpy: (d a_dst, d a_src_win, d x_ext)
    and the [B, nnz, H] scratch (p, dz)."""
    p = weights_pass(ix, a_dst, a_src)
    d_x, dp = columns_pass(ix, x_ext, d_out, p, empties_pass(ix, d_out), vec and x_ext.shape[-1] % 4 == 0)
    dz, d_ad = rows_pass(ix, a_dst, a_src, p, dp, **{k: v for k, v in mut.items() if k == "sign"})
    d_as = cells_pass(ix, dz, *a_dst.shape[::2], **{k: v for k, v in mut.items() if k == "block_of"})
    return (d_ad, d_as, d_x), (p, dz)


def _plain_backward(a_dst, a_src, x_ext, adj, d_out):
    return [t.numpy() for t in ba.band_attention_bwd_plain(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in (a_dst, a_src, x_ext, adj, d_out)),
        negative_slope=0.2)]


# (B, H, C) and the branch of the columns pass each takes: C 128 with one and
# two heads (the transposed butterfly, one and two float4 a lane); C 256 (two
# slots of one head); H 3 C 128 (a last tile half past the group); C 32 and
# C 160 (segments inside a row of lanes; C past 128 channels); C 4 at H 40
# (five head groups); C 33 and C 3 (scalar slots, one channel a lane)
SHAPES = [(2, 1, 128), (1, 2, 128), (1, 1, 256), (1, 3, 128), (2, 2, 32), (2, 1, 160),
          (1, 40, 4), (2, 3, 33), (1, 33, 3)]
LAYOUT_SHAPES = {"padded": SHAPES, "dense": [(1, 2, 128), (2, 3, 33)], "wide": [(1, 2, 128), (2, 3, 33)],
                 "minitown": [(2, 1, 128), (2, 3, 33)], "random": [(1, 2, 128), (1, 40, 4)]}


@pytest.mark.parametrize("layout", list(LAYOUT_SHAPES))
def test_backward_replay_matches_plain_on_every_row(rng, layout):
    adj = _layout(layout, rng)
    ix = bops.build_band_index(adj)
    if layout == "dense":
        assert int(np.diff(ix.t_ptr).max()) > CHUNK            # two chunks in the columns pass
    if layout == "wide":
        assert int(np.diff(ix.row_ptr).max()) > 2 * CHUNK      # rows past 32 entries
    if layout in ("padded", "random"):
        assert ix.empty_row.size > 0                            # S of the padded rows
    for B, H, C in LAYOUT_SHAPES[layout]:
        args = _operands(rng, adj, B, H, C)
        got, _ = backward_replay(ix, *args)
        ref = _plain_backward(*args[:3], adj, args[3])
        for name, g, r in zip(("d a_dst", "d a_src_win", "d x_ext"), got, ref):
            np.testing.assert_allclose(g, r, err_msg=f"{layout} B{B} H{H} C{C} {name}", **TOL)


def test_offset_view_takes_the_scalar_slots(rng):
    """An x_ext or d_out off 16-byte alignment takes the scalar slots (the
    wrapper's vector_loads); the replay of that branch at C 128 gives the same."""
    adj = _layout("padded", rng)
    ix = bops.build_band_index(adj)
    args = _operands(rng, adj, 2, 2, 64)
    got, _ = backward_replay(ix, *args, vec=False)
    for g, r in zip(got, _plain_backward(*args[:3], adj, args[3])):
        np.testing.assert_allclose(g, r, **TOL)
    x_off = torch.zeros(args[2].size + 1)[1:].view(args[2].shape)
    assert not bops.vector_loads(x_off, 64)


def test_scratch_holds_p_and_dz_by_entry(rng):
    """The [B, nnz, H] scratch: entry k of the index holds p and dz of its
    (block, row, column) for every head, as the plain version's dense tensors."""
    adj = _layout("padded", rng)
    ix = bops.build_band_index(adj)
    a_dst, a_src, x_ext, d_out = _operands(rng, adj, 2, 3, 8)
    _, (p, dz) = backward_replay(ix, a_dst, a_src, x_ext, d_out)
    t = [torch.from_numpy(a) for a in (a_dst, a_src, x_ext)]
    z, zpre, on = ba._logits(*t[:2], torch.from_numpy(adj), 0.2)
    m, Z = ba._row_stats(z)
    p_ref = (torch.exp(z - m) / Z).numpy()                                   # [nB, B, BLK, W, H]
    nB, BLK, W = adj.shape
    g = np.repeat(np.arange(nB * BLK), np.diff(ix.row_ptr))
    np.testing.assert_allclose(p, p_ref[g // BLK, :, g % BLK, ix.col].transpose(1, 0, 2), **TOL)
    d_ad, _, _ = _plain_backward(a_dst, a_src, x_ext, adj, d_out)
    rows_sum = np.stack([dz[:, ix.row_ptr[r]: ix.row_ptr[r + 1]].sum(1) for r in range(nB * BLK)], 1)
    np.testing.assert_allclose(rows_sum, d_ad, **TOL)


@pytest.mark.parametrize("H", [1, 2, 3])
@pytest.mark.parametrize("C", [3, 4])
def test_backward_replay_matches_jax_band_ops_on_every_row(rng, H, C):
    """Against jax.grad through the JAX package's plain band attention (the
    v2 Pallas kernel takes only H·C a multiple of 128: see the next test)."""
    adj = _layout("padded", rng)
    nB, BLK, W = adj.shape
    ix = bops.build_band_index(adj)
    a_dst, a_src, x_ext, d_out = _operands(rng, adj, 2, H, C)
    got, _ = backward_replay(ix, a_dst, a_src, x_ext, d_out)

    def f(ad, asr, xe):
        return jax_bops.band_attention(ad, asr, jax_bops.band_windows_ext(xe, nB, BLK, W),
                                       jnp.asarray(adj), 0.2)

    ref = jax.jit(jax.grad(lambda a, g: jnp.sum(f(*a) * g)))(
        (jnp.asarray(a_dst), jnp.asarray(a_src), jnp.asarray(x_ext)), jnp.asarray(d_out))
    for name, g, r in zip(("d a_dst", "d a_src_win", "d x_ext"), got, ref):
        np.testing.assert_allclose(g, np.asarray(r), err_msg=name, **TOL)


@pytest.mark.parametrize("H,C", [(1, 128), (2, 64), (3, 128)])
def test_backward_replay_matches_pallas_dma_on_real_rows(rng, H, C):
    """Against jax.grad through make_band_attention_dma (interpret mode), the
    padded rows' cotangent zeroed: the Pallas kernel averages them over
    round_up(W, 128), the port over W (``ROADMAP.md``, divergences in force)."""
    adj = _layout("padded", rng)
    nB, BLK, W = adj.shape
    ix = bops.build_band_index(adj)
    a_dst, a_src, x_ext, d_out = _operands(rng, adj, 1, H, C)
    d_out = d_out * adj.any(-1).reshape(-1)[None, :, None, None].astype(F32)
    got, _ = backward_replay(ix, a_dst, a_src, x_ext, d_out)
    att = make_band_attention_dma(nB, BLK, W, (W - BLK) // 2, 0.2, interpret=True)
    ref = jax.grad(lambda a: jnp.sum(att(*a, jnp.asarray(adj)) * jnp.asarray(d_out)))(
        (jnp.asarray(a_dst), jnp.asarray(a_src), jnp.asarray(x_ext)))
    for name, g, r in zip(("d a_dst", "d a_src_win", "d x_ext"), got, ref):
        np.testing.assert_allclose(g, np.asarray(r), err_msg=name, **TOL)


# ---- the forward walk's row statistics ------------------------------------------

def walk_replay(ix, a_dst, a_src, x_ext):
    """``csrc/band_rowwalk.cuh`` with its statistics: per row, its list in
    chunks of 32 with a running max and sum per head, the accumulator
    rescaled by exp(m - m_new) at each chunk, out = acc / Z; a row with no
    entry copies its block's window mean, m = -1e9, Z = W."""
    B, n_pad, H = a_dst.shape
    nB, BLK, W = ix.nB, ix.BLK, ix.W
    out = np.empty((B, n_pad) + x_ext.shape[2:], F32)
    m_out, z_out = np.empty((B, n_pad, H), F32), np.empty((B, n_pad, H), F32)
    for row in range(n_pad):
        blk = row // BLK
        k0, k1 = int(ix.row_ptr[row]), int(ix.row_ptr[row + 1])
        if k0 == k1:
            out[:, row] = x_ext[:, blk * BLK: blk * BLK + W].sum(axis=1, dtype=F32) / F32(W)
            m_out[:, row], z_out[:, row] = F32(-1e9), F32(W)
            continue
        m, Z = np.full((B, H), -3e38, F32), np.zeros((B, H), F32)
        acc = np.zeros((B,) + x_ext.shape[2:], F32)
        for s0 in range(k0, k1, CHUNK):
            js = ix.col[s0:min(s0 + CHUNK, k1)]
            z = leaky(a_dst[:, row, None, :] + a_src[blk][:, js])               # [B, cnt, H]
            m_new = np.maximum(m, z.max(axis=1))
            p = np.exp(z - m_new[:, None])
            alpha = np.exp(m - m_new)
            Z = Z * alpha + p.sum(axis=1)
            acc = acc * alpha[..., None]
            for q, j in enumerate(js):
                acc = acc + p[:, q, :, None] * x_ext[:, blk * BLK + j]
            m = m_new
        out[:, row], m_out[:, row], z_out[:, row] = acc / Z[..., None], m, Z
    return out, m_out, z_out


@pytest.mark.parametrize("layout", ["padded", "wide", "random"])
def test_forward_walk_statistics_match_plain_on_every_row(rng, layout):
    """out, m and Z from one walk, against band_attention_flash_plain: padded
    rows included (m = -1e9, Z = W), rows past 32 entries streamed."""
    adj = _layout(layout, rng)
    ix = bops.build_band_index(adj)
    for B, H, C in ((2, 2, 32), (1, 3, 33), (1, 40, 4)):
        a_dst, a_src, x_ext, _ = _operands(rng, adj, B, H, C)
        got = walk_replay(ix, a_dst, a_src, x_ext)
        ref = ba.band_attention_flash_plain(*(torch.from_numpy(a) for a in (a_dst, a_src, x_ext, adj)), 0.2)
        for name, g, r in zip(("out", "m", "Z"), got, ref):
            np.testing.assert_allclose(g, r.numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=f"{layout} B{B} H{H} C{C} {name}")
        # m is a maximum of the same f32 logits: exact
        np.testing.assert_array_equal(got[1], ref[1].numpy())


@pytest.mark.parametrize("H,C", [(1, 128), (2, 64)])
def test_forward_walk_matches_pallas_flash_on_real_rows(rng, H, C):
    """The shared walk's out against make_band_attention_flash (v4, interpret
    mode) on the real rows (the Pallas kernel averages a padded row over the
    chunk-padded W)."""
    adj = _layout("padded", rng)
    nB, BLK, W = adj.shape
    ix = bops.build_band_index(adj)
    a_dst, a_src, x_ext, _ = _operands(rng, adj, 2, H, C)
    out, _, _ = walk_replay(ix, a_dst, a_src, x_ext)
    v4 = make_band_attention_flash(nB, BLK, W, (W - BLK) // 2, 0.2, interpret=True)
    ker = np.asarray(v4(jnp.asarray(a_dst), jnp.asarray(a_src), jnp.asarray(x_ext), jnp.asarray(adj)))
    valid = adj.any(-1).reshape(-1)
    np.testing.assert_allclose(out[:, valid], ker[:, valid], rtol=1e-5, atol=1e-5)
