"""Banded-dense aggregation for large graphs (RCM band + local attention).

After reverse-Cuthill-McKee reordering a WDN graph's adjacency is banded:
every neighbor of node i lies within ±bandwidth of i, so each BLK-row block
only interacts with a static contiguous window of W rows:

    out[block] = Band[block, :, :W] @ x[win_start : win_start + W]

The host-side layout (:class:`BandLayout`, :func:`build_band_layout`) is a
copy of ``gnn_pressure_estimation_tpu/ops/banded.py``; the int8 overflow
checks raise ``ValueError`` instead of asserting. The torch functions below
are the *plain* versions of the band ops: the CPU path and the yardstick the
CUDA kernels (``ops/band_attention.py``, ``ops/band_spmm.py``) are held to.

:class:`BandIndex` is the compressed form of one band's nonzeros that the
backward kernels walk: row lists for the row-parallel pass, and the same
entries regrouped by the extended-array row they read, for the
column-parallel pass that folds the overlapping windows without atomics.
It is built on the host once per template (``GraphTemplate.band_index``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import numpy as np
import torch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class BandLayout:
    """Host-built band layout of one template (perm space)."""

    perm: np.ndarray          # x_perm = x[perm]
    inv_perm: np.ndarray
    n: int                    # original node count
    n_pad: int                # nB * BLK
    BLK: int
    W: int
    win_start: tuple          # static per-block window starts (len nB)
    adj_mask: np.ndarray      # [nB, BLK, W] bool (incl. self-loops)
    mean_band: np.ndarray     # [nB, BLK, W] row-normalized mean (no SL)
    gcn_band: np.ndarray      # [nB, BLK, W] sym-norm with SL
    cheb_band: np.ndarray     # [nB, BLK, W] −D^-1/2 A D^-1/2
    adj_band: np.ndarray      # [nB, BLK, W] raw adjacency (no SL)
    # Factored forms: every parameter-free band is diag(rowscale) @ counts
    # @ diag(colscale) —
    #   mean = diag(inv_deg) · adj_cnt
    #   gcn  = diag(dinv_sl) · adj_cnt_sl · diag(dinv_sl)
    #   cheb = −diag(dinv) · adj_cnt · diag(dinv)
    #   adj  = adj_cnt
    adj_cnt: np.ndarray = None        # [nB, BLK, W] int8 edge counts (no SL)
    adj_cnt_sl: np.ndarray = None     # [nB, BLK, W] int8 counts + self-loops
    inv_deg_perm: np.ndarray = None   # [n_pad] f32 1/deg, zeros on pad rows
    dinv_sl_perm: np.ndarray = None   # [n_pad] f32 1/sqrt(deg+1)
    dinv_perm: np.ndarray = None      # [n_pad] f32 1/sqrt(deg) (0 at deg 0)


def build_band_layout(template, block: int = 256, lane: int = 128) -> BandLayout:
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    n = template.n_node
    A = sp.csr_matrix(
        (np.ones(template.n_edge), (template.receivers, template.senders)),
        shape=(n, n),
    )
    perm = np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n)

    s2, r2 = inv[template.senders], inv[template.receivers]
    nB = -(-n // block)
    n_pad = nB * block

    # per-block window bounds over senders (plus own rows for self-loops)
    lo = np.full(nB, np.iinfo(np.int32).max, np.int64)
    hi = np.zeros(nB, np.int64)
    for b in range(nB):
        lo[b] = b * block
        hi[b] = min((b + 1) * block, n)
    for s, r in zip(s2, r2):
        b = r // block
        lo[b] = min(lo[b], s)
        hi[b] = max(hi[b], s + 1)
    # UNIFORM window offsets: every block's window starts exactly U rows
    # before its own first row (win_start[b] = b·BLK − U, possibly negative —
    # extraction pads instead of clamping).
    U = int((np.arange(nB) * block - lo).max())
    V = int((hi - np.arange(nB) * block).max())
    W = _round_up(U + max(V, block), lane)  # lane-aligned window width
    win_start = (np.arange(nB, dtype=np.int64) * block - U).astype(np.int32)

    adj = np.zeros((nB, block, W), bool)
    mean_b = np.zeros((nB, block, W), np.float32)
    gcn_b = np.zeros((nB, block, W), np.float32)
    cheb_b = np.zeros((nB, block, W), np.float32)
    adj_raw = np.zeros((nB, block, W), np.float32)
    adj_cnt = np.zeros((nB, block, W), np.int8)
    adj_cnt_sl = np.zeros((nB, block, W), np.int8)

    deg = template.in_degree
    inv_deg = template.inv_degree
    deg_sl = deg + 1.0
    dinv_sl = 1.0 / np.sqrt(deg_sl)
    with np.errstate(divide="ignore"):
        dinv = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1.0)), 0.0)

    for s, r in zip(s2, r2):
        b, i = r // block, r % block
        j = s - win_start[b]
        adj[b, i, j] = True
        adj_raw[b, i, j] += 1.0
        adj_cnt[b, i, j] += 1
        adj_cnt_sl[b, i, j] += 1
        # weights indexed by ORIGINAL node ids (perm-space row r ↔ orig perm[r])
        ro, so = perm[r], perm[s]
        mean_b[b, i, j] += inv_deg[ro]
        gcn_b[b, i, j] += dinv_sl[ro] * dinv_sl[so]
        cheb_b[b, i, j] += -(dinv[ro] * dinv[so])
    for r in range(n):  # self-loops
        b, i = r // block, r % block
        j = r - win_start[b]
        adj[b, i, j] = True
        gcn_b[b, i, j] += dinv_sl[perm[r]] ** 2
        adj_cnt_sl[b, i, j] += 1

    # int8 counts must equal the f32 bands exactly — a multigraph with ≥128
    # parallel edges between one node pair wraps int8 and would silently
    # diverge from adj_band on the kernel path
    if not (adj_cnt.astype(np.float32) == adj_raw).all():
        raise ValueError("parallel-edge count overflows int8 — widen adj_cnt's dtype")
    if int(adj_cnt_sl.max()) > 127 or int(adj_cnt_sl.min()) < 0:
        raise ValueError("self-loop count band overflows int8")

    inv_deg_perm = np.zeros(n_pad, np.float32)
    inv_deg_perm[:n] = np.asarray(inv_deg, np.float32)[perm]
    dinv_sl_perm = np.zeros(n_pad, np.float32)
    dinv_sl_perm[:n] = np.asarray(dinv_sl, np.float32)[perm]
    dinv_perm = np.zeros(n_pad, np.float32)
    dinv_perm[:n] = np.asarray(dinv, np.float32)[perm]

    return BandLayout(
        perm=perm.astype(np.int32),
        inv_perm=inv.astype(np.int32),
        n=n,
        n_pad=n_pad,
        BLK=block,
        W=W,
        win_start=tuple(int(v) for v in win_start),
        adj_mask=adj,
        mean_band=mean_b,
        gcn_band=gcn_b,
        cheb_band=cheb_b,
        adj_band=adj_raw,
        adj_cnt=adj_cnt,
        adj_cnt_sl=adj_cnt_sl,
        inv_deg_perm=inv_deg_perm,
        dinv_sl_perm=dinv_sl_perm,
        dinv_perm=dinv_perm,
    )


@dataclasses.dataclass(frozen=True)
class BandIndex:
    """The nonzeros of one ``[nB, BLK, W]`` band, compressed, by row and by
    the extended-array row they read (numpy on the host, int32 tensors once
    moved with :meth:`to`).

    Entry ``k`` (row-major order of the band) sits at band row
    ``g = blk·BLK + r`` and window column ``j``; it reads extended row
    ``e = blk·BLK + j``. ``t_*`` list the same entries sorted by ``(e, g)``,
    so one extended row's contributions are contiguous and, within them,
    each block's are too.
    """

    nB: int
    BLK: int
    W: int
    row_ptr: object     # [n_pad + 1]  entries of band row g: row_ptr[g]..row_ptr[g+1]
    col: object         # [nnz]        window column j of entry k
    val: object         # [nnz] f32    band value of entry k
    t_ptr: object       # [n_ext + 1]  entries reading extended row e
    t_entry: object     # [nnz]        entry index k, sorted by (e, g)
    t_row: object       # [nnz]        band row g of that entry
    t_val: object       # [nnz] f32    band value of that entry: val[t_entry]
    empty_ptr: object   # [nB + 1]     rows of block blk with no entry
    empty_row: object   # [n_empty]    their band rows g

    @property
    def nnz(self) -> int:
        return int(self.col.shape[0])

    def to(self, device) -> "BandIndex":
        def move(a):
            return torch.as_tensor(a, device=device)
        return dataclasses.replace(self, **{
            f.name: move(getattr(self, f.name)) for f in dataclasses.fields(self)
            if f.name not in ("nB", "BLK", "W")})


def build_band_index(band: np.ndarray) -> BandIndex:
    """Compress the nonzeros of ``band`` ([nB, BLK, W], any dtype)."""
    band = np.asarray(band)
    nB, BLK, W = band.shape
    n_pad, n_ext = nB * BLK, nB * BLK + W - BLK
    blk, r, j = np.nonzero(band)                       # row-major: sorted by (g, j)
    g = blk * BLK + r
    e = blk * BLK + j
    row_ptr = np.zeros(n_pad + 1, np.int64)
    np.cumsum(np.bincount(g, minlength=n_pad), out=row_ptr[1:])
    order = np.lexsort((g, e))                         # by e, then by g
    t_ptr = np.zeros(n_ext + 1, np.int64)
    np.cumsum(np.bincount(e, minlength=n_ext), out=t_ptr[1:])
    empty = np.nonzero(np.diff(row_ptr) == 0)[0]
    empty_ptr = np.zeros(nB + 1, np.int64)
    np.cumsum(np.bincount(empty // BLK, minlength=nB), out=empty_ptr[1:])
    i32 = np.int32
    val = band[blk, r, j].astype(np.float32)
    return BandIndex(
        nB=nB, BLK=BLK, W=W,
        row_ptr=row_ptr.astype(i32), col=j.astype(i32), val=val,
        t_ptr=t_ptr.astype(i32), t_entry=order.astype(i32), t_row=g[order].astype(i32),
        t_val=val[order],
        empty_ptr=empty_ptr.astype(i32), empty_row=empty.astype(i32),
    )


def band_index_of(band: torch.Tensor) -> BandIndex:
    """The :class:`BandIndex` of a band tensor, on the band's device, built
    from the tensor's values (a device-to-host copy on every call): for
    callers without a template. The model's path passes the template's
    cached index instead."""
    return build_band_index(band.detach().cpu().numpy()).to(band.device)


def index_for(fn: str, band: torch.Tensor, index, dev) -> BandIndex:
    """The :class:`BandIndex` a kernel wrapper ``fn`` walks for ``band`` (a
    mask or a value band) on ``dev``: the caller's, checked to fit, or one
    built from the band's values."""
    ix = band_index_of(band) if index is None else index
    if (ix.nB, ix.BLK, ix.W) != tuple(band.shape) or ix.col.device != dev:
        raise ValueError(f"{fn}: index does not belong to this band and device")
    return ix


BAND_ATTN_ROUTES = ("dma", "flash", "window", "acc")


def band_attention_route(BLK: int, W: int) -> str:
    """Which band-attention kernel family a layout goes to when the caller
    names none: ``"dma"`` (whole-window softmax, the counterpart of the
    reference's v2) while ``BLK · round_up(W, 128) · 4 ≤ 1 MiB``, ``"flash"``
    (streaming softmax, v4) beyond. ``"window"`` (v1) and ``"acc"`` (v3: v2's
    forward, the owner-row backward) run only when the caller names them, as
    the reference takes v1 only with ``GNN_TPU_BAND_DMA=0`` and v3 only with
    ``GNN_TPU_BAND_ACC=1`` (off by default).

    The threshold is the reference's: there it is the largest logits tile
    its v2 and v3 kernels can hold on chip, past which ``GraphTemplate.batch``
    falls back to the streaming kernel. It is kept here for parity of
    routing, so that both packages send the same network to the same kernel
    family and their launch counts mean the same thing; it is not a limit of
    the card, where every kernel takes any layout: a named ``"dma"`` or
    ``"acc"`` runs its Hopper kernels past the 1 MiB guard too."""
    return "dma" if BLK * _round_up(W, 128) * 4 <= (1 << 20) else "flash"


# While true, the kernel wrappers run their plain versions on any device.
# Only checks that hold the kernels against the plain versions set it
# (``plain_versions()``); nothing on the model's path does.
_force_plain = False


@contextlib.contextmanager
def plain_versions():
    """Inside the block, ``band_attention`` and ``band_spmm`` run their plain
    PyTorch versions, forward and backward, on whatever device the tensors
    lie: the yardstick for a whole train step on the card."""
    global _force_plain
    old, _force_plain = _force_plain, True
    try:
        yield
    finally:
        _force_plain = old


def use_plain(t: torch.Tensor) -> bool:
    """A wrapper takes its plain version for a CPU tensor, or inside
    :func:`plain_versions`."""
    return t.device.type == "cpu" or _force_plain


def vector_loads(x: torch.Tensor, C: int) -> bool:
    """Whether a band kernel may read ``x``'s rows of C channels packed, 4
    channels of one head a load: f32 rows as a float4, bf16 rows (the
    bf16-operand forwards) as one 8-byte quad. Both need C a multiple of 4
    (rows, heads and quads then start on a 16- or 8-byte boundary) and the
    data 16-byte aligned (a view at an offset may not be); else the kernel
    takes its scalar variant."""
    return C % 4 == 0 and x.data_ptr() % 16 == 0


def halo_widths(win_start: tuple, W: int, n_pad: int) -> tuple[int, int]:
    """(U, R): rows of left/right context each block window reaches beyond
    its own rows. ``win_start`` must be the uniform layout (b·BLK − U)."""
    nB = len(win_start)
    BLK = n_pad // nB
    U = -int(win_start[0])
    R = W - U - BLK
    if any(int(ws) != b * BLK - U for b, ws in enumerate(win_start)):
        raise ValueError("band layout is not uniform-offset; rebuild with build_band_layout")
    if U < 0 or R < 0:
        raise ValueError(f"negative halo width: U={U} R={R} W={W} BLK={BLK}")
    return U, R


# ---- plain torch band ops ---------------------------------------------------

def extend_rows(x_bp: torch.Tensor, U: int, R: int) -> torch.Tensor:
    """[B, n_pad, ...] → [B, U + n_pad + R, ...]: zero rows before and after,
    so block ``i``'s window is rows ``[i·BLK, i·BLK + W)`` of the result."""
    pad = x_bp.new_zeros
    return torch.cat(
        [pad((x_bp.shape[0], U) + x_bp.shape[2:]), x_bp,
         pad((x_bp.shape[0], R) + x_bp.shape[2:])], dim=1
    )


def extend_rows_bf16(x_bp: torch.Tensor, U: int, R: int) -> torch.Tensor:
    """The extended rows of :func:`extend_rows` stored in bfloat16: each row
    of the f32 ``x_bp`` read once and rounded once (to nearest, ties to
    even) as it is written, and only the U and R halo rows zeroed. The
    bf16-operand band forwards gather these rows."""
    B, n_pad = x_bp.shape[:2]
    out = torch.empty((B, U + n_pad + R) + x_bp.shape[2:], dtype=torch.bfloat16,
                      device=x_bp.device)
    out[:, :U].zero_()
    out[:, U + n_pad:].zero_()
    out[:, U:U + n_pad].copy_(x_bp)
    return out


def band_windows_ext(x_ext: torch.Tensor, nB: int, BLK: int, W: int) -> torch.Tensor:
    """[B, n_ext, ...] extended array → [nB, B, W, ...] block windows. One
    strided view and one copy (and one fold in its backward), not nB slices:
    a train step takes this 50 times."""
    if x_ext.shape[1] != nB * BLK + W - BLK:
        raise ValueError(f"extended array has {x_ext.shape[1]} rows, expected {nB * BLK + W - BLK}")
    wins = x_ext.unfold(1, W, BLK)                       # [B, nB, ..., W]
    return wins.movedim(-1, 2).transpose(0, 1).contiguous()


def fold_windows_ext(xw: torch.Tensor, BLK: int) -> torch.Tensor:
    """[nB, B, W, ...] per-window values → [B, n_ext, ...], overlapping
    windows summed: the transpose of :func:`band_windows_ext`."""
    nB, B, W = xw.shape[:3]
    out = xw.new_zeros((B, nB * BLK + W - BLK) + xw.shape[3:])
    for b in range(nB):
        out[:, b * BLK: b * BLK + W] += xw[b]
    return out


def band_windows(x_bp: torch.Tensor, win_start: tuple, W: int) -> torch.Tensor:
    """x_bp: [B, n_pad, ...] → [nB, B, W, ...] static window slices."""
    nB = len(win_start)
    n_pad = x_bp.shape[1]
    U, R = halo_widths(win_start, W, n_pad)
    return band_windows_ext(extend_rows(x_bp, U, R), nB, n_pad // nB, W)


def band_spmm(band: torch.Tensor, wins: torch.Tensor) -> torch.Tensor:
    """band: [nB, BLK, W] (f32 weights or int8 counts), wins: [nB, B, W, C]
    → [B, nB·BLK, C]."""
    out = torch.einsum("niw,nbwc->bnic", band.to(wins.dtype), wins)
    return out.reshape(wins.shape[1], -1, out.shape[-1])


def band_attention(
    a_dst: torch.Tensor,      # [B, n_pad, H]
    a_src_win: torch.Tensor,  # [nB, B, W, H]
    x_win: torch.Tensor,      # [nB, B, W, H, C]
    adj_mask: torch.Tensor,   # [nB, BLK, W] bool or 0/1 int8
    negative_slope: float,
    neg_inf: float = -1e9,
) -> torch.Tensor:
    """Local masked GAT attention over band windows → [B, n_pad, H, C].

    A fully masked row (a padded band row: no self-loop) gets a uniform
    softmax over its W window, i.e. the mean of the window's rows."""
    nB, B, W, H = a_src_win.shape
    BLK = adj_mask.shape[1]
    a_dst_b = a_dst.reshape(B, nB, BLK, H).permute(1, 0, 2, 3)    # [nB,B,BLK,H]
    logits = a_dst_b[:, :, :, None, :] + a_src_win[:, :, None, :, :]  # [nB,B,BLK,W,H]
    logits = torch.where(logits >= 0, logits, negative_slope * logits)
    logits = torch.where(adj_mask.bool()[:, None, :, :, None], logits,
                         torch.full((), neg_inf, dtype=logits.dtype, device=logits.device))
    attn = torch.softmax(logits, dim=3)
    out = torch.einsum("nbiwh,nbwhc->nbihc", attn, x_win)       # [nB,B,BLK,H,C]
    C = x_win.shape[-1]
    return out.permute(1, 0, 2, 3, 4).reshape(B, nB * BLK, H, C)


def band_attention_factored(
    a_dst: torch.Tensor,      # [B, n_pad, H]
    a_src_win: torch.Tensor,  # [nB, B, W, H]
    x_win: torch.Tensor,      # [nB, B, W, H, C]
    adj_mask: torch.Tensor,   # [nB, BLK, W] bool or 0/1 int8
    negative_slope: float,
    store_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Factored band attention → [B, n_pad, H, C], in ``x_win``'s dtype: the
    exp(LeakyReLU) numerator split into two rank-1 products gated by the
    zero-gradient sign matrix, as the dense ``factored`` path splits it. A
    copy of the JAX package's ``ops/banded.py`` ``band_attention_factored``,
    which is plain XLA there (no kernel); plain torch here.

    Its guards: a padded band row has no set column, so its masked row
    maximum is clamped at −60 (the exps stay finite) and its Z is taken as 1
    (its output 0/1 = 0, which keeps it inert in later layers' windows; a
    floor alone would give 0/0 in the division's backward). ``store_dtype``
    (None: ``x_win``'s) is the dtype of the gate and of the two products'
    operands, which are summed in f32. The ops run in the inputs' dtype
    (bf16 under bf16 activations, each op rounded as the JAX layer's are),
    with the slope in that dtype too."""
    nB, B, W, H = a_src_win.shape
    BLK = adj_mask.shape[1]
    C = x_win.shape[-1]
    dt = a_src_win.dtype
    al = torch.tensor(negative_slope, dtype=dt, device=a_src_win.device)
    store = store_dtype or x_win.dtype
    a_dst_b = a_dst.reshape(B, nB, BLK, H).permute(1, 0, 2, 3)    # [nB,B,BLK,H]
    on = adj_mask.bool()
    mask = on[:, None, :, :]                                      # [nB,1,BLK,W]
    with torch.no_grad():
        ms = torch.where(mask[..., None], a_src_win[:, :, None, :, :],
                         torch.full((), -math.inf, dtype=dt, device=a_src_win.device)).amax(dim=3)
        ms = ms.clamp(min=-60.0)          # fully masked (padded) rows: keep the exps finite
        zm = a_dst_b + ms
        m = torch.where(zm >= 0, zm, al * zm)                     # [nB,B,BLK,H]
        cs = torch.relu(a_src_win.amax(dim=2, keepdim=True))      # [nB,B,1,H]
        s = a_dst_b[:, :, :, None, :] + a_src_win[:, :, None, :, :]
        P = (mask[..., None] & (s >= 0)).to(store)               # [nB,B,BLK,W,H]
    u, p = torch.exp(a_dst_b - m), torch.exp(al * a_dst_b - m)    # [nB,B,BLK,H]
    v, q = torch.exp(a_src_win - cs), torch.exp(al * a_src_win - cs)  # [nB,B,W,H]
    xa = torch.cat([x_win, x_win.new_ones(x_win.shape[:-1] + (1,))], dim=-1)
    vx = (v[..., None] * xa).to(store)
    qx = (q[..., None] * xa).to(store)
    t_adj = torch.einsum("niw,nbwhc->nbihc", on.to(store).float(), qx.float())
    t_p = torch.einsum("nbiwh,nbwhc->nbihc", P.float(), torch.cat([vx, qx], dim=-1).float())
    t_pv, t_pq = t_p[..., :C + 1], t_p[..., C + 1:]
    outz = u[..., None].float() * t_pv + p[..., None].float() * (t_adj - t_pq)
    valid = on.any(dim=2)[:, None, :, None, None]                 # [nB,1,BLK,1,1]
    z = torch.where(valid, outz[..., C:].clamp(min=1e-30), 1.0)
    out = (outz[..., :C] / z).to(x_win.dtype)
    return out.permute(1, 0, 2, 3, 4).reshape(B, nB * BLK, H, C)
