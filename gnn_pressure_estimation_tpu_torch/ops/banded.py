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
"""

from __future__ import annotations

import dataclasses

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


def band_windows_ext(x_ext: torch.Tensor, nB: int, BLK: int, W: int) -> torch.Tensor:
    """[B, n_ext, ...] extended array → [nB, B, W, ...] block windows."""
    return torch.stack([x_ext[:, b * BLK: b * BLK + W] for b in range(nB)])


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
