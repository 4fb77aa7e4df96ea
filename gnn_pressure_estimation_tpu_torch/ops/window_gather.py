"""Windowed neighbour gather over RCM windows: the CUDA kernels and their
plain versions.

The counterpart of ``gnn_pressure_estimation_tpu/ops/pallas/window_gather.py``.
From the degree-padded tables of the padded aggregation mode
(``GraphTemplate.degree_tables``), :func:`build_window_layout` reorders the
nodes by reverse Cuthill-McKee so that every block of ``BLK`` rows reads its
neighbours from one window of ``W`` rows, and stores each slot as a window
start plus a window-relative id (``W`` marks an empty slot). Its transpose
table lists, per node, the flattened slot positions where the node appears,
so the backward is the same gather over the slot grid followed by a masked
sum (:func:`make_window_gather`): no scatter in either direction.

``csrc/window_gather.cu`` is the Hopper kernel (a native gather, where the
TPU kernel had to build a one-hot matmul); :func:`window_gather_fwd` and
:func:`window_gather_bwd` launch it on CUDA tensors and run the plain
versions on CPU tensors. No aggregation mode routes here in either package:
the padded mode gathers with ``ops.padded``.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from gnn_pressure_estimation_tpu_torch.ops import _build
from gnn_pressure_estimation_tpu_torch.ops import banded as bops
from gnn_pressure_estimation_tpu_torch.ops.padded import build_transpose_tables


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class _Table:
    rel: np.ndarray        # [nB, BLK*D] window-relative ids (== W → no match)
    win_start: np.ndarray  # [nB] int32 window starts (row units)
    mask: np.ndarray       # [nB, BLK*D] valid-slot mask
    n_rows: int            # rows in the (padded) source array
    BLK: int
    D: int
    W: int

    def to(self, device) -> "_Table":
        """The table with ``rel``, ``win_start`` and ``mask`` as tensors on
        ``device``, as the wrappers take it."""
        return dataclasses.replace(self, **{
            f: torch.as_tensor(np.asarray(getattr(self, f)), device=device)
            for f in ("rel", "win_start", "mask")})


@dataclasses.dataclass(frozen=True)
class WindowLayout:
    """Host-built layout: forward (in-slot) and transpose (out-slot) tables
    in RCM-permuted node space, for one batched graph."""

    perm: np.ndarray       # [N] original → permuted gather indices (x_perm = x[perm])
    inv_perm: np.ndarray
    n_pad: int             # permuted+padded row count
    fwd: _Table            # gathers x rows → [N_pad, D, C] neighbor slots
    bwd: _Table            # gathers slot-grads → [N_pad, D2, C] out-slots
    mask_fwd: np.ndarray   # [n_pad, D] (same as fwd.mask reshaped)
    mask_bwd: np.ndarray


def _build_table(idx: np.ndarray, mask: np.ndarray, n_src_rows: int, BLK: int):
    """idx/mask: [n_rows, D] indices into a source of n_src_rows rows."""
    n_rows, D = idx.shape
    nB = -(-n_rows // BLK)
    n_pad = nB * BLK
    idx_p = np.zeros((n_pad, D), np.int64)
    mask_p = np.zeros((n_pad, D), bool)
    idx_p[:n_rows] = idx
    mask_p[:n_rows] = mask

    win_start = np.zeros(nB, np.int32)
    width = 1
    for b in range(nB):
        sel = idx_p[b * BLK: (b + 1) * BLK][mask_p[b * BLK: (b + 1) * BLK]]
        if sel.size:
            lo, hi = int(sel.min()), int(sel.max()) + 1
        else:
            lo, hi = 0, 1
        win_start[b] = lo
        width = max(width, hi - lo)
    # the reference's window widths: ≤1024 round to 128, larger to 1024 (its
    # kernel's W chunks); kept so that both packages build the same tables
    W = _round_up(width, 128) if width <= 1024 else _round_up(width, 1024)
    W = min(W, _round_up(n_src_rows, 8))
    # clamp windows so [ws, ws+W) stays in-bounds
    max_start = max(n_src_rows - W, 0)
    win_start = np.minimum(win_start, max_start).astype(np.int32)
    rel = idx_p - win_start[:, None].repeat(BLK, 1).reshape(n_pad, 1)
    rel = np.where(mask_p, rel, W)  # no-match sentinel ⇒ zero row
    if mask_p.any() and (rel[mask_p].min() < 0 or rel[mask_p].max() >= W):
        raise ValueError("window overflow: a slot lies outside its block's window")
    return _Table(
        rel=rel.reshape(nB, BLK * D).astype(np.int32),
        win_start=win_start,
        mask=mask_p.reshape(nB, BLK * D),
        n_rows=n_src_rows,
        BLK=BLK,
        D=D,
        W=W,
    )


def build_window_layout(
    senders_dp: np.ndarray,
    mask_dp: np.ndarray,
    n_node: int,
    block: int = 256,
    perm: Optional[np.ndarray] = None,
) -> WindowLayout:
    """From degree-padded tables (original node order) build the windowed
    layout. ``perm`` defaults to reverse Cuthill-McKee over the edge set."""
    N, D = senders_dp.shape
    if perm is None:
        import scipy.sparse as sp
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        rows = np.repeat(np.arange(N), D)[mask_dp.reshape(-1)]
        cols = senders_dp.reshape(-1)[mask_dp.reshape(-1)]
        A = sp.csr_matrix((np.ones(len(rows)), (rows, cols)), shape=(N, N))
        perm = np.asarray(reverse_cuthill_mckee(A + A.T, symmetric_mode=True))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(N)

    # tables in perm space: row r' = inv[r]; sender ids mapped to perm space
    idx_perm = np.zeros_like(senders_dp)
    mask_perm = np.zeros_like(mask_dp)
    idx_perm[inv] = inv[senders_dp]
    mask_perm[inv] = mask_dp

    nB = -(-N // block)
    n_pad = nB * block
    fwd = _build_table(idx_perm, mask_perm, n_pad, block)

    # transpose: positions in the flat [n_pad*D] slot grid per source node
    idx_pad = np.zeros((n_pad, D), np.int64)
    mask_pad = np.zeros((n_pad, D), bool)
    idx_pad[:N] = idx_perm
    mask_pad[:N] = mask_perm
    out_flat, out_mask = build_transpose_tables(idx_pad.astype(np.int32), mask_pad, n_pad)
    bwd = _build_table(out_flat.astype(np.int64), out_mask, n_pad * D, block)

    return WindowLayout(
        perm=perm.astype(np.int32),
        inv_perm=inv.astype(np.int32),
        n_pad=n_pad,
        fwd=fwd,
        bwd=bwd,
        mask_fwd=fwd.mask.reshape(n_pad, D),
        mask_bwd=bwd.mask.reshape(n_pad, bwd.D),
    )


# ---- the kernels and their plain versions ------------------------------------

def window_gather_fwd_plain(x: torch.Tensor, tbl: _Table) -> torch.Tensor:
    """Plain PyTorch version of :func:`window_gather_fwd`."""
    rel = tbl.rel.long()
    valid = rel != tbl.W
    src = torch.where(valid, tbl.win_start.long()[:, None] + rel, 0)
    out = torch.where(valid[..., None], x[src], 0.0)                  # [nB, BLK*D, C]
    return out.reshape(-1, tbl.D, x.shape[-1])


def window_gather_bwd_plain(g: torch.Tensor, tbl: _Table) -> torch.Tensor:
    """Plain PyTorch version of :func:`window_gather_bwd`: the gather over the
    transpose table, then the sum over the table's valid slots."""
    got = window_gather_fwd_plain(g, tbl)                             # [n_pad, D2, C]
    return torch.where(tbl.mask.reshape(-1, tbl.D)[..., None], got, 0.0).sum(dim=1)


def _launch(name: str, src: torch.Tensor, tbl: _Table, out_rows: tuple) -> torch.Tensor:
    """Check the operands of a window-gather kernel and launch it."""
    if src.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {src.device}")
    if src.dim() != 2 or src.dtype != torch.float32 or not src.is_contiguous():
        raise ValueError(f"{name}: the source must be a contiguous f32 [rows, C] tensor")
    if src.shape[0] != tbl.n_rows:
        raise ValueError(f"{name}: source has {src.shape[0]} rows, the table {tbl.n_rows}")
    nB = int(tbl.win_start.shape[0])
    for f, t, shape in (("rel", tbl.rel, (nB, tbl.BLK * tbl.D)), ("win_start", tbl.win_start, (nB,))):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32 or t.device != src.device \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: table {f} must be a contiguous int32 {shape} tensor on "
                             f"{src.device} (_Table.to)")
    C = src.shape[1]
    out = torch.empty(out_rows + (C,), dtype=torch.float32, device=src.device)
    fn = getattr(_build.load("window_gather"), name)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(src.device):
        rc = fn(src.data_ptr(), tbl.rel.data_ptr(), tbl.win_start.data_ptr(), out.data_ptr(),
                nB, tbl.BLK, tbl.D, tbl.W, C, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
    return out


def window_gather_fwd(x: torch.Tensor, tbl: _Table) -> torch.Tensor:
    """x [tbl.n_rows, C] → [nB·BLK, D, C] neighbour slots, zero where the
    slot is empty. ``tbl``'s arrays lie on ``x``'s device (:meth:`_Table.to`).

    On CUDA tensors it launches ``csrc/window_gather.cu`` (or raises); on CPU
    tensors it runs :func:`window_gather_fwd_plain`.
    ``window_gather_fwd.launches`` counts kernel launches."""
    if bops.use_plain(x):
        return window_gather_fwd_plain(x, tbl)
    nB = int(tbl.win_start.shape[0])
    out = _launch("window_gather_fwd", x, tbl, (nB * tbl.BLK, tbl.D))
    window_gather_fwd.launches += 1
    return out


window_gather_fwd.launches = 0


def window_gather_bwd(g: torch.Tensor, tbl: _Table) -> torch.Tensor:
    """g [tbl.n_rows, C] (the flattened slot grid of a forward's cotangent)
    → [nB·BLK, C]: per row, the sum of ``g`` over the row's valid slots of
    the transpose table ``tbl``. The gather and the sum are one kernel; the
    slots are never written out.

    On CUDA tensors it launches ``csrc/window_gather.cu`` (or raises); on CPU
    tensors it runs :func:`window_gather_bwd_plain`.
    ``window_gather_bwd.launches`` counts kernel launches."""
    if bops.use_plain(g):
        return window_gather_bwd_plain(g, tbl)
    nB = int(tbl.win_start.shape[0])
    out = _launch("window_gather_bwd", g, tbl, (nB * tbl.BLK,))
    window_gather_bwd.launches += 1
    return out


window_gather_bwd.launches = 0


class WindowGather(torch.autograd.Function):
    """The forward gather over ``fwd``; the backward gathers the slot
    cotangents over the transpose table ``bwd`` and sums the valid slots."""

    @staticmethod
    def forward(ctx, xp, fwd, bwd):
        ctx.bwd = bwd
        return window_gather_fwd(xp, fwd)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return window_gather_bwd(g.reshape(-1, g.shape[-1]).contiguous(), ctx.bwd), None, None


def make_window_gather(layout: WindowLayout):
    """Returns ``gather(x_perm [n_pad, C]) -> [n_pad, D, C]`` with a
    scatter-free backward. ``x_perm`` must already be permuted and padded
    (``x_perm[:N] = x[layout.perm]``, zeros below). The tables move to the
    input's device at its first call there."""
    tables: dict = {}

    def gather(xp: torch.Tensor) -> torch.Tensor:
        key = str(xp.device)
        if key not in tables:
            tables[key] = (layout.fwd.to(xp.device), layout.bwd.to(xp.device))
        return WindowGather.apply(xp, *tables[key])

    return gather
