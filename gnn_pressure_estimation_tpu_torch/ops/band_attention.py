"""Banded GAT attention: the CUDA kernels, forward and backward, and their
plain versions.

Replaces ``make_band_attention_dma`` (v2) in
``gnn_pressure_estimation_tpu/ops/pallas/band_attention.py``, forward
(``csrc/band_attention.cu``) and backward (``csrc/band_attention_bwd.cu``):
per destination row, graph and head, the LeakyReLU(0.2) additive logits over
the row's W-wide window of the extended node array, the int8 adjacency mask,
a softmax over the window, and the weighted sum of the window's rows.
:func:`band_attention` is the differentiable entry point (a
``torch.autograd.Function``); the mask gets no gradient.

Bound on an H100 SXM at the bigtown GATRes-large shapes (B 32, n_pad 5,888,
W 896, H·C 256): counted over the mask's nonzeros (0.51% dense) the forward
is memory-bound — x_ext (214 MB) read once and out (193 MB) written once,
≈0.12 ms at 3.35 TB/s; counted over the dense window it is 86 GFLOP, ≈1.3 ms
at 67 TFLOP/s f32. The forward kernel skips masked columns (a warp ballot
over the mask row), so its work follows the nonzeros and its floor is the
byte bound. The backward reads x_ext and dO and writes d x_ext (≈0.19 ms at
those shapes); it recomputes the softmax, as v2 does, and walks the mask's
nonzeros through a :class:`~..ops.banded.BandIndex` (row lists, then the same
entries grouped by the extended row they read), so the overlapping windows
fold without atomics and a run repeats to the bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from gnn_pressure_estimation_tpu_torch.ops import _build
from gnn_pressure_estimation_tpu_torch.ops import banded as bops


def band_attention_plain(
    a_dst: torch.Tensor,      # [B, n_pad, H]
    a_src_win: torch.Tensor,  # [nB, B, W, H]
    x_ext: torch.Tensor,      # [B, n_ext, H, C]
    adj_mask: torch.Tensor,   # [nB, BLK, W] bool or 0/1 int8
    negative_slope: float = 0.2,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`band_attention_fwd`."""
    nB, BLK, W = adj_mask.shape
    x_win = bops.band_windows_ext(x_ext, nB, BLK, W)      # [nB, B, W, H, C]
    return bops.band_attention(a_dst, a_src_win, x_win, adj_mask, negative_slope)


def band_attention_bwd_plain(
    a_dst: torch.Tensor, a_src_win: torch.Tensor, x_ext: torch.Tensor,
    adj_mask: torch.Tensor, d_out: torch.Tensor, negative_slope: float = 0.2,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`band_attention_bwd`: the explicit
    formulas on the dense windows, window fold included.

    ``d_out`` [B, n_pad, H, C] → ``(d a_dst [B, n_pad, H], d a_src_win
    [nB, B, W, H], d x_ext [B, n_ext, H, C])``. A row with no set column has
    a uniform softmax: it adds ``d_out/W`` to its W window rows of ``d x_ext``
    and nothing to the ``d a``'s (the mask zeroes the logits' gradient)."""
    nB, BLK, W = adj_mask.shape
    B, n_ext, H, C = x_ext.shape
    on = adj_mask.bool()[:, None, :, :, None]                         # [nB,1,BLK,W,1]
    x_win = bops.band_windows_ext(x_ext, nB, BLK, W)                  # [nB,B,W,H,C]
    zpre = (a_dst.reshape(B, nB, BLK, H).permute(1, 0, 2, 3)[:, :, :, None, :]
            + a_src_win[:, :, None, :, :])                            # [nB,B,BLK,W,H]
    z = torch.where(zpre >= 0, zpre, negative_slope * zpre)
    z = torch.where(on, z, torch.full((), -1e9, dtype=z.dtype, device=z.device))
    p = torch.softmax(z, dim=3)
    do_b = d_out.reshape(B, nB, BLK, H, C).permute(1, 0, 2, 3, 4)     # [nB,B,BLK,H,C]
    dp = torch.einsum("nbihc,nbwhc->nbiwh", do_b, x_win)
    dz = p * (dp - (p * dp).sum(dim=3, keepdim=True))
    # the sign of the pre-activation, not of LeakyReLU's output
    dz = torch.where(zpre >= 0, dz, negative_slope * dz) * on
    d_a_dst = dz.sum(dim=3).permute(1, 0, 2, 3).reshape(B, nB * BLK, H)
    d_a_src_win = dz.sum(dim=2)
    dxw = torch.einsum("nbiwh,nbihc->nbwhc", p, do_b)
    return d_a_dst, d_a_src_win, bops.fold_windows_ext(dxw, BLK)


def _check(fn: str, a_dst, a_src_win, x_ext, adj_mask):
    """Raise on what the kernels do not take; returns the int8 mask."""
    nB, BLK, W = adj_mask.shape
    B, n_ext, H, C = x_ext.shape
    n_pad = nB * BLK
    if x_ext.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x_ext.device}")
    if a_dst.shape != (B, n_pad, H) or a_src_win.shape != (nB, B, W, H):
        raise ValueError(
            f"{fn}: shapes a_dst {tuple(a_dst.shape)}, a_src_win "
            f"{tuple(a_src_win.shape)} do not fit x_ext {tuple(x_ext.shape)}, "
            f"mask {tuple(adj_mask.shape)}")
    if n_ext != n_pad + W - BLK:
        raise ValueError(f"{fn}: x_ext has {n_ext} rows, expected {n_pad + W - BLK}")
    for name, t in (("a_dst", a_dst), ("a_src_win", a_src_win), ("x_ext", x_ext)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != x_ext.device:
            raise ValueError(f"{fn}: {name} must be contiguous f32 on {x_ext.device}")
    if adj_mask.dtype == torch.bool:
        adj_mask = adj_mask.view(torch.int8)
    if adj_mask.dtype != torch.int8 or not adj_mask.is_contiguous() or adj_mask.device != x_ext.device:
        raise ValueError(f"{fn}: adj_mask must be contiguous int8/bool on {x_ext.device}")
    return adj_mask


def band_attention_fwd(
    a_dst: torch.Tensor,
    a_src_win: torch.Tensor,
    x_ext: torch.Tensor,
    adj_mask: torch.Tensor,
    negative_slope: float = 0.2,
) -> torch.Tensor:
    """a_dst [B, n_pad, H] · a_src_win [nB, B, W, H] · x_ext [B, n_ext, H, C]
    (n_ext = n_pad + W − BLK) · adj_mask [nB, BLK, W] (bool or int8)
    → [B, n_pad, H, C], all f32. No autograd: see :func:`band_attention`.

    On CUDA tensors it launches the kernel (or raises); on CPU tensors it
    runs :func:`band_attention_plain`. ``band_attention_fwd.launches`` counts
    kernel launches."""
    if bops.use_plain(x_ext):
        return band_attention_plain(a_dst, a_src_win, x_ext, adj_mask, negative_slope)
    adj_mask = _check("band_attention_fwd", a_dst, a_src_win, x_ext, adj_mask)
    nB, BLK, W = adj_mask.shape
    B, _, H, C = x_ext.shape
    out = torch.empty((B, nB * BLK, H, C), dtype=torch.float32, device=x_ext.device)
    fn = _build.load("band_attention").band_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x_ext.device):
        rc = fn(a_dst.data_ptr(), a_src_win.data_ptr(), x_ext.data_ptr(),
                adj_mask.data_ptr(), out.data_ptr(), B, nB, BLK, W, H, C,
                float(negative_slope), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"band_attention_fwd: kernel launch failed with CUDA error {rc}")
    band_attention_fwd.launches += 1
    return out


band_attention_fwd.launches = 0


def band_attention_bwd(
    a_dst: torch.Tensor,
    a_src_win: torch.Tensor,
    x_ext: torch.Tensor,
    adj_mask: torch.Tensor,
    d_out: torch.Tensor,
    negative_slope: float = 0.2,
    index: Optional[bops.BandIndex] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The cotangents ``(d a_dst, d a_src_win, d x_ext)`` of
    :func:`band_attention_fwd` for the output cotangent ``d_out``
    [B, n_pad, H, C], window fold included.

    ``index`` is the mask's :class:`BandIndex` on the same device (the
    template's cached one on the model's path); without it the index is
    built from the mask's values. On CUDA tensors it launches the kernel (or
    raises); on CPU tensors it runs :func:`band_attention_bwd_plain`.
    ``band_attention_bwd.launches`` counts kernel launches (one per call: the
    three passes of ``csrc/band_attention_bwd.cu`` are one launch of it)."""
    if bops.use_plain(x_ext):
        return band_attention_bwd_plain(a_dst, a_src_win, x_ext, adj_mask, d_out, negative_slope)
    adj_mask = _check("band_attention_bwd", a_dst, a_src_win, x_ext, adj_mask)
    nB, BLK, W = adj_mask.shape
    B, n_ext, H, C = x_ext.shape
    dev = x_ext.device
    if d_out.shape != (B, nB * BLK, H, C) or d_out.dtype != torch.float32 or d_out.device != dev:
        raise ValueError(f"band_attention_bwd: d_out {tuple(d_out.shape)} {d_out.dtype} does not "
                         f"fit x_ext {tuple(x_ext.shape)}")
    d_out = d_out.contiguous()
    ix = bops.band_index_of(adj_mask) if index is None else index
    if (ix.nB, ix.BLK, ix.W) != (nB, BLK, W) or ix.col.device != dev:
        raise ValueError("band_attention_bwd: index does not belong to this mask and device")
    nnz, n_empty = ix.nnz, int(ix.empty_row.shape[0])
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)  # noqa: E731
    d_a_dst, d_a_src_win, d_x_ext = new(B, nB * BLK, H), new(nB, B, W, H), new(B, n_ext, H, C)
    sp, sdz = new(B, H, max(nnz, 1)), new(B, H, max(nnz, 1))
    ss = new(B, nB, H, C) if n_empty else new(1)
    fn = _build.load("band_attention_bwd").band_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(a_dst.data_ptr(), a_src_win.data_ptr(), x_ext.data_ptr(), d_out.data_ptr(),
                ix.row_ptr.data_ptr(), ix.col.data_ptr(), ix.t_ptr.data_ptr(),
                ix.t_entry.data_ptr(), ix.t_row.data_ptr(), ix.empty_ptr.data_ptr(),
                ix.empty_row.data_ptr(), sp.data_ptr(), sdz.data_ptr(), ss.data_ptr(),
                d_a_dst.data_ptr(), d_a_src_win.data_ptr(), d_x_ext.data_ptr(),
                B, nB, BLK, W, H, C, nnz, n_empty, float(negative_slope),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"band_attention_bwd: kernel launch failed with CUDA error {rc}")
    band_attention_bwd.launches += 1
    return d_a_dst, d_a_src_win, d_x_ext


band_attention_bwd.launches = 0


class BandAttention(torch.autograd.Function):
    """Forward and backward through the kernels (CUDA tensors) or through
    their plain versions (CPU tensors). Saves its inputs only: the backward
    recomputes the softmax."""

    @staticmethod
    def forward(ctx, a_dst, a_src_win, x_ext, adj_mask, negative_slope, index):
        ctx.save_for_backward(a_dst, a_src_win, x_ext, adj_mask)
        ctx.negative_slope, ctx.index = negative_slope, index
        return band_attention_fwd(a_dst, a_src_win, x_ext, adj_mask, negative_slope)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_out):
        a_dst, a_src_win, x_ext, adj_mask = ctx.saved_tensors
        d_a_dst, d_a_src_win, d_x_ext = band_attention_bwd(
            a_dst, a_src_win, x_ext, adj_mask, d_out, ctx.negative_slope, ctx.index)
        return d_a_dst, d_a_src_win, d_x_ext, None, None, None


def band_attention(
    a_dst: torch.Tensor,
    a_src_win: torch.Tensor,
    x_ext: torch.Tensor,
    adj_mask: torch.Tensor,
    negative_slope: float = 0.2,
    index: Optional[bops.BandIndex] = None,
) -> torch.Tensor:
    """Differentiable banded attention, shapes as :func:`band_attention_fwd`.
    Gradients flow to ``a_dst``, ``a_src_win`` and ``x_ext``; the mask is a
    constant of the graph. ``index``: see :func:`band_attention_bwd`."""
    return BandAttention.apply(a_dst, a_src_win, x_ext, adj_mask, negative_slope, index)
