"""Banded GAT attention: the CUDA kernels, forward and backward, and their
plain versions. Three routes compute the same function; which one a graph
takes is ``BatchedGraph.band_attn`` (``ops.banded.band_attention_route``):

* :func:`band_attention` ("dma") replaces ``make_band_attention_dma`` (v2) in
  ``gnn_pressure_estimation_tpu/ops/pallas/band_attention.py``
  (``csrc/band_attention.cu``, ``csrc/band_attention_bwd.cu``). The forward
  scans the int8 mask row; the backward recomputes the softmax.
* :func:`band_attention_flash` ("flash") replaces ``make_band_attention_flash``
  (v4) (``csrc/band_attention_flash.cu``, ``csrc/band_attention_flash_bwd.cu``):
  a streaming softmax whose per-row state does not grow with W. The forward
  returns the row statistics m and Z; the backward takes them and
  ``delta = Σ_c dO∘O`` and rebuilds each weight on its own.
* :func:`band_attention_window` ("window") replaces ``make_band_attention``
  (v1) (``csrc/band_attention_window.cu``, ``csrc/band_attention_window_bwd.cu``):
  it reads the materialised window tensors ``x_win`` / ``a_src_win``, never an
  extended array, and its backward leaves ``d a_src_win`` and ``d x_win`` in
  window layout for autograd to fold.

Each computes, per destination row, graph and head, the LeakyReLU(0.2)
additive logits over the row's W-wide window, the adjacency mask, a softmax
over the window, and the weighted sum of the window's rows. Each entry point
is a ``torch.autograd.Function``; the mask gets no gradient. A row with no
set column (a padded band row) gets the uniform mean of its W window rows on
every route, as ``ops.banded.band_attention`` gives it. The TPU kernels'
``mxu_bf16`` matmul option is not carried: everything is f32.

Bound on an H100 SXM at the bigtown GATRes-large shapes (B 32, n_pad 5,888,
W 896, H·C 256): counted over the mask's nonzeros (0.51% dense) the forward
is memory-bound — x_ext (214 MB) read once and out (193 MB) written once,
≈0.12 ms at 3.35 TB/s; counted over the dense window it is 86 GFLOP, ≈1.3 ms
at 67 TFLOP/s f32. The v2 forward kernel skips masked columns (a warp ballot
over the mask row), so its work follows the nonzeros and its floor is the
byte bound. The backward reads x_ext and dO and writes d x_ext (≈0.19 ms at
those shapes); it recomputes the softmax, as v2 does, and walks the mask's
nonzeros through a :class:`~..ops.banded.BandIndex` (row lists, then the same
entries grouped by the extended row they read), so the overlapping windows
fold without atomics and a run repeats to the bit. The flash and window
kernels walk the same index in both directions; the window route's bound is
the dense ``[nB, B, W, H, C]`` tensors it must read and write.
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
    d_a_dst, d_a_src_win, d_xw = band_attention_window_bwd_plain(
        a_dst, a_src_win, bops.band_windows_ext(x_ext, nB, BLK, W), adj_mask, d_out,
        negative_slope)
    return d_a_dst, d_a_src_win, bops.fold_windows_ext(d_xw, BLK)


def _check(fn: str, a_dst, a_src_win, x, adj_mask):
    """Raise on what the kernels do not take; returns the int8 mask. ``x`` is
    the extended array [B, n_ext, H, C] or, for the window kernels, the
    materialised windows [nB, B, W, H, C]."""
    nB, BLK, W = adj_mask.shape
    n_pad = nB * BLK
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")
    if x.dim() == 5:
        B, H, fits = x.shape[1], x.shape[3], x.shape[0] == nB and x.shape[2] == W
    else:
        B, n_ext, H, _ = x.shape
        fits = n_ext == n_pad + W - BLK
    if not fits or a_dst.shape != (B, n_pad, H) or a_src_win.shape != (nB, B, W, H):
        raise ValueError(
            f"{fn}: shapes a_dst {tuple(a_dst.shape)}, a_src_win {tuple(a_src_win.shape)}, "
            f"x {tuple(x.shape)} do not fit mask {tuple(adj_mask.shape)}")
    for name, t in (("a_dst", a_dst), ("a_src_win", a_src_win), ("x", x)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{fn}: {name} must be contiguous f32 on {x.device}")
    if adj_mask.dtype == torch.bool:
        adj_mask = adj_mask.view(torch.int8)
    if adj_mask.dtype != torch.int8 or not adj_mask.is_contiguous() or adj_mask.device != x.device:
        raise ValueError(f"{fn}: adj_mask must be contiguous int8/bool on {x.device}")
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


# ---- the streaming-softmax route (v4) ---------------------------------------

def _logits(a_dst, a_src_win, adj_mask, negative_slope):
    """The masked LeakyReLU logits [nB,B,BLK,W,H] (−1e9 where the mask is 0),
    the pre-activation a_dst + a_src, whose sign LeakyReLU and its VJP take,
    and the mask broadcast to them."""
    nB, BLK, _ = adj_mask.shape
    on = adj_mask.bool()[:, None, :, :, None]                          # [nB,1,BLK,W,1]
    zpre = _blocks_of(a_dst, nB, BLK)[:, :, :, None, :] + a_src_win[:, :, None, :, :]
    z = torch.where(zpre >= 0, zpre, negative_slope * zpre)
    z = torch.where(on, z, torch.full((), -1e9, dtype=z.dtype, device=z.device))
    return z, zpre, on


def _row_stats(z):
    """m (row maximum) and Z (sum of exp(z − m)) of the logits, [nB,B,BLK,1,H]."""
    m = z.amax(dim=3, keepdim=True)
    return m, torch.exp(z - m).sum(dim=3, keepdim=True)


def _rows_of(t, B, nB, BLK):
    """[nB, B, BLK, ...] block-major → [B, nB·BLK, ...]."""
    return t.movedim(0, 1).reshape((B, nB * BLK) + t.shape[3:])


def _blocks_of(t, nB, BLK):
    """[B, nB·BLK, ...] → [nB, B, BLK, ...] block-major."""
    return t.reshape((t.shape[0], nB, BLK) + t.shape[2:]).movedim(1, 0)


def band_attention_flash_plain(
    a_dst: torch.Tensor, a_src_win: torch.Tensor, x_ext: torch.Tensor,
    adj_mask: torch.Tensor, negative_slope: float = 0.2,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`band_attention_flash_fwd`:
    ``(out [B, n_pad, H, C], m [B, n_pad, H], Z [B, n_pad, H])`` with m the
    row maximum of the masked logits and Z the sum of ``exp(z − m)``; a row
    with no set column has m = −1e9 and Z = W."""
    nB, BLK, W = adj_mask.shape
    B = x_ext.shape[0]
    z, _, _ = _logits(a_dst, a_src_win, adj_mask, negative_slope)
    m, Z = _row_stats(z)
    x_win = bops.band_windows_ext(x_ext, nB, BLK, W)
    out = torch.einsum("nbiwh,nbwhc->nbihc", torch.exp(z - m) / Z, x_win)
    return (_rows_of(out, B, nB, BLK), _rows_of(m[:, :, :, 0], B, nB, BLK),
            _rows_of(Z[:, :, :, 0], B, nB, BLK))


def band_attention_flash_bwd_plain(
    a_dst: torch.Tensor, a_src_win: torch.Tensor, x_ext: torch.Tensor,
    adj_mask: torch.Tensor, m: torch.Tensor, Z: torch.Tensor, delta: torch.Tensor,
    d_out: torch.Tensor, negative_slope: float = 0.2,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`band_attention_flash_bwd`: the weights
    rebuilt from the saved ``m``, ``Z`` as ``exp(z − m)/Z``, the softmax VJP's
    row term taken from ``delta`` ([B, n_pad, H]), window fold included."""
    nB, BLK, W = adj_mask.shape
    B = x_ext.shape[0]
    z, zpre, on = _logits(a_dst, a_src_win, adj_mask, negative_slope)
    p = torch.exp(z - _blocks_of(m, nB, BLK)[:, :, :, None, :]) \
        / _blocks_of(Z, nB, BLK)[:, :, :, None, :]
    x_win = bops.band_windows_ext(x_ext, nB, BLK, W)
    do_b = _blocks_of(d_out, nB, BLK)                                 # [nB,B,BLK,H,C]
    dp = torch.einsum("nbihc,nbwhc->nbiwh", do_b, x_win)
    dz = p * (dp - _blocks_of(delta, nB, BLK)[:, :, :, None, :])
    dz = torch.where(zpre >= 0, dz, negative_slope * dz) * on
    dxw = torch.einsum("nbiwh,nbihc->nbwhc", p, do_b)
    return _rows_of(dz.sum(dim=3), B, nB, BLK), dz.sum(dim=2), bops.fold_windows_ext(dxw, BLK)


def _index_for(fn: str, adj_mask, index, dev):
    """The mask's BandIndex on ``dev``: the caller's (checked) or one built
    from the mask's values."""
    ix = bops.band_index_of(adj_mask) if index is None else index
    if (ix.nB, ix.BLK, ix.W) != tuple(adj_mask.shape) or ix.col.device != dev:
        raise ValueError(f"{fn}: index does not belong to this mask and device")
    return ix


def _check_rows(fn: str, x, **rows):
    """Per-row operands of a backward: f32 on the device of ``x``; returns
    them contiguous."""
    for name, (t, shape) in rows.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"{fn}: {name} {tuple(t.shape)} {t.dtype} on {t.device} does not fit "
                             f"{shape} f32 on {x.device}")
    return [t.contiguous() for t, _ in rows.values()]


def band_attention_flash_fwd(
    a_dst: torch.Tensor, a_src_win: torch.Tensor, x_ext: torch.Tensor,
    adj_mask: torch.Tensor, negative_slope: float = 0.2,
    index: Optional[bops.BandIndex] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shapes as :func:`band_attention_fwd`; returns ``(out, m, Z)``, the row
    statistics [B, n_pad, H] that :func:`band_attention_flash_bwd` takes. No
    autograd: see :func:`band_attention_flash`.

    On CUDA tensors it launches the kernel (or raises); on CPU tensors it
    runs :func:`band_attention_flash_plain`. ``index``: the mask's
    :class:`BandIndex` on the same device (the template's cached one on the
    model's path), else built from the mask's values.
    ``band_attention_flash_fwd.launches`` counts kernel launches."""
    if bops.use_plain(x_ext):
        return band_attention_flash_plain(a_dst, a_src_win, x_ext, adj_mask, negative_slope)
    adj_mask = _check("band_attention_flash_fwd", a_dst, a_src_win, x_ext, adj_mask)
    nB, BLK, W = adj_mask.shape
    B, _, H, C = x_ext.shape
    dev = x_ext.device
    ix = _index_for("band_attention_flash_fwd", adj_mask, index, dev)
    out = torch.empty((B, nB * BLK, H, C), dtype=torch.float32, device=dev)
    m, Z = (torch.empty((B, nB * BLK, H), dtype=torch.float32, device=dev) for _ in range(2))
    fn = _build.load("band_attention_flash").band_attention_flash_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(a_dst.data_ptr(), a_src_win.data_ptr(), x_ext.data_ptr(),
                ix.row_ptr.data_ptr(), ix.col.data_ptr(), out.data_ptr(), m.data_ptr(),
                Z.data_ptr(), B, nB, BLK, W, H, C, float(negative_slope),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"band_attention_flash_fwd: kernel launch failed with CUDA error {rc}")
    band_attention_flash_fwd.launches += 1
    return out, m, Z


band_attention_flash_fwd.launches = 0


def band_attention_flash_bwd(
    a_dst: torch.Tensor, a_src_win: torch.Tensor, x_ext: torch.Tensor,
    adj_mask: torch.Tensor, m: torch.Tensor, Z: torch.Tensor, delta: torch.Tensor,
    d_out: torch.Tensor, negative_slope: float = 0.2,
    index: Optional[bops.BandIndex] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The cotangents ``(d a_dst, d a_src_win, d x_ext)`` of
    :func:`band_attention_flash_fwd` from its saved ``m``, ``Z``, the row term
    ``delta = Σ_c d_out∘out`` [B, n_pad, H] and ``d_out`` [B, n_pad, H, C],
    window fold included.

    On CUDA tensors it launches the kernel (or raises); on CPU tensors it
    runs :func:`band_attention_flash_bwd_plain`.
    ``band_attention_flash_bwd.launches`` counts kernel launches (one per
    call: the passes of ``csrc/band_attention_flash_bwd.cu`` are one launch
    of it)."""
    if bops.use_plain(x_ext):
        return band_attention_flash_bwd_plain(a_dst, a_src_win, x_ext, adj_mask, m, Z, delta,
                                              d_out, negative_slope)
    name = "band_attention_flash_bwd"
    adj_mask = _check(name, a_dst, a_src_win, x_ext, adj_mask)
    nB, BLK, W = adj_mask.shape
    B, n_ext, H, C = x_ext.shape
    dev = x_ext.device
    rows = (B, nB * BLK, H)
    m, Z, delta, d_out = _check_rows(name, x_ext, m=(m, rows), Z=(Z, rows), delta=(delta, rows),
                                     d_out=(d_out, rows + (C,)))
    ix = _index_for(name, adj_mask, index, dev)
    nnz, n_empty = ix.nnz, int(ix.empty_row.shape[0])
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)  # noqa: E731
    d_a_dst, d_a_src_win, d_x_ext = new(*rows), new(nB, B, W, H), new(B, n_ext, H, C)
    sdz = new(B, H, max(nnz, 1))
    ss = new(B, nB, H, C) if n_empty else new(1)
    fn = _build.load(name).band_attention_flash_bwd
    fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(a_dst.data_ptr(), a_src_win.data_ptr(), x_ext.data_ptr(), m.data_ptr(),
                Z.data_ptr(), delta.data_ptr(), d_out.data_ptr(), ix.row_ptr.data_ptr(),
                ix.t_ptr.data_ptr(), ix.t_entry.data_ptr(), ix.t_row.data_ptr(),
                ix.empty_ptr.data_ptr(), ix.empty_row.data_ptr(), sdz.data_ptr(), ss.data_ptr(),
                d_a_dst.data_ptr(), d_a_src_win.data_ptr(), d_x_ext.data_ptr(),
                B, nB, BLK, W, H, C, nnz, n_empty, float(negative_slope),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
    band_attention_flash_bwd.launches += 1
    return d_a_dst, d_a_src_win, d_x_ext


band_attention_flash_bwd.launches = 0


class BandAttentionFlash(torch.autograd.Function):
    """Forward and backward through the streaming-softmax kernels (CUDA
    tensors) or their plain versions (CPU tensors). Saves its inputs, its
    output and the row statistics m, Z; the backward takes no row maximum or
    sum again."""

    @staticmethod
    def forward(ctx, a_dst, a_src_win, x_ext, adj_mask, negative_slope, index):
        out, m, Z = band_attention_flash_fwd(a_dst, a_src_win, x_ext, adj_mask, negative_slope,
                                             index)
        ctx.save_for_backward(a_dst, a_src_win, x_ext, adj_mask, m, Z, out)
        ctx.negative_slope, ctx.index = negative_slope, index
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_out):
        a_dst, a_src_win, x_ext, adj_mask, m, Z, out = ctx.saved_tensors
        delta = (d_out * out).sum(dim=-1)                 # [B, n_pad, H]
        d_a_dst, d_a_src_win, d_x_ext = band_attention_flash_bwd(
            a_dst, a_src_win, x_ext, adj_mask, m, Z, delta, d_out, ctx.negative_slope, ctx.index)
        return d_a_dst, d_a_src_win, d_x_ext, None, None, None


def band_attention_flash(
    a_dst: torch.Tensor, a_src_win: torch.Tensor, x_ext: torch.Tensor,
    adj_mask: torch.Tensor, negative_slope: float = 0.2,
    index: Optional[bops.BandIndex] = None,
) -> torch.Tensor:
    """Differentiable banded attention through the streaming-softmax route,
    shapes and gradients as :func:`band_attention`."""
    return BandAttentionFlash.apply(a_dst, a_src_win, x_ext, adj_mask, negative_slope, index)


# ---- the materialised-window route (v1) --------------------------------------

def band_attention_window_plain(
    a_dst: torch.Tensor,      # [B, n_pad, H]
    a_src_win: torch.Tensor,  # [nB, B, W, H]
    x_win: torch.Tensor,      # [nB, B, W, H, C]
    adj_mask: torch.Tensor,   # [nB, BLK, W] bool or 0/1 int8
    negative_slope: float = 0.2,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`band_attention_window_fwd`."""
    return bops.band_attention(a_dst, a_src_win, x_win, adj_mask, negative_slope)


def band_attention_window_bwd_plain(
    a_dst: torch.Tensor, a_src_win: torch.Tensor, x_win: torch.Tensor,
    adj_mask: torch.Tensor, d_out: torch.Tensor, negative_slope: float = 0.2,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`band_attention_window_bwd`:
    ``(d a_dst [B, n_pad, H], d a_src_win [nB, B, W, H], d x_win
    [nB, B, W, H, C])``, the last two in window layout, not folded."""
    nB, BLK, W = adj_mask.shape
    B = x_win.shape[1]
    z, zpre, on = _logits(a_dst, a_src_win, adj_mask, negative_slope)
    m, Z = _row_stats(z)
    p = torch.exp(z - m) / Z
    do_b = _blocks_of(d_out, nB, BLK)
    dp = torch.einsum("nbihc,nbwhc->nbiwh", do_b, x_win)
    dz = p * (dp - (p * dp).sum(dim=3, keepdim=True))
    dz = torch.where(zpre >= 0, dz, negative_slope * dz) * on
    return (_rows_of(dz.sum(dim=3), B, nB, BLK), dz.sum(dim=2),
            torch.einsum("nbiwh,nbihc->nbwhc", p, do_b))


def band_attention_window_fwd(
    a_dst: torch.Tensor, a_src_win: torch.Tensor, x_win: torch.Tensor,
    adj_mask: torch.Tensor, negative_slope: float = 0.2,
    index: Optional[bops.BandIndex] = None,
) -> torch.Tensor:
    """a_dst [B, n_pad, H] · a_src_win [nB, B, W, H] · x_win [nB, B, W, H, C]
    · adj_mask [nB, BLK, W] (bool or int8) → [B, n_pad, H, C], all f32. No
    autograd: see :func:`band_attention_window`.

    On CUDA tensors it launches the kernel (or raises); on CPU tensors it
    runs :func:`band_attention_window_plain`. ``index`` as for
    :func:`band_attention_flash_fwd`. ``band_attention_window_fwd.launches``
    counts kernel launches."""
    if bops.use_plain(x_win):
        return band_attention_window_plain(a_dst, a_src_win, x_win, adj_mask, negative_slope)
    adj_mask = _check("band_attention_window_fwd", a_dst, a_src_win, x_win, adj_mask)
    nB, BLK, W = adj_mask.shape
    _, B, _, H, C = x_win.shape
    dev = x_win.device
    ix = _index_for("band_attention_window_fwd", adj_mask, index, dev)
    out = torch.empty((B, nB * BLK, H, C), dtype=torch.float32, device=dev)
    fn = _build.load("band_attention_window").band_attention_window_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(a_dst.data_ptr(), a_src_win.data_ptr(), x_win.data_ptr(), ix.row_ptr.data_ptr(),
                ix.col.data_ptr(), out.data_ptr(), B, nB, BLK, W, H, C, float(negative_slope),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"band_attention_window_fwd: kernel launch failed with CUDA error {rc}")
    band_attention_window_fwd.launches += 1
    return out


band_attention_window_fwd.launches = 0


def band_attention_window_bwd(
    a_dst: torch.Tensor, a_src_win: torch.Tensor, x_win: torch.Tensor,
    adj_mask: torch.Tensor, d_out: torch.Tensor, negative_slope: float = 0.2,
    index: Optional[bops.BandIndex] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The cotangents ``(d a_dst, d a_src_win, d x_win)`` of
    :func:`band_attention_window_fwd` for ``d_out`` [B, n_pad, H, C]; the two
    window cotangents in window layout, every cell written once.

    On CUDA tensors it launches the kernel (or raises); on CPU tensors it
    runs :func:`band_attention_window_bwd_plain`.
    ``band_attention_window_bwd.launches`` counts kernel launches (one per
    call)."""
    if bops.use_plain(x_win):
        return band_attention_window_bwd_plain(a_dst, a_src_win, x_win, adj_mask, d_out,
                                               negative_slope)
    name = "band_attention_window_bwd"
    adj_mask = _check(name, a_dst, a_src_win, x_win, adj_mask)
    nB, BLK, W = adj_mask.shape
    _, B, _, H, C = x_win.shape
    dev = x_win.device
    (d_out,) = _check_rows(name, x_win, d_out=(d_out, (B, nB * BLK, H, C)))
    ix = _index_for(name, adj_mask, index, dev)
    nnz, n_empty = ix.nnz, int(ix.empty_row.shape[0])
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)  # noqa: E731
    d_a_dst, d_a_src_win, d_x_win = new(B, nB * BLK, H), new(nB, B, W, H), new(nB, B, W, H, C)
    sp, sdz = new(B, H, max(nnz, 1)), new(B, H, max(nnz, 1))
    ss = new(B, nB, H, C) if n_empty else new(1)
    fn = _build.load(name).band_attention_window_bwd
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(a_dst.data_ptr(), a_src_win.data_ptr(), x_win.data_ptr(), d_out.data_ptr(),
                ix.row_ptr.data_ptr(), ix.col.data_ptr(), ix.t_ptr.data_ptr(),
                ix.t_entry.data_ptr(), ix.t_row.data_ptr(), ix.empty_ptr.data_ptr(),
                ix.empty_row.data_ptr(), sp.data_ptr(), sdz.data_ptr(), ss.data_ptr(),
                d_a_dst.data_ptr(), d_a_src_win.data_ptr(), d_x_win.data_ptr(),
                B, nB, BLK, W, H, C, nnz, n_empty, float(negative_slope),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
    band_attention_window_bwd.launches += 1
    return d_a_dst, d_a_src_win, d_x_win


band_attention_window_bwd.launches = 0


class BandAttentionWindow(torch.autograd.Function):
    """Forward and backward through the window kernels (CUDA tensors) or
    their plain versions (CPU tensors). Saves its inputs only: the backward
    recomputes the softmax."""

    @staticmethod
    def forward(ctx, a_dst, a_src_win, x_win, adj_mask, negative_slope, index):
        ctx.save_for_backward(a_dst, a_src_win, x_win, adj_mask)
        ctx.negative_slope, ctx.index = negative_slope, index
        return band_attention_window_fwd(a_dst, a_src_win, x_win, adj_mask, negative_slope, index)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_out):
        a_dst, a_src_win, x_win, adj_mask = ctx.saved_tensors
        d_a_dst, d_a_src_win, d_x_win = band_attention_window_bwd(
            a_dst, a_src_win, x_win, adj_mask, d_out, ctx.negative_slope, ctx.index)
        return d_a_dst, d_a_src_win, d_x_win, None, None, None


def band_attention_window(
    a_dst: torch.Tensor, a_src_win: torch.Tensor, x_win: torch.Tensor,
    adj_mask: torch.Tensor, negative_slope: float = 0.2,
    index: Optional[bops.BandIndex] = None,
) -> torch.Tensor:
    """Differentiable banded attention over materialised windows, shapes as
    :func:`band_attention_window_fwd`. Gradients flow to ``a_dst``,
    ``a_src_win`` and ``x_win`` (window layout); the mask is a constant."""
    return BandAttentionWindow.apply(a_dst, a_src_win, x_win, adj_mask, negative_slope, index)
