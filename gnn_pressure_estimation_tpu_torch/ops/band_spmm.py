"""Banded SpMM: the CUDA kernels, forward and backward, and their plain
versions.

Replaces ``make_band_spmm_flash`` in
``gnn_pressure_estimation_tpu/ops/pallas/band_attention.py``, forward
(``csrc/band_spmm.cu``) and backward (``csrc/band_spmm_bwd.cu``):
``out[b, i·BLK + r] = Σ_j band[i, r, j] · x_ext[b, i·BLK + j]`` for an int8
count band or an f32 weight band. The row and column scales of the factored
bands (SimpleMeanConv's 1/deg) are applied outside, as in
``models/layers.py``. :func:`band_spmm` is the differentiable entry point (a
``torch.autograd.Function``). The band is a constant of the graph: it gets
no gradient, and a band that requires one raises, as the JAX kernel's
contract demands (trainable band weights do not belong here).

Bound on an H100 SXM at the bigtown GATRes-large shapes (B 32, n_pad 5,888,
W 896, C 128): counted over the band's nonzeros the work is memory-bound —
x_ext (107 MB) read once and out (96 MB) written once, ≈0.06 ms at
3.35 TB/s, forward and backward alike; counted over the dense window it is
43 GFLOP, ≈0.64 ms at 67 TFLOP/s f32. Both kernels walk the band's
nonzeros through a :class:`~..ops.banded.BandIndex`, which carries their
values as f32, so the int8 and f32 bands take the same kernels: the forward
its row lists (one warp per output row, 16-byte loads of the x rows), the
backward, its mirror image, the same entries grouped by the extended row they
read (one warp per extended row, 16-byte loads of the dO rows), so the
overlapping windows fold without atomics.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from gnn_pressure_estimation_tpu_torch.ops import _build
from gnn_pressure_estimation_tpu_torch.ops import banded as bops


def band_spmm_plain(band: torch.Tensor, x_ext: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`band_spmm_fwd`."""
    nB, BLK, W = band.shape
    return bops.band_spmm(band, bops.band_windows_ext(x_ext, nB, BLK, W))


def band_spmm_bwd_plain(band: torch.Tensor, d_out: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`band_spmm_bwd`: ``bandᵀ @ d_out`` per
    block, then the window fold. ``d_out`` [B, n_pad, C] → ``d x_ext``
    [B, n_ext, C]."""
    nB, BLK, W = band.shape
    B, _, C = d_out.shape
    dxw = torch.einsum("niw,bnic->nbwc", band.to(d_out.dtype), d_out.reshape(B, nB, BLK, C))
    return bops.fold_windows_ext(dxw, BLK)


def _check(fn: str, band, x, rows: int):
    """Raise on what the kernels do not take (``x``: [B, rows, C])."""
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")
    if x.dim() != 3 or x.shape[1] != rows:
        raise ValueError(f"{fn}: got {tuple(x.shape)}, expected {rows} rows")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{fn}: the dense operand must be contiguous f32")
    if band.dtype not in (torch.int8, torch.float32) or not band.is_contiguous() \
            or band.device != x.device:
        raise ValueError(f"{fn}: band must be contiguous int8/f32 on {x.device}")


def band_spmm_fwd(band: torch.Tensor, x_ext: torch.Tensor,
                  index: Optional[bops.BandIndex] = None) -> torch.Tensor:
    """band [nB, BLK, W] (int8 counts or f32) · x_ext [B, n_ext, C] f32
    (n_ext = nB·BLK + W − BLK) → [B, nB·BLK, C] f32. No autograd: see
    :func:`band_spmm`.

    ``index`` is the band's :class:`BandIndex` on the same device (the
    template's cached one on the model's path); without it the index is
    built from the band's values on the host. The kernel walks its row lists
    and reads the values from it, never the band, so an index built from
    another band of the same shape gives that band's product on the card;
    only its shape and device are checked. On CUDA tensors it launches the
    kernel (or raises); on CPU tensors it runs :func:`band_spmm_plain`.
    ``band_spmm_fwd.launches`` counts kernel launches."""
    if bops.use_plain(x_ext):
        return band_spmm_plain(band, x_ext)
    nB, BLK, W = band.shape
    _check("band_spmm_fwd", band, x_ext, nB * BLK + W - BLK)
    B, _, C = x_ext.shape
    ix = bops.index_for("band_spmm_fwd", band, index, x_ext.device)
    out = torch.empty((B, nB * BLK, C), dtype=torch.float32, device=x_ext.device)
    fn = _build.load("band_spmm").band_spmm_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x_ext.device):
        rc = fn(x_ext.data_ptr(), ix.row_ptr.data_ptr(), ix.col.data_ptr(), ix.val.data_ptr(),
                out.data_ptr(), B, nB, BLK, W, C, int(bops.vector_loads(x_ext, C)),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"band_spmm_fwd: kernel launch failed with CUDA error {rc}")
    band_spmm_fwd.launches += 1
    return out


band_spmm_fwd.launches = 0


def band_spmm_bwd(band: torch.Tensor, d_out: torch.Tensor,
                  index: Optional[bops.BandIndex] = None) -> torch.Tensor:
    """The cotangent ``d x_ext`` [B, n_ext, C] of :func:`band_spmm_fwd` for
    the output cotangent ``d_out`` [B, nB·BLK, C], window fold included.

    ``index`` is the band's :class:`BandIndex` on the same device (the
    template's cached one on the model's path); without it the index is
    built from the band's values. The kernel walks the entries by the
    extended row they read (``t_ptr``, ``t_row``) with their values in that
    order (``t_val``), never the band. On CUDA tensors it launches the kernel
    (or raises); on CPU tensors it runs :func:`band_spmm_bwd_plain`.
    ``band_spmm_bwd.launches`` counts kernel launches."""
    if bops.use_plain(d_out):
        return band_spmm_bwd_plain(band, d_out)
    nB, BLK, W = band.shape
    d_out = d_out.contiguous()
    _check("band_spmm_bwd", band, d_out, nB * BLK)
    B, _, C = d_out.shape
    ix = bops.index_for("band_spmm_bwd", band, index, d_out.device)
    d_x_ext = torch.empty((B, nB * BLK + W - BLK, C), dtype=torch.float32, device=d_out.device)
    fn = _build.load("band_spmm_bwd").band_spmm_bwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(d_out.device):
        rc = fn(d_out.data_ptr(), ix.t_ptr.data_ptr(), ix.t_row.data_ptr(), ix.t_val.data_ptr(),
                d_x_ext.data_ptr(), B, nB, BLK, W, C, int(bops.vector_loads(d_out, C)),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"band_spmm_bwd: kernel launch failed with CUDA error {rc}")
    band_spmm_bwd.launches += 1
    return d_x_ext


band_spmm_bwd.launches = 0


class BandSpmm(torch.autograd.Function):
    """Forward and backward through the kernels (CUDA tensors) or through
    their plain versions (CPU tensors). Saves the band only."""

    @staticmethod
    def forward(ctx, band, x_ext, index):
        ctx.save_for_backward(band)
        ctx.index = index
        return band_spmm_fwd(band, x_ext, index)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_out):
        (band,) = ctx.saved_tensors
        return None, band_spmm_bwd(band, d_out, ctx.index), None


def band_spmm(band: torch.Tensor, x_ext: torch.Tensor,
              index: Optional[bops.BandIndex] = None) -> torch.Tensor:
    """Differentiable banded SpMM, shapes as :func:`band_spmm_fwd`. Gradients
    flow to ``x_ext`` only; a band that requires a gradient raises.
    ``index``: see :func:`band_spmm_bwd`."""
    if band.requires_grad:
        raise ValueError(
            "band_spmm: the band is a constant of the graph and gets no gradient; "
            "do not route trainable band weights through this kernel")
    return BandSpmm.apply(band, x_ext, index)
