"""Banded SpMM, forward: the CUDA kernel and its plain version.

Replaces ``make_band_spmm_flash`` in
``gnn_pressure_estimation_tpu/ops/pallas/band_attention.py``, forward only,
with ``csrc/band_spmm.cu``: ``out[b, i·BLK + r] = Σ_j band[i, r, j] ·
x_ext[b, i·BLK + j]`` for an int8 count band or an f32 weight band. The row
and column scales of the factored bands (SimpleMeanConv's 1/deg) are
applied outside, as in ``models/layers.py``.

Bound on an H100 SXM at the bigtown GATRes-large shapes (B 32, n_pad 5,888,
W 896, C 128): counted over the band's nonzeros the work is memory-bound —
x_ext (107 MB) read once and out (96 MB) written once, ≈0.06 ms at
3.35 TB/s; counted over the dense window it is 43 GFLOP, ≈0.64 ms at
67 TFLOP/s f32. The kernel skips zero band entries (a warp ballot over the
band row), so its work follows the nonzeros and its floor is the byte bound.

No ``torch.autograd.Function`` yet: the serving path is forward only; the
backward (a windowed dx fold, zero band cotangent) is still to be ported.
"""

from __future__ import annotations

import ctypes

import torch

from gnn_pressure_estimation_tpu_torch.ops import _build
from gnn_pressure_estimation_tpu_torch.ops import banded as bops


def band_spmm_plain(band: torch.Tensor, x_ext: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`band_spmm_fwd`."""
    nB, BLK, W = band.shape
    return bops.band_spmm(band, bops.band_windows_ext(x_ext, nB, BLK, W))


def _fn(dtype):
    lib = _build.load("band_spmm")
    fn = lib.band_spmm_fwd_i8 if dtype == torch.int8 else lib.band_spmm_fwd_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def band_spmm_fwd(band: torch.Tensor, x_ext: torch.Tensor) -> torch.Tensor:
    """band [nB, BLK, W] (int8 counts or f32) · x_ext [B, n_ext, C] f32
    (n_ext = nB·BLK + W − BLK) → [B, nB·BLK, C] f32.

    On CUDA tensors it launches the kernel (or raises); on CPU tensors it
    runs :func:`band_spmm_plain`. ``band_spmm_fwd.launches`` counts kernel
    launches."""
    if x_ext.device.type == "cpu":
        return band_spmm_plain(band, x_ext)
    nB, BLK, W = band.shape
    B, n_ext, C = x_ext.shape
    n_pad = nB * BLK
    if x_ext.device.type != "cuda":
        raise ValueError(f"band_spmm_fwd: unsupported device {x_ext.device}")
    if n_ext != n_pad + W - BLK:
        raise ValueError(f"band_spmm_fwd: x_ext has {n_ext} rows, expected {n_pad + W - BLK}")
    if x_ext.dtype != torch.float32 or not x_ext.is_contiguous():
        raise ValueError("band_spmm_fwd: x_ext must be contiguous f32")
    if band.dtype not in (torch.int8, torch.float32) or not band.is_contiguous() \
            or band.device != x_ext.device:
        raise ValueError(f"band_spmm_fwd: band must be contiguous int8/f32 on {x_ext.device}")
    out = torch.empty((B, n_pad, C), dtype=torch.float32, device=x_ext.device)
    fn = _fn(band.dtype)
    with torch.cuda.device(x_ext.device):
        rc = fn(band.data_ptr(), x_ext.data_ptr(), out.data_ptr(), B, nB, BLK, W, C,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"band_spmm_fwd: kernel launch failed with CUDA error {rc}")
    band_spmm_fwd.launches += 1
    return out


band_spmm_fwd.launches = 0
