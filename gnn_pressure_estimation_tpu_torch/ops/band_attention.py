"""Banded GAT attention, forward: the CUDA kernel and its plain version.

Replaces ``make_band_attention_dma`` (v2) in
``gnn_pressure_estimation_tpu/ops/pallas/band_attention.py``, forward only,
with ``csrc/band_attention.cu``: per destination row, graph and head, the
LeakyReLU(0.2) additive logits over the row's W-wide window of the extended
node array, the int8 adjacency mask, a softmax over the window, and the
weighted sum of the window's rows.

Bound on an H100 SXM at the bigtown GATRes-large shapes (B 32, n_pad 5,888,
W 896, H·C 256): counted over the mask's nonzeros (0.51% dense) the work is
memory-bound — x_ext (214 MB) read once and out (193 MB) written once,
≈0.12 ms at 3.35 TB/s; counted over the dense window it is 86 GFLOP, ≈1.3 ms
at 67 TFLOP/s f32. The kernel skips masked columns (a warp ballot over the
mask row), so its work follows the nonzeros and its floor is the byte bound.

No ``torch.autograd.Function`` yet: the serving path is forward only; the
backward kernel (dα_dst, dα_src, windowed dx) is still to be ported.
"""

from __future__ import annotations

import ctypes

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


def _argtypes(lib):
    fn = lib.band_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def band_attention_fwd(
    a_dst: torch.Tensor,
    a_src_win: torch.Tensor,
    x_ext: torch.Tensor,
    adj_mask: torch.Tensor,
    negative_slope: float = 0.2,
) -> torch.Tensor:
    """a_dst [B, n_pad, H] · a_src_win [nB, B, W, H] · x_ext [B, n_ext, H, C]
    (n_ext = n_pad + W − BLK) · adj_mask [nB, BLK, W] (bool or int8)
    → [B, n_pad, H, C], all f32.

    On CUDA tensors it launches the kernel (or raises); on CPU tensors it
    runs :func:`band_attention_plain`. ``band_attention_fwd.launches`` counts
    kernel launches."""
    if x_ext.device.type == "cpu":
        return band_attention_plain(a_dst, a_src_win, x_ext, adj_mask, negative_slope)
    nB, BLK, W = adj_mask.shape
    B, n_ext, H, C = x_ext.shape
    n_pad = nB * BLK
    if x_ext.device.type != "cuda":
        raise ValueError(f"band_attention_fwd: unsupported device {x_ext.device}")
    if a_dst.shape != (B, n_pad, H) or a_src_win.shape != (nB, B, W, H):
        raise ValueError(
            f"band_attention_fwd: shapes a_dst {tuple(a_dst.shape)}, a_src_win "
            f"{tuple(a_src_win.shape)} do not fit x_ext {tuple(x_ext.shape)}, "
            f"mask {tuple(adj_mask.shape)}")
    if n_ext != n_pad + W - BLK:
        raise ValueError(f"band_attention_fwd: x_ext has {n_ext} rows, expected {n_pad + W - BLK}")
    for name, t in (("a_dst", a_dst), ("a_src_win", a_src_win), ("x_ext", x_ext)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != x_ext.device:
            raise ValueError(f"band_attention_fwd: {name} must be contiguous f32 on {x_ext.device}")
    if adj_mask.dtype == torch.bool:
        adj_mask = adj_mask.view(torch.int8)
    if adj_mask.dtype != torch.int8 or not adj_mask.is_contiguous() or adj_mask.device != x_ext.device:
        raise ValueError(f"band_attention_fwd: adj_mask must be contiguous int8/bool on {x_ext.device}")
    out = torch.empty((B, n_pad, H, C), dtype=torch.float32, device=x_ext.device)
    fn = _argtypes(_build.load("band_attention"))
    with torch.cuda.device(x_ext.device):
        rc = fn(a_dst.data_ptr(), a_src_win.data_ptr(), x_ext.data_ptr(),
                adj_mask.data_ptr(), out.data_ptr(), B, nB, BLK, W, H, C,
                float(negative_slope), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"band_attention_fwd: kernel launch failed with CUDA error {rc}")
    band_attention_fwd.launches += 1
    return out


band_attention_fwd.launches = 0
