"""GATConv's attention logit halves: the CUDA kernels, forward and backward,
and their plain versions.

For the projected rows ``xp`` [N, H, C] and the layer's ``att_src``,
``att_dst`` [1, H, C]: ``a_s = (xp · att_src).sum(-1)`` and
``a_d = (xp · att_dst).sum(-1)``, [N, H] f32 (``csrc/gat_logits.cu``). In
plain PyTorch each half writes a whole [N, H, C] product and reads it back to
reduce it, and autograd's backward writes two more such tensors a half and
adds them into d xp; the kernels read xp once forward, and read xp and the
projected rows' cotangent once backward, writing d xp once. The JAX layer
computes the halves elementwise in f32, and so do the kernels at every
matmul-precision setting: they are not GEMMs.

:func:`gat_logits` is the layer's entry point. On the card it runs
:class:`GatLogits`, which returns ``xp`` itself as its first output; the
layer hands that to the attention in place of ``xp``, so that the backward
receives the rows' own cotangent together with d a_s and d a_d and forms
d xp in the same pass. On the CPU it runs the plain expression under
autograd, so the CPU's numbers are the layer's from before the kernels. d att_src and d att_dst
are summed over the rows in a fixed order (per-chunk partials, then a fold
over the chunks), so two runs give the same bits.

Bound on an H100 SXM at bigtown B 32 (N 188,416): xp is 193 MB at H·C 256
and 96 MB at 128, ≈0.058 / 0.029 ms forward at 3.35 TB/s; the backward moves
three times the bytes.
"""

from __future__ import annotations

import ctypes

import torch

from gnn_pressure_estimation_tpu_torch.ops import _build
from gnn_pressure_estimation_tpu_torch.ops import banded as bops


def gat_logits_plain(xp: torch.Tensor, att_src: torch.Tensor, att_dst: torch.Tensor):
    """Plain PyTorch version of :func:`gat_logits_fwd`: the layer's own
    expression, ``(a_s, a_d)``."""
    return (xp * att_src).sum(-1), (xp * att_dst).sum(-1)


def gat_logits_bwd_plain(xp, att_src, att_dst, d_xp_out, d_a_s, d_a_d):
    """Plain PyTorch version of :func:`gat_logits_bwd`: ``(d xp, d att_src,
    d att_dst)``, d xp including the passed-through rows' cotangent
    ``d_xp_out``."""
    d_xp = d_xp_out + d_a_s[..., None] * att_src + d_a_d[..., None] * att_dst
    return (d_xp, (d_a_s[..., None] * xp).sum(0, keepdim=True),
            (d_a_d[..., None] * xp).sum(0, keepdim=True))


def _check(fn: str, xp, att_src, att_dst, d_xp_out=None, d_a_s=None, d_a_d=None):
    """Raise on what the kernels do not take: ``xp`` (and ``d_xp_out``)
    [N, H, C], the att vectors [1, H, C], ``d_a_s`` and ``d_a_d`` [N, H];
    every operand contiguous f32 on ``xp``'s CUDA device."""
    if xp.dim() != 3:
        raise ValueError(f"{fn}: xp must be [N, H, C], got {tuple(xp.shape)}")
    N, H, C = xp.shape
    operands = {"xp": (xp, (N, H, C)), "att_src": (att_src, (1, H, C)),
                "att_dst": (att_dst, (1, H, C)), "d_xp_out": (d_xp_out, (N, H, C)),
                "d_a_s": (d_a_s, (N, H)), "d_a_d": (d_a_d, (N, H))}
    operands = {name: v for name, v in operands.items() if v[0] is not None}
    for name, (t, shape) in operands.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{fn}: {name} is {tuple(t.shape)}, expected {shape}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous f32")
    if xp.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {xp.device}")
    for name, (t, _) in operands.items():
        if t.device != xp.device:
            raise ValueError(f"{fn}: {name} is on {t.device}, xp on {xp.device}")


def _vec(C: int, *ts) -> int:
    """1 where every operand may be read in float4 loads, else 0."""
    return int(all(bops.vector_loads(t, C) for t in ts))


def gat_logits_fwd(xp: torch.Tensor, att_src: torch.Tensor, att_dst: torch.Tensor):
    """``(a_s, a_d)`` [N, H] f32 of ``xp`` [N, H, C] and ``att_src``,
    ``att_dst`` [1, H, C]. No autograd: see :class:`GatLogits`. On CUDA
    tensors it launches the kernel (or raises); on CPU tensors it runs
    :func:`gat_logits_plain`. ``gat_logits_fwd.launches`` counts kernel
    launches."""
    if bops.use_plain(xp):
        return gat_logits_plain(xp, att_src, att_dst)
    _check("gat_logits_fwd", xp, att_src, att_dst)
    N, H, C = xp.shape
    a_s = torch.empty((N, H), dtype=torch.float32, device=xp.device)
    a_d = torch.empty_like(a_s)
    fn = _build.load("gat_logits").gat_logits_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(xp.device):
        rc = fn(xp.data_ptr(), att_src.data_ptr(), att_dst.data_ptr(), a_s.data_ptr(),
                a_d.data_ptr(), N, H, C, _vec(C, xp, att_src, att_dst),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gat_logits_fwd: kernel launch failed with CUDA error {rc}")
    gat_logits_fwd.launches += 1
    return a_s, a_d


gat_logits_fwd.launches = 0


def gat_logits_bwd(xp, att_src, att_dst, d_xp_out, d_a_s, d_a_d):
    """``(d xp, d att_src, d att_dst)`` for the cotangents of
    :class:`GatLogits`' three outputs: ``d_xp_out`` [N, H, C] of the
    passed-through rows, ``d_a_s`` and ``d_a_d`` [N, H]. On CUDA tensors it
    launches the kernels (or raises); on CPU tensors it runs
    :func:`gat_logits_bwd_plain`. ``gat_logits_bwd.launches`` counts kernel
    launches (one per call: the pass over the rows and the fold of its
    partial sums are one launch of it)."""
    if bops.use_plain(xp):
        return gat_logits_bwd_plain(xp, att_src, att_dst, d_xp_out, d_a_s, d_a_d)
    d_xp_out, d_a_s, d_a_d = d_xp_out.contiguous(), d_a_s.contiguous(), d_a_d.contiguous()
    _check("gat_logits_bwd", xp, att_src, att_dst, d_xp_out, d_a_s, d_a_d)
    N, H, C = xp.shape
    vec = _vec(C, xp, d_xp_out, att_src, att_dst)
    lib = _build.load("gat_logits")
    lib.gat_logits_bwd_chunks.argtypes = [ctypes.c_int] * 4
    lib.gat_logits_bwd_chunks.restype = ctypes.c_int
    chunks = lib.gat_logits_bwd_chunks(N, H, C, vec)
    part = torch.empty((2, chunks, H * C), dtype=torch.float32, device=xp.device)
    d_xp = torch.empty_like(xp)
    d_att_src, d_att_dst = torch.empty_like(att_src), torch.empty_like(att_dst)
    fn = lib.gat_logits_bwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(xp.device):
        rc = fn(xp.data_ptr(), d_xp_out.data_ptr(), d_a_s.data_ptr(), d_a_d.data_ptr(),
                att_src.data_ptr(), att_dst.data_ptr(), d_xp.data_ptr(), part.data_ptr(),
                d_att_src.data_ptr(), d_att_dst.data_ptr(), N, H, C, vec,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gat_logits_bwd: kernel launch failed with CUDA error {rc}")
    gat_logits_bwd.launches += 1
    return d_xp, d_att_src, d_att_dst


gat_logits_bwd.launches = 0


class GatLogits(torch.autograd.Function):
    """``(xp, a_s, a_d)`` from ``(xp, att_src, att_dst)``: xp passed through,
    the halves through the kernel (CUDA tensors) or the plain version (CPU
    tensors). The backward forms d xp from all three cotangents in one pass.
    Saves xp and the att vectors."""

    @staticmethod
    def forward(ctx, xp, att_src, att_dst):
        ctx.save_for_backward(xp, att_src, att_dst)
        a_s, a_d = gat_logits_fwd(xp, att_src, att_dst)
        return xp, a_s, a_d

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_xp_out, d_a_s, d_a_d):
        xp, att_src, att_dst = ctx.saved_tensors
        return gat_logits_bwd(xp, att_src, att_dst, d_xp_out, d_a_s, d_a_d)


def gat_logits(xp: torch.Tensor, att_src: torch.Tensor, att_dst: torch.Tensor):
    """``(xp, a_s, a_d)``: through :class:`GatLogits` on CUDA tensors, xp
    passed through (hand the first output to whatever reads xp); on CPU
    tensors, or inside ``plain_versions()``, xp itself and
    :func:`gat_logits_plain` under autograd. The second route keeps the CPU's
    gradients bit for bit those of the layer's expression, which
    ``tests/test_torch_gat_logits.py::test_gatconv_on_the_cpu_is_unchanged``
    holds: through :class:`GatLogits` autograd sums d xp in another order, and
    GATConv's d x and d lin.weight move by about 1e-6."""
    if bops.use_plain(xp):
        return (xp, *gat_logits_plain(xp, att_src, att_dst))
    return GatLogits.apply(xp, att_src, att_dst)
