"""Banded GAT attention: the CUDA kernels, forward and backward, and their
plain versions. Four routes compute the same function; which one a graph
takes is ``BatchedGraph.band_attn`` (``ops.banded.band_attention_route``):

* :func:`band_attention` ("dma") replaces ``make_band_attention_dma`` (v2) in
  ``gnn_pressure_estimation_tpu/ops/pallas/band_attention.py``
  (``csrc/band_attention.cu``, ``csrc/band_attention_bwd.cu``). The forward
  walks the mask's row lists, every head of a row in one warp; the backward
  recomputes the softmax and takes its channel sums in one pass over the
  extended rows, every head of one in one warp.
* :func:`band_attention_flash` ("flash") replaces ``make_band_attention_flash``
  (v4) (``csrc/band_attention_flash.cu``, ``csrc/band_attention_flash_bwd.cu``):
  a streaming softmax whose per-row state does not grow with W. The forward
  is v2's row walk (``csrc/band_rowwalk.cuh``, shared by three forwards) and
  also returns the row statistics m and Z; the backward takes them and
  ``delta = Σ_c dO∘O``, builds each weight on its own, and runs v2's column
  walk over the extended rows (``csrc/band_colwalk.cuh``, shared by both
  backwards).
* :func:`band_attention_window` ("window") replaces ``make_band_attention``
  (v1) (``csrc/band_attention_window.cu``, ``csrc/band_attention_window_bwd.cu``):
  it reads the materialised window tensors ``x_win`` / ``a_src_win``, never an
  extended array, and its backward leaves ``d a_src_win`` and ``d x_win`` in
  window layout for autograd to fold. The forward is v2's row walk reading
  ``x_win[blk, b, j]`` where v2 reads ``x_ext[b, blk·BLK + j]``; the backward
  is v2's with the column walk in window layout: one run of entries, one
  ``x_win`` row and one ``d x_win`` row per covering block.
* :func:`band_attention_acc` ("acc") replaces ``make_band_attention_acc`` (v3):
  v2's forward kernel, and v2's backward passes under their own entry point
  (``csrc/band_attention_acc_bwd.cu``): the column walk's owner warp sums each
  extended row's ``d x_ext`` whole and writes it once, the GPU's form of v3's
  sliding accumulator: no windowed ``d x`` tensor, no fold pass, no atomics.

v2's, v3's and v1's backwards share their passes (``csrc/band_bwd.cuh``), and
so does the dense softmax backward (``ops/graph_attention.py``), a band of one
block.

Each computes, per destination row, graph and head, the LeakyReLU(0.2)
additive logits over the row's W-wide window, the adjacency mask, a softmax
over the window, and the weighted sum of the window's rows. Each entry point
is a ``torch.autograd.Function``; the mask gets no gradient. A row with no
set column (a padded band row) gets the uniform mean of its W window rows on
every route, as ``ops.banded.band_attention`` gives it.

``mxu_bf16=True`` (the "dma", "flash" and "acc" routes; GATRes's
``attn_dtype=bfloat16``) selects each kernel's bf16-operand instance, the
TPU kernels' ``mxu_bf16``: the operands of the two products are rounded to
bfloat16 (round to nearest even) and the products summed in f32. v2 and v3
round the normalised weight p = exp(z − m)/Z and the x rows in the forward,
p, dO and x in the backward's d x = pᵀ·dO and dp = dO·xᵀ (delta and dz take
the f32 p); v4 rounds the numerator exp(z − m) and the x rows in the
forward and divides by Z, the sum of the unrounded numerators, and rounds
as v2 in the backward. Z of the bf16 instances is summed in double and
rounded once, in the kernels and the plain versions alike, so the weight
that is rounded is the same float whatever the order of the sum. The
extended rows are stored in bfloat16 under ``mxu_bf16``: the autograd
Functions, given the projected rows and their halo widths (``halo=(U, R)``,
the model's path), write x_ext once as bf16
(:func:`~..ops.banded.extend_rows_bf16`) and save it so; the forward and
backward kernels read those 2-byte rows, and each x is rounded once, as the
TPU kernels' cast rounds it. Forward and backward wrappers round f32 rows
they are handed under ``mxu_bf16`` once themselves, and refuse bf16 rows
without it. The backwards take ``d_out`` in f32 and return f32 gradients.
Rows with no set column get the window mean of the rows the forward reads:
bf16 rows, summed in f32, under ``mxu_bf16``. Every wrapper counts the
launches of its f32 instance in ``launches`` and of its bf16 instance in
``launches_bf16``; on a CPU tensor it runs the plain version with the same
flag.

Bound on an H100 SXM at the bigtown GATRes-large shapes (B 32, n_pad 5,888,
W 896, H·C 256): counted over the mask's nonzeros (0.51% dense) the forward
is memory-bound — x_ext (214 MB) read once and out (193 MB) written once,
≈0.12 ms at 3.35 TB/s; counted over the dense window it is 86 GFLOP, ≈1.3 ms
at 67 TFLOP/s f32. The v2 forward kernel walks the row lists of a
:class:`~..ops.banded.BandIndex` of the mask, so its work follows the
nonzeros and its floor is the byte bound. The backward reads x_ext and dO
and writes d x_ext (≈0.19 ms at those shapes; ≈0.16 ms with x_ext in bf16
under ``mxu_bf16``); it recomputes the softmax, as
v2 does, and walks the same index (row lists, then the same entries grouped
by the extended row they read), so the overlapping windows fold without
atomics and a run repeats to the bit. The flash and window
kernels walk the same index in both directions; the window route's bound is
the dense ``[nB, B, W, H, C]`` tensors it must read and write.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from gnn_pressure_estimation_tpu_torch.ops import _build
from gnn_pressure_estimation_tpu_torch.ops import banded as bops


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to the nearest bfloat16 (ties to even), kept in its dtype:
    the JAX package's ``astype(bfloat16)`` of an operand. Autograd rounds the
    cotangent the same way."""
    return t.to(torch.bfloat16).to(t.dtype)


def _bf16_weights(z, on):
    """The softmax of the bf16 instances over the window (dim 3) of the
    masked logits ``z`` (``on``: the mask, as :func:`_logits` gives both):
    ``(e = exp(z − m), Z, real)`` with m the row maximum, Z the sum of e
    taken in double and rounded once (so the weight rounded from it does not
    depend on the order of the sum) and ``real`` the rows with a set
    column."""
    e = torch.exp(z - z.amax(dim=3, keepdim=True))
    Z = e.sum(dim=3, keepdim=True, dtype=torch.float64).to(z.dtype)
    return e, Z, on.any(dim=3, keepdim=True)


def _bf16_product(eq: str, w: torch.Tensor, v: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    """``einsum(eq, w, v)`` with both operands rounded to bf16 on the rows
    with a set column (``real``); the others take w in f32 (the window mean
    of a padded row: of the bf16 rows in the forwards, whose v is rounded
    already)."""
    out = torch.einsum(eq, torch.where(real, round_bf16(w), 0.0), round_bf16(v))
    if not bool(real.all()):
        out = out + torch.einsum(eq, torch.where(real, 0.0, w), v)
    return out


def _stored(fn: str, x_ext: torch.Tensor, mxu_bf16: bool) -> torch.Tensor:
    """The extended rows as a kernel, forward or backward, reads them: f32,
    or under ``mxu_bf16`` bf16 (f32 rows rounded once here; the model's path
    hands bf16 rows). bf16 rows without ``mxu_bf16`` raise: the f32
    instances read f32."""
    if x_ext.dtype == torch.bfloat16 and not mxu_bf16:
        raise ValueError(f"{fn}: x_ext in bfloat16 is read only by the bf16-operand instance "
                         "(mxu_bf16=True)")
    return x_ext.to(torch.bfloat16) if mxu_bf16 else x_ext


def _widened(x_ext: torch.Tensor) -> torch.Tensor:
    """bf16 rows as f32 (exact), for the plain versions; rows of another
    dtype as they are."""
    return x_ext.float() if x_ext.dtype == torch.bfloat16 else x_ext


def band_attention_plain(
    a_dst: torch.Tensor,      # [B, n_pad, H]
    a_src_win: torch.Tensor,  # [nB, B, W, H]
    x_ext: torch.Tensor,      # [B, n_ext, H, C]
    adj_mask: torch.Tensor,   # [nB, BLK, W] bool or 0/1 int8
    negative_slope: float = 0.2,
    mxu_bf16: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`band_attention_fwd`; ``mxu_bf16``:
    ``out = Σ bf16(p)·x`` with p the normalised weight and x the bf16 rows
    (f32 rows rounded once), computed in f32."""
    x_ext = _widened(_stored("band_attention_plain", x_ext, mxu_bf16))
    nB, BLK, W = adj_mask.shape
    x_win = bops.band_windows_ext(x_ext, nB, BLK, W)      # [nB, B, W, H, C]
    if not mxu_bf16:
        return bops.band_attention(a_dst, a_src_win, x_win, adj_mask, negative_slope)
    z, _, on = _logits(a_dst, a_src_win, adj_mask, negative_slope)
    e, Z, real = _bf16_weights(z, on)
    out = _bf16_product("nbiwh,nbwhc->nbihc", e / Z, x_win, real)
    return _rows_of(out, x_ext.shape[0], nB, BLK)


def band_attention_bwd_plain(
    a_dst: torch.Tensor, a_src_win: torch.Tensor, x_ext: torch.Tensor,
    adj_mask: torch.Tensor, d_out: torch.Tensor, negative_slope: float = 0.2,
    mxu_bf16: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`band_attention_bwd`: the explicit
    formulas on the dense windows, window fold included.

    ``d_out`` [B, n_pad, H, C] → ``(d a_dst [B, n_pad, H], d a_src_win
    [nB, B, W, H], d x_ext [B, n_ext, H, C])``. A row with no set column has
    a uniform softmax: it adds ``d_out/W`` to its W window rows of ``d x_ext``
    and nothing to the ``d a``'s (the mask zeroes the logits' gradient).
    ``mxu_bf16``: d x from bf16(p)ᵀ·bf16(dO), dp from bf16(dO)·bf16(x)ᵀ,
    delta and dz from the f32 p; x the bf16 rows (f32 rows rounded once)."""
    x_ext = _widened(_stored("band_attention_bwd_plain", x_ext, mxu_bf16))
    nB, BLK, W = adj_mask.shape
    x_win = bops.band_windows_ext(x_ext, nB, BLK, W)
    if mxu_bf16:
        z, zpre, on = _logits(a_dst, a_src_win, adj_mask, negative_slope)
        e, Z, real = _bf16_weights(z, on)
        d_a_dst, d_a_src_win, d_xw = _bf16_window_bwd(e / Z, zpre, on, real, x_win, d_out, None,
                                                      negative_slope)
    else:
        d_a_dst, d_a_src_win, d_xw = band_attention_window_bwd_plain(
            a_dst, a_src_win, x_win, adj_mask, d_out, negative_slope)
    return d_a_dst, d_a_src_win, bops.fold_windows_ext(d_xw, BLK)


def _bf16_window_bwd(p, zpre, on, real, x_win, d_out, delta, negative_slope):
    """The bf16 instances' backward on the dense windows, from the f32
    weights p [nB,B,BLK,W,H]: dp = bf16(dO)·bf16(x)ᵀ, d x_win =
    bf16(p)ᵀ·bf16(dO) (f32 on rows with no set column), dz = p (dp − delta)
    with delta = Σ p dp, or the given [B, n_pad, H] (v4). Returns ``(d a_dst,
    d a_src_win, d x_win)``, the last in window layout."""
    nB, B, BLK = p.shape[:3]
    do_b = _blocks_of(d_out, nB, BLK)                                  # [nB,B,BLK,H,C]
    dp = torch.einsum("nbihc,nbwhc->nbiwh", round_bf16(do_b), round_bf16(x_win))
    delta = (p * dp).sum(dim=3, keepdim=True) if delta is None \
        else _blocks_of(delta, nB, BLK)[:, :, :, None, :]
    dz = p * (dp - delta)
    dz = torch.where(zpre >= 0, dz, negative_slope * dz) * on
    return (_rows_of(dz.sum(dim=3), B, nB, BLK), dz.sum(dim=2),
            _bf16_product("nbiwh,nbihc->nbwhc", p, do_b, real))


def _check(fn: str, a_dst, a_src_win, x, adj_mask, x_dtype=torch.float32):
    """Raise on what the kernels do not take; returns the int8 mask. ``x`` is
    the extended array [B, n_ext, H, C] (``x_dtype``: bf16 for the
    bf16-operand forwards) or, for the window kernels, the materialised
    windows [nB, B, W, H, C]."""
    for name, t, dt in (("a_dst", a_dst, torch.float32), ("a_src_win", a_src_win, torch.float32),
                        ("x", x, x_dtype)):
        if t.dtype != dt or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{fn}: {name} must be contiguous {dt} on {x.device}")
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
    index: Optional[bops.BandIndex] = None,
    mxu_bf16: bool = False,
) -> torch.Tensor:
    """a_dst [B, n_pad, H] · a_src_win [nB, B, W, H] · x_ext [B, n_ext, H, C]
    (n_ext = n_pad + W − BLK) · adj_mask [nB, BLK, W] (bool or int8)
    → [B, n_pad, H, C], all f32 (``mxu_bf16``: x_ext bf16, or f32 rounded
    once here). No autograd: see :func:`band_attention`.

    On CUDA tensors it launches the kernel (or raises); on CPU tensors it
    runs :func:`band_attention_plain`. ``index``: the mask's
    :class:`BandIndex` on the same device (the template's cached one on the
    model's path), else built from the mask's values on the host. The kernel
    walks its row lists and never reads the mask, so an index built from
    another mask of the same shape gives that mask's attention on the card;
    only its shape and device are checked. ``band_attention_fwd.launches``
    counts kernel launches (one per call: the padded rows' window-mean
    pre-pass and the row pass are one launch of it); ``mxu_bf16`` launches
    the bf16-operand instance, which gathers bf16 rows, counted in
    ``launches_bf16``."""
    name = "band_attention_fwd"
    x_ext = _stored(name, x_ext, mxu_bf16)
    if bops.use_plain(x_ext):
        return band_attention_plain(a_dst, a_src_win, x_ext, adj_mask, negative_slope, mxu_bf16)
    adj_mask = _check(name, a_dst, a_src_win, x_ext, adj_mask,
                      torch.bfloat16 if mxu_bf16 else torch.float32)
    nB, BLK, W = adj_mask.shape
    B, _, H, C = x_ext.shape
    dev = x_ext.device
    ix = bops.index_for(name, adj_mask, index, dev)
    n_empty = int(ix.empty_row.shape[0])
    out = torch.empty((B, nB * BLK, H, C), dtype=torch.float32, device=dev)
    mean = torch.empty((B, nB, H * C) if n_empty else (1,), dtype=torch.float32, device=dev)
    fn = _build.load("band_attention").band_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(a_dst.data_ptr(), a_src_win.data_ptr(), x_ext.data_ptr(), ix.row_ptr.data_ptr(),
                ix.col.data_ptr(), ix.empty_ptr.data_ptr(), mean.data_ptr(), out.data_ptr(),
                B, nB, BLK, W, H, C, n_empty, int(bops.vector_loads(x_ext, C)), int(mxu_bf16),
                float(negative_slope), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
    _count(band_attention_fwd, mxu_bf16)
    return out


def _count(wrapper, mxu_bf16: bool) -> None:
    """One launch of ``wrapper``'s f32 or bf16-operand instance."""
    if mxu_bf16:
        wrapper.launches_bf16 += 1
    else:
        wrapper.launches += 1


band_attention_fwd.launches = band_attention_fwd.launches_bf16 = 0


def _recompute_bwd(name, a_dst, a_src_win, x, adj_mask, d_out, negative_slope, index,
                   mxu_bf16=None):
    """Launch ``csrc/<name>.cu``, one of the three backwards that recompute
    the softmax by the passes of ``csrc/band_bwd.cuh`` (v2's; v3's, the same;
    v1's, whose columns pass reads and writes window layout). ``x`` is x_ext
    [B, n_ext, H, C], or x_win [nB, B, W, H, C] for the window kernel, and the
    third cotangent has its shape, in f32. p, dp and dz pass between the
    passes as ``[B, nnz, H]`` scratch. ``mxu_bf16``: the bf16-operand
    instance, x_ext in bf16, or not, for the entries that have one (None: the
    window kernel, which has none). Returns ``(d a_dst, d a_src_win, d x)``."""
    adj_mask = _check(name, a_dst, a_src_win, x, adj_mask,
                      torch.bfloat16 if mxu_bf16 else torch.float32)
    nB, BLK, W = adj_mask.shape
    B, _, H = a_dst.shape
    C = x.shape[-1]
    dev = x.device
    (d_out,) = _check_rows(name, x, d_out=(d_out, (B, nB * BLK, H, C)))
    ix = bops.index_for(name, adj_mask, index, dev)
    nnz, n_empty = ix.nnz, int(ix.empty_row.shape[0])
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)  # noqa: E731
    d_a_dst, d_a_src_win, d_x = new(B, nB * BLK, H), new(nB, B, W, H), new(*x.shape)
    sp, sdz = new(B, max(nnz, 1), H), new(B, max(nnz, 1), H)
    ss = new(B, nB, H, C) if n_empty else new(1)
    vec = bops.vector_loads(x, C) and bops.vector_loads(d_out, C)
    flag = () if mxu_bf16 is None else (int(mxu_bf16),)
    fn = getattr(_build.load(name), name)
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * (9 + len(flag)) \
        + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(a_dst.data_ptr(), a_src_win.data_ptr(), x.data_ptr(), d_out.data_ptr(),
                ix.row_ptr.data_ptr(), ix.col.data_ptr(), ix.t_ptr.data_ptr(),
                ix.t_entry.data_ptr(), ix.t_row.data_ptr(), ix.empty_ptr.data_ptr(),
                ix.empty_row.data_ptr(), sp.data_ptr(), sdz.data_ptr(), ss.data_ptr(),
                d_a_dst.data_ptr(), d_a_src_win.data_ptr(), d_x.data_ptr(),
                B, nB, BLK, W, H, C, nnz, n_empty, int(vec), *flag, float(negative_slope),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
    return d_a_dst, d_a_src_win, d_x


def band_attention_bwd(
    a_dst: torch.Tensor,
    a_src_win: torch.Tensor,
    x_ext: torch.Tensor,
    adj_mask: torch.Tensor,
    d_out: torch.Tensor,
    negative_slope: float = 0.2,
    index: Optional[bops.BandIndex] = None,
    mxu_bf16: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The cotangents ``(d a_dst, d a_src_win, d x_ext)`` of
    :func:`band_attention_fwd` for the output cotangent ``d_out``
    [B, n_pad, H, C], window fold included.

    ``index`` is the mask's :class:`BandIndex` on the same device (the
    template's cached one on the model's path); without it the index is
    built from the mask's values. On CUDA tensors it launches the kernel (or
    raises); on CPU tensors it runs :func:`band_attention_bwd_plain`. The
    kernel's passes (``csrc/band_bwd.cuh``): p per entry from the row lists;
    d x_ext and dp per entry from the extended rows, every head of one in one
    warp; dz and d a_dst per row; d a_src_win per extended row. p, dp and dz
    pass between them as ``[B, nnz, H]`` scratch.
    ``band_attention_bwd.launches`` counts kernel launches (one per call: the
    four launches of ``csrc/band_attention_bwd.cu`` are one launch of it);
    ``mxu_bf16`` launches the bf16-operand instance, which reads x_ext in
    bf16 (f32 rows are rounded once here), counted in ``launches_bf16``."""
    x_ext = _stored("band_attention_bwd", x_ext, mxu_bf16)
    if bops.use_plain(x_ext):
        return band_attention_bwd_plain(a_dst, a_src_win, x_ext, adj_mask, d_out, negative_slope,
                                        mxu_bf16)
    out = _recompute_bwd("band_attention_bwd", a_dst, a_src_win, x_ext, adj_mask, d_out,
                         negative_slope, index, mxu_bf16)
    _count(band_attention_bwd, mxu_bf16)
    return out


band_attention_bwd.launches = band_attention_bwd.launches_bf16 = 0


def _extended(x: torch.Tensor, halo, mxu_bf16: bool) -> torch.Tensor:
    """The extended rows a band Function saves and its forward reads: with
    ``halo=(U, R)`` the extension of the projected rows ``x`` [B, n_pad, H,
    C], in bf16 under ``mxu_bf16`` (each row rounded once); with ``halo=None``
    ``x`` itself (the forward wrapper rounds f32 rows)."""
    if halo is None:
        return x
    return (bops.extend_rows_bf16 if mxu_bf16 else bops.extend_rows)(x, *halo)


def _rows_grad(d_x_ext: torch.Tensor, halo) -> torch.Tensor:
    """The gradient of a band Function's x input from the f32 ``d x_ext``:
    itself, or with ``halo=(U, R)`` its rows ``[U, U + n_pad)``, the
    projected rows' (what the backward of ``torch.cat`` in
    :func:`~..ops.banded.extend_rows` gives)."""
    if halo is None:
        return d_x_ext
    U, R = halo
    return d_x_ext[:, U:d_x_ext.shape[1] - R]


class BandAttention(torch.autograd.Function):
    """The v2 forward kernel and the backward ``bwd`` names
    (:func:`band_attention_bwd`, or :func:`band_attention_acc_bwd` for the
    "acc" route) on CUDA tensors, or their plain versions on CPU tensors;
    the bf16-operand instances of both with ``mxu_bf16``. ``halo``: x is
    the projected rows, extended here (see :func:`_extended`). Saves its
    inputs and the extended rows (with ``halo``, bf16 under ``mxu_bf16``),
    which the backward reads as they are: it recomputes the softmax."""

    @staticmethod
    def forward(ctx, a_dst, a_src_win, x, adj_mask, negative_slope, index, bwd, mxu_bf16, halo):
        x_ext = _extended(x, halo, mxu_bf16)
        ctx.save_for_backward(a_dst, a_src_win, x_ext, adj_mask)
        ctx.negative_slope, ctx.index, ctx.bwd, ctx.mxu_bf16 = negative_slope, index, bwd, mxu_bf16
        ctx.halo = halo
        return band_attention_fwd(a_dst, a_src_win, x_ext, adj_mask, negative_slope, index,
                                  mxu_bf16)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_out):
        a_dst, a_src_win, x_ext, adj_mask = ctx.saved_tensors
        d_a_dst, d_a_src_win, d_x_ext = ctx.bwd(
            a_dst, a_src_win, x_ext, adj_mask, d_out, ctx.negative_slope, ctx.index, ctx.mxu_bf16)
        return (d_a_dst, d_a_src_win, _rows_grad(d_x_ext, ctx.halo), None, None, None, None, None,
                None)


def band_attention(
    a_dst: torch.Tensor,
    a_src_win: torch.Tensor,
    x_ext: torch.Tensor,
    adj_mask: torch.Tensor,
    negative_slope: float = 0.2,
    index: Optional[bops.BandIndex] = None,
    mxu_bf16: bool = False,
    halo: Optional[tuple[int, int]] = None,
) -> torch.Tensor:
    """Differentiable banded attention, shapes as :func:`band_attention_fwd`.
    Gradients flow to ``a_dst``, ``a_src_win`` and ``x_ext``; the mask is a
    constant of the graph. ``index``: see :func:`band_attention_bwd`;
    ``mxu_bf16``: the bf16-operand instances, forward and backward, over
    bf16 rows. ``halo=(U, R)``, as the model's layer passes it: ``x_ext``
    is instead the projected rows [B, n_pad, H, C], f32, whose extended
    array the Function writes itself (in bf16 under ``mxu_bf16``, so no f32
    x_ext is built); their gradient is f32. ``halo=None`` takes a ready
    extended array, as the kernel-level checks hand it."""
    return BandAttention.apply(a_dst, a_src_win, x_ext, adj_mask, negative_slope, index,
                               band_attention_bwd, mxu_bf16, halo)


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
    adj_mask: torch.Tensor, negative_slope: float = 0.2, mxu_bf16: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`band_attention_flash_fwd`:
    ``(out [B, n_pad, H, C], m [B, n_pad, H], Z [B, n_pad, H])`` with m the
    row maximum of the masked logits and Z the sum of ``exp(z − m)``; a row
    with no set column has m = −1e9 and Z = W. ``mxu_bf16``: ``out =
    Σ bf16(exp(z − m))·x / Z``, Z the sum of the unrounded numerators
    (m is the row maximum: the TPU kernel's running maximum wherever the
    window fits its one forward chunk, as every layout the port runs
    does); x the bf16 rows (f32 rows rounded once), computed in f32."""
    x_ext = _widened(_stored("band_attention_flash_plain", x_ext, mxu_bf16))
    nB, BLK, W = adj_mask.shape
    B = x_ext.shape[0]
    z, _, on = _logits(a_dst, a_src_win, adj_mask, negative_slope)
    x_win = bops.band_windows_ext(x_ext, nB, BLK, W)
    if mxu_bf16:
        m = z.amax(dim=3, keepdim=True)
        e, Z, real = _bf16_weights(z, on)
        out = _bf16_product("nbiwh,nbwhc->nbihc", e, x_win, real) / Z[:, :, :, 0, :, None]
    else:
        m, Z = _row_stats(z)
        out = torch.einsum("nbiwh,nbwhc->nbihc", torch.exp(z - m) / Z, x_win)
    return (_rows_of(out, B, nB, BLK), _rows_of(m[:, :, :, 0], B, nB, BLK),
            _rows_of(Z[:, :, :, 0], B, nB, BLK))


def band_attention_flash_bwd_plain(
    a_dst: torch.Tensor, a_src_win: torch.Tensor, x_ext: torch.Tensor,
    adj_mask: torch.Tensor, m: torch.Tensor, Z: torch.Tensor, delta: torch.Tensor,
    d_out: torch.Tensor, negative_slope: float = 0.2, mxu_bf16: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`band_attention_flash_bwd`: the weights
    rebuilt from the saved ``m``, ``Z`` as ``exp(z − m)/Z``, the softmax VJP's
    row term taken from ``delta`` ([B, n_pad, H]), window fold included.
    ``mxu_bf16``: d x from bf16(p)ᵀ·bf16(dO), dp from bf16(dO)·bf16(x)ᵀ, x
    the bf16 rows (f32 rows rounded once)."""
    x_ext = _widened(_stored("band_attention_flash_bwd_plain", x_ext, mxu_bf16))
    nB, BLK, W = adj_mask.shape
    B = x_ext.shape[0]
    z, zpre, on = _logits(a_dst, a_src_win, adj_mask, negative_slope)
    p = torch.exp(z - _blocks_of(m, nB, BLK)[:, :, :, None, :]) \
        / _blocks_of(Z, nB, BLK)[:, :, :, None, :]
    x_win = bops.band_windows_ext(x_ext, nB, BLK, W)
    if mxu_bf16:
        d_a_dst, d_a_src_win, dxw = _bf16_window_bwd(p, zpre, on, on.any(dim=3, keepdim=True),
                                                     x_win, d_out, delta, negative_slope)
        return d_a_dst, d_a_src_win, bops.fold_windows_ext(dxw, BLK)
    do_b = _blocks_of(d_out, nB, BLK)                                 # [nB,B,BLK,H,C]
    dp = torch.einsum("nbihc,nbwhc->nbiwh", do_b, x_win)
    dz = p * (dp - _blocks_of(delta, nB, BLK)[:, :, :, None, :])
    dz = torch.where(zpre >= 0, dz, negative_slope * dz) * on
    dxw = torch.einsum("nbiwh,nbihc->nbwhc", p, do_b)
    return _rows_of(dz.sum(dim=3), B, nB, BLK), dz.sum(dim=2), bops.fold_windows_ext(dxw, BLK)


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
    index: Optional[bops.BandIndex] = None, mxu_bf16: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shapes as :func:`band_attention_fwd`; returns ``(out, m, Z)``, the row
    statistics [B, n_pad, H] that :func:`band_attention_flash_bwd` takes. No
    autograd: see :func:`band_attention_flash`.

    On CUDA tensors it launches the kernel (or raises); on CPU tensors it
    runs :func:`band_attention_flash_plain`. ``index``: the mask's
    :class:`BandIndex` on the same device (the template's cached one on the
    model's path), else built from the mask's values. The kernel is v2's row
    walk (``csrc/band_rowwalk.cuh``) writing m and Z beside out.
    ``band_attention_flash_fwd.launches`` counts kernel launches (one per
    call: the window-mean pre-pass and the row pass are one launch of it);
    ``mxu_bf16`` launches the bf16-operand instance, which gathers bf16
    rows (f32 ones are rounded once here), counted in ``launches_bf16``."""
    name = "band_attention_flash_fwd"
    x_ext = _stored(name, x_ext, mxu_bf16)
    if bops.use_plain(x_ext):
        return band_attention_flash_plain(a_dst, a_src_win, x_ext, adj_mask, negative_slope,
                                          mxu_bf16)
    adj_mask = _check(name, a_dst, a_src_win, x_ext, adj_mask,
                      torch.bfloat16 if mxu_bf16 else torch.float32)
    nB, BLK, W = adj_mask.shape
    B, _, H, C = x_ext.shape
    dev = x_ext.device
    ix = bops.index_for(name, adj_mask, index, dev)
    n_empty = int(ix.empty_row.shape[0])
    out = torch.empty((B, nB * BLK, H, C), dtype=torch.float32, device=dev)
    m, Z = (torch.empty((B, nB * BLK, H), dtype=torch.float32, device=dev) for _ in range(2))
    mean = torch.empty((B, nB, H * C) if n_empty else (1,), dtype=torch.float32, device=dev)
    fn = _build.load("band_attention_flash").band_attention_flash_fwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(a_dst.data_ptr(), a_src_win.data_ptr(), x_ext.data_ptr(),
                ix.row_ptr.data_ptr(), ix.col.data_ptr(), ix.empty_ptr.data_ptr(),
                mean.data_ptr(), out.data_ptr(), m.data_ptr(), Z.data_ptr(),
                B, nB, BLK, W, H, C, n_empty, int(bops.vector_loads(x_ext, C)), int(mxu_bf16),
                float(negative_slope), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"band_attention_flash_fwd: kernel launch failed with CUDA error {rc}")
    _count(band_attention_flash_fwd, mxu_bf16)
    return out, m, Z


band_attention_flash_fwd.launches = band_attention_flash_fwd.launches_bf16 = 0


def band_attention_flash_bwd(
    a_dst: torch.Tensor, a_src_win: torch.Tensor, x_ext: torch.Tensor,
    adj_mask: torch.Tensor, m: torch.Tensor, Z: torch.Tensor, delta: torch.Tensor,
    d_out: torch.Tensor, negative_slope: float = 0.2,
    index: Optional[bops.BandIndex] = None, mxu_bf16: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The cotangents ``(d a_dst, d a_src_win, d x_ext)`` of
    :func:`band_attention_flash_fwd` from its saved ``m``, ``Z``, the row term
    ``delta = Σ_c d_out∘out`` [B, n_pad, H] and ``d_out`` [B, n_pad, H, C],
    window fold included.

    On CUDA tensors it launches the kernel (or raises); on CPU tensors it
    runs :func:`band_attention_flash_bwd_plain`. The kernel is v2's backward
    with the weights given: p per entry from m and Z; d x_ext and dp per entry
    from the extended rows, every head of one in one warp (the column walk of
    ``csrc/band_colwalk.cuh``); dz and d a_dst per row; d a_src_win per
    extended row. p, dp and dz pass between them as ``[B, nnz, H]`` scratch.
    ``band_attention_flash_bwd.launches`` counts kernel launches (one per
    call: the passes of ``csrc/band_attention_flash_bwd.cu`` are one launch
    of it); ``mxu_bf16`` launches the bf16-operand instance, which reads
    x_ext in bf16 (f32 rows are rounded once here), counted in
    ``launches_bf16``."""
    name = "band_attention_flash_bwd"
    x_ext = _stored(name, x_ext, mxu_bf16)
    if bops.use_plain(x_ext):
        return band_attention_flash_bwd_plain(a_dst, a_src_win, x_ext, adj_mask, m, Z, delta,
                                              d_out, negative_slope, mxu_bf16)
    adj_mask = _check(name, a_dst, a_src_win, x_ext, adj_mask,
                      torch.bfloat16 if mxu_bf16 else torch.float32)
    nB, BLK, W = adj_mask.shape
    B, n_ext, H, C = x_ext.shape
    dev = x_ext.device
    rows = (B, nB * BLK, H)
    m, Z, delta, d_out = _check_rows(name, x_ext, m=(m, rows), Z=(Z, rows), delta=(delta, rows),
                                     d_out=(d_out, rows + (C,)))
    ix = bops.index_for(name, adj_mask, index, dev)
    nnz, n_empty = ix.nnz, int(ix.empty_row.shape[0])
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)  # noqa: E731
    d_a_dst, d_a_src_win, d_x_ext = new(*rows), new(nB, B, W, H), new(B, n_ext, H, C)
    sp, sdz = new(B, max(nnz, 1), H), new(B, max(nnz, 1), H)
    ss = new(B, nB, H, C) if n_empty else new(1)
    vec = bops.vector_loads(x_ext, C) and bops.vector_loads(d_out, C)
    fn = _build.load(name).band_attention_flash_bwd
    fn.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(a_dst.data_ptr(), a_src_win.data_ptr(), x_ext.data_ptr(), m.data_ptr(),
                Z.data_ptr(), delta.data_ptr(), d_out.data_ptr(), ix.row_ptr.data_ptr(),
                ix.col.data_ptr(), ix.t_ptr.data_ptr(), ix.t_entry.data_ptr(),
                ix.t_row.data_ptr(), ix.empty_ptr.data_ptr(), ix.empty_row.data_ptr(),
                sp.data_ptr(), sdz.data_ptr(), ss.data_ptr(),
                d_a_dst.data_ptr(), d_a_src_win.data_ptr(), d_x_ext.data_ptr(),
                B, nB, BLK, W, H, C, nnz, n_empty, int(vec), int(mxu_bf16), float(negative_slope),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
    _count(band_attention_flash_bwd, mxu_bf16)
    return d_a_dst, d_a_src_win, d_x_ext


band_attention_flash_bwd.launches = band_attention_flash_bwd.launches_bf16 = 0


class BandAttentionFlash(torch.autograd.Function):
    """Forward and backward through the streaming-softmax kernels (CUDA
    tensors) or their plain versions (CPU tensors). Saves its inputs, its
    output and the row statistics m, Z; the backward takes no row maximum or
    sum again. ``mxu_bf16``: the bf16-operand instances, forward and
    backward (delta from the bf16 forward's out and the f32 d_out, as the
    TPU wrapper takes it), the extended rows saved in bf16 and read so by
    both. ``halo`` as for :class:`BandAttention`."""

    @staticmethod
    def forward(ctx, a_dst, a_src_win, x, adj_mask, negative_slope, index, mxu_bf16, halo):
        x_ext = _extended(x, halo, mxu_bf16)
        out, m, Z = band_attention_flash_fwd(a_dst, a_src_win, x_ext, adj_mask, negative_slope,
                                             index, mxu_bf16)
        ctx.save_for_backward(a_dst, a_src_win, x_ext, adj_mask, m, Z, out)
        ctx.negative_slope, ctx.index, ctx.mxu_bf16, ctx.halo = negative_slope, index, mxu_bf16, halo
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_out):
        a_dst, a_src_win, x_ext, adj_mask, m, Z, out = ctx.saved_tensors
        delta = (d_out * out).sum(dim=-1)                 # [B, n_pad, H]
        d_a_dst, d_a_src_win, d_x_ext = band_attention_flash_bwd(
            a_dst, a_src_win, x_ext, adj_mask, m, Z, delta, d_out, ctx.negative_slope, ctx.index,
            ctx.mxu_bf16)
        return d_a_dst, d_a_src_win, _rows_grad(d_x_ext, ctx.halo), None, None, None, None, None


def band_attention_flash(
    a_dst: torch.Tensor, a_src_win: torch.Tensor, x_ext: torch.Tensor,
    adj_mask: torch.Tensor, negative_slope: float = 0.2,
    index: Optional[bops.BandIndex] = None, mxu_bf16: bool = False,
    halo: Optional[tuple[int, int]] = None,
) -> torch.Tensor:
    """Differentiable banded attention through the streaming-softmax route,
    shapes and gradients as :func:`band_attention`; ``mxu_bf16``: the
    bf16-operand instances; ``halo`` as for :func:`band_attention`."""
    return BandAttentionFlash.apply(a_dst, a_src_win, x_ext, adj_mask, negative_slope, index,
                                    mxu_bf16, halo)


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
    :func:`band_attention_flash_fwd`. The kernel is v2's row walk
    (``csrc/band_rowwalk.cuh``) reading x in window layout: on an ``x_win``
    cut from x_ext its output equals :func:`band_attention_fwd`'s bit for
    bit. ``band_attention_window_fwd.launches`` counts kernel launches (one
    per call: the window-mean pre-pass and the row pass are one launch of
    it)."""
    if bops.use_plain(x_win):
        return band_attention_window_plain(a_dst, a_src_win, x_win, adj_mask, negative_slope)
    name = "band_attention_window_fwd"
    adj_mask = _check(name, a_dst, a_src_win, x_win, adj_mask)
    nB, BLK, W = adj_mask.shape
    _, B, _, H, C = x_win.shape
    dev = x_win.device
    ix = bops.index_for(name, adj_mask, index, dev)
    n_empty = int(ix.empty_row.shape[0])
    out = torch.empty((B, nB * BLK, H, C), dtype=torch.float32, device=dev)
    mean = torch.empty((B, nB, H * C) if n_empty else (1,), dtype=torch.float32, device=dev)
    fn = _build.load("band_attention_window").band_attention_window_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(a_dst.data_ptr(), a_src_win.data_ptr(), x_win.data_ptr(), ix.row_ptr.data_ptr(),
                ix.col.data_ptr(), ix.empty_ptr.data_ptr(), mean.data_ptr(), out.data_ptr(),
                B, nB, BLK, W, H, C, n_empty, int(bops.vector_loads(x_win, C)),
                float(negative_slope), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
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
    runs :func:`band_attention_window_bwd_plain`. ``index`` as for
    :func:`band_attention_bwd`. The kernel runs v2's passes with the columns
    pass in window layout; its ``d a_dst`` and ``d a_src_win`` equal
    :func:`band_attention_bwd`'s bit for bit when ``x_win`` is cut from that
    x_ext. ``band_attention_window_bwd.launches`` counts kernel launches (one
    per call)."""
    if bops.use_plain(x_win):
        return band_attention_window_bwd_plain(a_dst, a_src_win, x_win, adj_mask, d_out,
                                               negative_slope)
    out = _recompute_bwd("band_attention_window_bwd", a_dst, a_src_win, x_win, adj_mask, d_out,
                         negative_slope, index)
    band_attention_window_bwd.launches += 1
    return out


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


# ---- the sliding-accumulator route (v3) ---------------------------------------

def band_attention_acc_bwd_plain(
    a_dst: torch.Tensor, a_src_win: torch.Tensor, x_ext: torch.Tensor,
    adj_mask: torch.Tensor, d_out: torch.Tensor, negative_slope: float = 0.2,
    mxu_bf16: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`band_attention_acc_bwd`: the same
    function as :func:`band_attention_bwd_plain` (v3's gradients are v2's)."""
    return band_attention_bwd_plain(a_dst, a_src_win, x_ext, adj_mask, d_out, negative_slope,
                                    mxu_bf16)


def band_attention_acc_bwd(
    a_dst: torch.Tensor, a_src_win: torch.Tensor, x_ext: torch.Tensor,
    adj_mask: torch.Tensor, d_out: torch.Tensor, negative_slope: float = 0.2,
    index: Optional[bops.BandIndex] = None, mxu_bf16: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The cotangents ``(d a_dst, d a_src_win, d x_ext)`` of
    :func:`band_attention_fwd` for ``d_out`` [B, n_pad, H, C], written by
    ``csrc/band_attention_acc_bwd.cu``: v2's passes, each row of ``d x_ext``
    summed by one owner warp, so the outputs equal
    :func:`band_attention_bwd`'s bit for bit.

    ``index`` as for :func:`band_attention_bwd`. On CUDA tensors it launches
    the kernel (or raises); on CPU tensors it runs
    :func:`band_attention_acc_bwd_plain`. ``band_attention_acc_bwd.launches``
    counts kernel launches (one per call: the four launches of the source are
    one launch of it); ``mxu_bf16`` launches the bf16-operand instance, which
    reads x_ext in bf16 (f32 rows are rounded once here), counted in
    ``launches_bf16``."""
    x_ext = _stored("band_attention_acc_bwd", x_ext, mxu_bf16)
    if bops.use_plain(x_ext):
        return band_attention_acc_bwd_plain(a_dst, a_src_win, x_ext, adj_mask, d_out,
                                            negative_slope, mxu_bf16)
    out = _recompute_bwd("band_attention_acc_bwd", a_dst, a_src_win, x_ext, adj_mask, d_out,
                         negative_slope, index, mxu_bf16)
    _count(band_attention_acc_bwd, mxu_bf16)
    return out


band_attention_acc_bwd.launches = band_attention_acc_bwd.launches_bf16 = 0


def band_attention_acc(
    a_dst: torch.Tensor, a_src_win: torch.Tensor, x_ext: torch.Tensor,
    adj_mask: torch.Tensor, negative_slope: float = 0.2,
    index: Optional[bops.BandIndex] = None, mxu_bf16: bool = False,
    halo: Optional[tuple[int, int]] = None,
) -> torch.Tensor:
    """Differentiable banded attention through the sliding-accumulator route:
    v2's forward kernel, as the reference's v3 reuses v2, and the owner-row
    backward :func:`band_attention_acc_bwd` (v2's passes); shapes and gradients as
    :func:`band_attention`; ``mxu_bf16``: the bf16-operand instances; ``halo``
    as for :func:`band_attention`."""
    return BandAttention.apply(a_dst, a_src_win, x_ext, adj_mask, negative_slope, index,
                               band_attention_acc_bwd, mxu_bf16, halo)
