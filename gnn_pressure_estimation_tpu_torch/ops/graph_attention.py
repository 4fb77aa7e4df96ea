"""Dense-mode GAT aggregation: the fused dense attention and the fused
factored aggregation as CUDA kernels, forward and backward, and their plain
versions.

Replaces ``make_fused_attention`` and ``make_fused_factored`` in
``gnn_pressure_estimation_tpu/ops/pallas/graph_attention.py``. With ``M`` the
template's ``[n, n]`` adjacency mask (self-loops in) and
``s_ij = a_dst[b, i, h] + a_src[b, j, h]`` formed as one f32 add:

* :func:`fused_attention` (``csrc/fused_attention.cu`` and ``_bwd.cu``):
  ``out[b, i, h] = Σ_j softmax_j(where(M_ij, where(s_ij >= 0, s_ij, slope·s_ij),
  −1e9)) · v[b, j, h]``. The backward recomputes the softmax from the saved
  inputs and returns ``(d a_dst, d a_src, d v)``. ``bf16`` (GATConv's
  ``attn_dtype=bfloat16``): v stored in bf16, the weights rounded to bf16
  for the product, and the output, dp and d v rounded to bf16, where the
  JAX layer's XLA branch rounds them.
* :func:`fused_factored` (``csrc/fused_factored.cu`` and ``_bwd.cu``): the
  aggregation of the factored rewrite, ``t_pv = P @ rhs_v`` and
  ``t_nq = (M − P) @ rhs_q`` with the 0/1 gate ``P = M · [s >= 0]``. The gate
  has no gradient: the backward returns ``Pᵀ g_pv`` and ``(M − P)ᵀ g_nq`` and
  nothing for ``a_dst`` and ``a_src``. The shifts and the exp vectors of the
  rewrite stay in the layer (``models/layers.py``).

Layout: the layer's own. ``a_dst``, ``a_src`` are ``[B, n, H]``; ``v``,
``rhs_v``, ``rhs_q`` and every output are ``[B, n, H, ·]``. The TPU kernels
take ``[B, H, n, ·]`` and the JAX layer transposes before and after them;
here nothing is transposed. Nor is n padded to a lane multiple or are graphs
grouped per step: the attention pair is v2's band attention on the band of
one block (nB 1, BLK = W = n), the forward its row walk
(``csrc/band_rowwalk.cuh``: a warp per (graph, row) for all heads), the
backward its five passes (``csrc/band_bwd.cuh``: a thread per (graph, row, head)
for p and dz, a warp per (graph, column) for all heads' d v and dp, a
thread per (graph, column, head) for d a_src); in the factored pair a warp owns
one (graph, node) with all its heads (the walk of ``csrc/dense_walk.cuh``,
over the row lists forward and the column lists backward).

The TPU kernels multiply whole n×n tiles. A water network's mask is about 1%
dense (388 self-loops and 1,430 directed edges in 150,544 cells on
synthctown), so these kernels walk a compressed index of the mask instead,
:class:`MaskIndex`: row lists for the forwards, the same entries grouped by
column for the sums that the backwards scatter by column (``d a_src``,
``d v``, ``d rhs_v``, ``d rhs_q``). Each output element is written once, by
one warp, in a fixed order: no ``atomicAdd``, so a run repeats to the bit.
The mask need not be symmetric. It must hold its whole diagonal (no row is
fully masked); :func:`build_mask_index` raises otherwise.

The JAX layer's ``gate_dtype=bfloat16`` only stores the 0/1 gate more
cheaply in device memory; these kernels never store the gate, so nothing of
it is ported.

Bound on an H100 SXM: bytes. At GATRes-small's conv1 on synthctown (B 32,
n 388, H 2, D 33) the factored forward reads a_dst, a_src, rhs_v, rhs_q and
writes two outputs, 13.3 MB, about 4 µs at 3.35 TB/s; its D adds per nonzero
are three orders of magnitude below the f32 rate at that traffic. Measured
there (NVIDIA H100 80GB HBM3, 700.00 W; ``chip_smoke.py`` phase 25): 13 µs
on the device, forward and backward alike, against 32 µs when a warp took
one head: the walk reads each list once for all heads and loads the rows of
several entries ahead of their adds, but a list is still a chain of
dependent loads (its bounds, its entries, their gate terms, then the rows).
At GATRes-large's conv1 (H 2, D 129) 34 µs against a bound of 15 µs. A
forward of the model launches 30 such kernels among about a thousand small
PyTorch launches, and the host's time to enqueue those sets the batch's
time.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from gnn_pressure_estimation_tpu_torch.ops import _build
from gnn_pressure_estimation_tpu_torch.ops.band_attention import _count, round_bf16
from gnn_pressure_estimation_tpu_torch.ops.banded import use_plain, vector_loads

NEG_INF = -1e9  # mask value of the dense attention logits (finite: no inf − inf)


@dataclasses.dataclass(frozen=True)
class MaskIndex:
    """The set cells of one ``[n, n]`` mask, by row and by column (numpy on
    the host, int32 tensors once moved with :meth:`to`).

    Entry ``k`` (row-major order) sits at row ``i`` and column ``col[k]``;
    ``t_*`` list the same entries sorted by ``(column, row)``. ``nbr`` lists
    each row's columns padded with the row's own index (its diagonal cell is
    always set), for per-row reductions over neighbours in plain torch.

    Built as ``ops.banded.build_band_index`` builds a band's index, so
    ``row_ptr``, ``col``, ``t_*``, ``empty_ptr`` and ``empty_row`` are,
    field for field, the ``BandIndex`` of the one-block band ``mask[None]``
    (nB 1, BLK = W = n): what the softmax backward
    (``csrc/fused_attention_bwd.cu``) hands the band backward's passes. No
    row is empty (every self-loop is set), so ``empty_ptr`` is ``[0, 0]``
    and ``empty_row`` empty.
    """

    n: int
    row_ptr: object     # [n + 1]  entries of row i: row_ptr[i]..row_ptr[i+1]
    col: object         # [nnz]    column of entry k
    t_ptr: object       # [n + 1]  entries of column j
    t_entry: object     # [nnz]    entry index k, sorted by (column, row)
    t_row: object       # [nnz]    row of that entry
    empty_ptr: object   # [2]      rows with no entry, of the one block: none
    empty_row: object   # [0]
    nbr: object         # [n, max row length] int64

    @property
    def nnz(self) -> int:
        return int(self.col.shape[0])

    def to(self, device) -> "MaskIndex":
        return dataclasses.replace(self, **{
            f.name: torch.as_tensor(getattr(self, f.name), device=device)
            for f in dataclasses.fields(self) if f.name != "n"})


def build_mask_index(mask: np.ndarray) -> MaskIndex:
    """Compress the set cells of ``mask`` ([n, n], any dtype). Raises if a
    diagonal cell is unset: every node attends to itself."""
    mask = np.asarray(mask) != 0
    n = mask.shape[0]
    if mask.shape != (n, n):
        raise ValueError(f"mask must be square, got {mask.shape}")
    if not mask.diagonal().all():
        raise ValueError("the attention mask lacks a self-loop: a row would be fully masked")
    i, j = np.nonzero(mask)                              # row-major: sorted by (i, j)
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(i, minlength=n), out=row_ptr[1:])
    order = np.lexsort((i, j))                           # by column, then by row
    t_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(j, minlength=n), out=t_ptr[1:])
    width = int(np.diff(row_ptr).max()) if n else 0
    nbr = np.repeat(np.arange(n, dtype=np.int64)[:, None], width, axis=1)
    nbr[i, np.arange(i.size) - row_ptr[i]] = j
    i32 = np.int32
    return MaskIndex(n=n, row_ptr=row_ptr.astype(i32), col=j.astype(i32),
                     t_ptr=t_ptr.astype(i32), t_entry=order.astype(i32),
                     t_row=i[order].astype(i32), empty_ptr=np.zeros(2, i32),
                     empty_row=np.zeros(0, i32), nbr=nbr)


def mask_index_of(mask: torch.Tensor) -> MaskIndex:
    """The :class:`MaskIndex` of a mask tensor, on the mask's device, built
    from the tensor's values (a device-to-host copy on every call): for
    callers without a template. The model's path passes the graph's cached
    index instead."""
    return build_mask_index(mask.detach().cpu().numpy()).to(mask.device)


# ---- plain versions ---------------------------------------------------------

def _softmax_p(a_dst, a_src, mask, negative_slope, bf16=False):
    """(zpre, p): the pre-activation sums [B, i, j, H] and the masked softmax;
    ``bf16``: its sum taken in double and rounded once, as the bf16 kernels
    take it (the weight they round then does not depend on the sum's order)."""
    zpre = a_dst[:, :, None, :] + a_src[:, None, :, :]
    # not F.leaky_relu: its gradient at z == 0 is the slope, the JAX package's
    # is 1, and two masked (zeroed) neighbours meet exactly there
    z = torch.where(zpre >= 0, zpre, negative_slope * zpre)
    z = torch.where(mask.bool()[None, :, :, None], z, NEG_INF)
    if not bf16:
        return zpre, torch.softmax(z, dim=2)
    e = torch.exp(z - z.amax(dim=2, keepdim=True))
    return zpre, e / e.sum(dim=2, keepdim=True, dtype=torch.float64).to(e.dtype)


def _stored(fn: str, v: torch.Tensor, bf16: bool) -> torch.Tensor:
    """v as the kernels read it: f32, or under ``bf16`` in bf16 (f32 rounded
    once here; the layer's Function hands its bf16 copy). bf16 without
    ``bf16`` raises: the f32 instances read f32."""
    if v.dtype == torch.bfloat16 and not bf16:
        raise ValueError(f"{fn}: v in bfloat16 is read only by the bf16 instance (bf16=True)")
    return v.to(torch.bfloat16) if bf16 else v


def fused_attention_plain(a_dst, a_src, v, mask, negative_slope: float = 0.2,
                          bf16: bool = False):
    """Plain PyTorch version of :func:`fused_attention_fwd`; ``bf16``:
    ``Σ bf16(p)·bf16(v)`` in f32, not rounded (the layer rounds it)."""
    _, p = _softmax_p(a_dst, a_src, mask, negative_slope, bf16)
    if bf16:
        p, v = round_bf16(p), _stored("fused_attention_plain", v, True).float()
    return torch.einsum("bijh,bjhc->bihc", p, v)


def fused_attention_bwd_plain(a_dst, a_src, v, mask, d_out, negative_slope: float = 0.2,
                              bf16: bool = False):
    """Plain PyTorch version of :func:`fused_attention_bwd`: the explicit
    formulas on the dense ``[B, n, n, H]`` tensors. ``bf16``: dO rounded for
    both products, dp = bf16(bf16(dO)·bf16(v)), d v = Σ bf16(p)·bf16(dO) in
    f32, not rounded (the layer rounds it), delta and dz from the f32 p."""
    zpre, p = _softmax_p(a_dst, a_src, mask, negative_slope, bf16)
    pv = p
    if bf16:
        v = _stored("fused_attention_bwd_plain", v, True).float()
        d_out, pv = round_bf16(d_out), round_bf16(p)
    dp = torch.einsum("bihc,bjhc->bijh", d_out, v)
    if bf16:
        dp = round_bf16(dp)
    dz = p * (dp - (p * dp).sum(dim=2, keepdim=True))
    # the sign of the pre-activation, not of LeakyReLU's output (masked: p = 0)
    dz = torch.where(zpre >= 0, dz, negative_slope * dz)
    return dz.sum(dim=2), dz.sum(dim=1), torch.einsum("bijh,bihc->bjhc", pv, d_out)


def _gates(a_dst, a_src, mask, dtype):
    """(P, M − P) as 0/1 tensors [B, i, j, H]."""
    m = mask.bool()[None, :, :, None]
    s = a_dst[:, :, None, :] + a_src[:, None, :, :]
    return (m & (s >= 0)).to(dtype), (m & ~(s >= 0)).to(dtype)


def fused_factored_plain(a_dst, a_src, rhs_v, rhs_q, mask):
    """Plain PyTorch version of :func:`fused_factored_fwd`."""
    pos, neg = _gates(a_dst, a_src, mask, rhs_v.dtype)
    return (torch.einsum("bijh,bjhd->bihd", pos, rhs_v),
            torch.einsum("bijh,bjhd->bihd", neg, rhs_q))


def fused_factored_bwd_plain(a_dst, a_src, mask, g_pv, g_nq):
    """Plain PyTorch version of :func:`fused_factored_bwd`."""
    pos, neg = _gates(a_dst, a_src, mask, g_pv.dtype)
    return (torch.einsum("bijh,bihd->bjhd", pos, g_pv),
            torch.einsum("bijh,bihd->bjhd", neg, g_nq))


# ---- kernel wrappers --------------------------------------------------------

def _check(fn: str, a_dst, a_src, wide: dict, index: MaskIndex, bf16: tuple = ()):
    """Raise on what the kernels do not take. ``wide``: name → [B, n, H, ·]
    tensor, all of one shape; those named in ``bf16`` in bfloat16, the rest
    f32."""
    first = next(iter(wide.values()))
    dev = first.device
    if dev.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {dev}")
    if first.dim() != 4:
        raise ValueError(f"{fn}: expected [B, n, H, ·] operands, got {tuple(first.shape)}")
    B, n, H, _ = first.shape
    if a_dst.shape != (B, n, H) or a_src.shape != (B, n, H):
        raise ValueError(f"{fn}: a_dst {tuple(a_dst.shape)} and a_src {tuple(a_src.shape)} "
                         f"do not fit {tuple(first.shape)}")
    for name, t in {"a_dst": a_dst, "a_src": a_src, **wide}.items():
        if name in wide and t.shape != first.shape:
            raise ValueError(f"{fn}: {name} {tuple(t.shape)} does not fit {tuple(first.shape)}")
        dt = torch.bfloat16 if name in bf16 else torch.float32
        if t.dtype != dt or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{fn}: {name} must be contiguous {dt} on {dev}")
    if index.n != n or index.col.device != dev:
        raise ValueError(f"{fn}: the mask index does not belong to this n and device")


def _index(mask, index: Optional[MaskIndex]) -> MaskIndex:
    return mask_index_of(mask) if index is None else index


_fns: dict = {}


def _launch(fn_name: str, lib: str, ptrs, ints, floats=()):
    """Call ``fn_name`` of the kernel library ``lib`` on the current stream
    (tensors' pointers, then ints, then floats, then the stream) and raise
    if the launch was refused."""
    fn = _fns.get(fn_name)
    if fn is None:
        fn = getattr(_build.load(lib), fn_name)
        fn.argtypes = ([ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * len(ints)
                       + [ctypes.c_float] * len(floats) + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[fn_name] = fn
    with torch.cuda.device(ptrs[0].device):
        rc = fn(*(t.data_ptr() for t in ptrs), *ints, *floats,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: kernel launch failed with CUDA error {rc}")


def fused_attention_fwd(a_dst, a_src, v, mask, negative_slope: float = 0.2,
                        index: Optional[MaskIndex] = None, bf16: bool = False) -> torch.Tensor:
    """a_dst, a_src [B, n, H] · v [B, n, H, C] · mask [n, n] → [B, n, H, C],
    all f32 (``bf16``: v bf16, or f32 rounded once here). No autograd: see
    :func:`fused_attention`.

    ``index`` is the mask's :class:`MaskIndex` on the same device (the
    graph's cached one on the model's path); without it the index is built
    from the mask's values. On CUDA tensors it launches the kernel (or
    raises); on CPU tensors it runs :func:`fused_attention_plain`. The
    kernel is v2's band row walk (``csrc/band_rowwalk.cuh``) on the band of
    one block (nB 1, BLK = W = n), over the index's row lists.
    ``fused_attention_fwd.launches`` counts kernel launches; ``bf16``
    launches v2's bf16-operand instance (``Σ bf16(p)·v``, output not
    rounded), counted in ``launches_bf16``."""
    name = "fused_attention_fwd"
    v = _stored(name, v, bf16)
    if use_plain(v):
        return fused_attention_plain(a_dst, a_src, v, mask, negative_slope, bf16)
    ix = _index(mask, index)
    _check(name, a_dst, a_src, {"v": v}, ix, ("v",) if bf16 else ())
    B, n, H, C = v.shape
    out = torch.empty(v.shape, dtype=torch.float32, device=v.device)
    _launch(name, "fused_attention", (a_dst, a_src, v, ix.row_ptr, ix.col, out),
            (B, n, H, C, int(vector_loads(v, C)), int(bf16)), (float(negative_slope),))
    _count(fused_attention_fwd, bf16)
    return out


fused_attention_fwd.launches = fused_attention_fwd.launches_bf16 = 0


def fused_attention_bwd(a_dst, a_src, v, mask, d_out, negative_slope: float = 0.2,
                        index: Optional[MaskIndex] = None, bf16: bool = False):
    """The cotangents ``(d a_dst, d a_src, d v)`` of :func:`fused_attention_fwd`
    for the output cotangent ``d_out`` [B, n, H, C]; the softmax is recomputed.
    ``index``, devices: as the forward. The kernel runs the dense softmax as a
    band of one block through v2's band backward (``csrc/band_bwd.cuh``): p
    per entry from the row lists; d v and dp per entry in one all-heads walk
    over the column lists; dz and d a_dst per row; d a_src per column.
    ``fused_attention_bwd.launches`` counts kernel launches (one per call:
    the four launches of the passes are one launch of it); ``bf16`` launches
    the bf16-operand instance over v in bf16 (f32 rounded once here), which
    rounds dp to bf16 before dz and returns d v unrounded, counted in
    ``launches_bf16``."""
    name = "fused_attention_bwd"
    v = _stored(name, v, bf16)
    if use_plain(v):
        return fused_attention_bwd_plain(a_dst, a_src, v, mask, d_out, negative_slope, bf16)
    ix = _index(mask, index)
    d_out = d_out.contiguous()
    _check(name, a_dst, a_src, {"v": v, "d_out": d_out}, ix, ("v",) if bf16 else ())
    B, n, H, C = v.shape
    d_a_dst, d_a_src = torch.empty_like(a_dst), torch.empty_like(a_src)
    d_v = torch.empty(v.shape, dtype=torch.float32, device=v.device)
    # per-entry softmax weight, and dp then dz, passed between the passes
    sp, sdz = (torch.empty((B, max(ix.nnz, 1), H), dtype=torch.float32, device=v.device)
               for _ in range(2))
    vec = vector_loads(v, C) and vector_loads(d_out, C)
    _launch(name, "fused_attention_bwd",
            (a_dst, a_src, v, d_out, ix.row_ptr, ix.col, ix.t_ptr, ix.t_entry, ix.t_row,
             ix.empty_ptr, ix.empty_row, sp, sdz, d_a_dst, d_a_src, d_v),
            (B, n, H, C, ix.nnz, int(vec), int(bf16)),
            (float(negative_slope),))
    _count(fused_attention_bwd, bf16)
    return d_a_dst, d_a_src, d_v


fused_attention_bwd.launches = fused_attention_bwd.launches_bf16 = 0


def fused_factored_fwd(a_dst, a_src, rhs_v, rhs_q, mask,
                       index: Optional[MaskIndex] = None):
    """a_dst, a_src [B, n, H] · rhs_v, rhs_q [B, n, H, D] · mask [n, n] →
    ``(t_pv, t_nq)``, each [B, n, H, D], all f32. No autograd: see
    :func:`fused_factored`. ``index``, devices: as
    :func:`fused_attention_fwd`; the plain version is
    :func:`fused_factored_plain`. ``fused_factored_fwd.launches`` counts
    kernel launches."""
    if use_plain(rhs_v):
        return fused_factored_plain(a_dst, a_src, rhs_v, rhs_q, mask)
    ix = _index(mask, index)
    _check("fused_factored_fwd", a_dst, a_src, {"rhs_v": rhs_v, "rhs_q": rhs_q}, ix)
    B, n, H, D = rhs_v.shape
    t_pv, t_nq = torch.empty_like(rhs_v), torch.empty_like(rhs_q)
    _launch("fused_factored_fwd", "fused_factored",
            (a_dst, a_src, rhs_v, rhs_q, ix.row_ptr, ix.col, t_pv, t_nq), (B, n, H, D))
    fused_factored_fwd.launches += 1
    return t_pv, t_nq


fused_factored_fwd.launches = 0


def fused_factored_bwd(a_dst, a_src, mask, g_pv, g_nq, index: Optional[MaskIndex] = None):
    """The cotangents ``(d rhs_v, d rhs_q)`` of :func:`fused_factored_fwd` for
    the output cotangents ``g_pv``, ``g_nq`` [B, n, H, D]; the gate is
    recomputed. ``index``, devices: as the forward; the plain version is
    :func:`fused_factored_bwd_plain`. ``fused_factored_bwd.launches`` counts
    kernel launches."""
    if use_plain(g_pv):
        return fused_factored_bwd_plain(a_dst, a_src, mask, g_pv, g_nq)
    ix = _index(mask, index)
    g_pv, g_nq = g_pv.contiguous(), g_nq.contiguous()
    _check("fused_factored_bwd", a_dst, a_src, {"g_pv": g_pv, "g_nq": g_nq}, ix)
    B, n, H, D = g_pv.shape
    d_rv, d_rq = torch.empty_like(g_pv), torch.empty_like(g_nq)
    _launch("fused_factored_bwd", "fused_factored_bwd",
            (a_dst, a_src, g_pv, g_nq, ix.t_ptr, ix.t_row, d_rv, d_rq), (B, n, H, D))
    fused_factored_bwd.launches += 1
    return d_rv, d_rq


fused_factored_bwd.launches = 0


# ---- autograd ---------------------------------------------------------------

class FusedAttention(torch.autograd.Function):
    """Forward and backward through the kernels (CUDA tensors) or through
    their plain versions (CPU tensors). Saves its inputs only: the backward
    recomputes the softmax. ``bf16`` (the layer's ``attn_dtype=bfloat16``):
    v is rounded once into a bf16 copy, which both instances read and which
    is saved in place of v; the output and d v are rounded to bf16 (kept in
    f32), as the JAX layer's XLA branch rounds its product's output and the
    cotangent of its bf16 operand."""

    @staticmethod
    def forward(ctx, a_dst, a_src, v, mask, negative_slope, index, bf16):
        if bf16:
            v = v.to(torch.bfloat16)
        ctx.save_for_backward(a_dst, a_src, v, mask)
        ctx.negative_slope, ctx.index, ctx.bf16 = negative_slope, index, bf16
        out = fused_attention_fwd(a_dst, a_src, v, mask, negative_slope, index, bf16)
        return round_bf16(out) if bf16 else out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_out):
        a_dst, a_src, v, mask = ctx.saved_tensors
        d_a_dst, d_a_src, d_v = fused_attention_bwd(a_dst, a_src, v, mask, d_out,
                                                    ctx.negative_slope, ctx.index, ctx.bf16)
        return (d_a_dst, d_a_src, round_bf16(d_v) if ctx.bf16 else d_v,
                None, None, None, None)


class FusedFactored(torch.autograd.Function):
    """As :class:`FusedAttention`. Saves a_dst and a_src only (the gate is a
    function of them alone) and returns no gradient for them: the gate is a
    comparison, so the gradient reaches α through the layer's exp vectors."""

    @staticmethod
    def forward(ctx, a_dst, a_src, rhs_v, rhs_q, mask, index):
        ctx.save_for_backward(a_dst, a_src, mask)
        ctx.index = index
        return fused_factored_fwd(a_dst, a_src, rhs_v, rhs_q, mask, index)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_pv, g_nq):
        a_dst, a_src, mask = ctx.saved_tensors
        d_rv, d_rq = fused_factored_bwd(a_dst, a_src, mask, g_pv, g_nq, ctx.index)
        return None, None, d_rv, d_rq, None, None


def fused_attention(a_dst, a_src, v, mask, negative_slope: float = 0.2,
                    index: Optional[MaskIndex] = None, bf16: bool = False) -> torch.Tensor:
    """Differentiable dense masked GAT attention, shapes as
    :func:`fused_attention_fwd`, all f32. Gradients flow to ``a_dst``,
    ``a_src`` and ``v``; the mask is a constant of the graph. ``bf16``: the
    bf16 instances, forward and backward, with the output and d v rounded
    to bf16 (see :class:`FusedAttention`)."""
    return FusedAttention.apply(a_dst.contiguous(), a_src.contiguous(), v.contiguous(),
                                mask, negative_slope, index, bf16)


def fused_factored(a_dst, a_src, rhs_v, rhs_q, mask, index: Optional[MaskIndex] = None):
    """Differentiable factored aggregation, shapes as
    :func:`fused_factored_fwd`. Gradients flow to ``rhs_v`` and ``rhs_q``
    only."""
    return FusedFactored.apply(a_dst.contiguous(), a_src.contiguous(), rhs_v.contiguous(),
                               rhs_q.contiguous(), mask, index)
