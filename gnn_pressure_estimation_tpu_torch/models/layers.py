"""Graph conv layers as torch modules: GATRes's and the model zoo's.

The counterparts of the layers of ``gnn_pressure_estimation_tpu/models/layers.py``
(``GATConv``, ``SimpleMeanConv``, ``GCNConv``, ``GCN2Conv``, ``ChebConv``,
``MLP``, ``GINConv``, ``GENConv``) in the dense, banded and degree-padded
aggregation modes. Attention math matches PyG GATConv (LeakyReLU 0.2,
self-loops added, per-receiver softmax).

On the banded path every GATConv goes through one of the four routes of
``ops.band_attention`` (the graph's ``band_attn``), and every
parameter-free aggregation (the mean, GIN's neighbour sum, the GCN and
Chebyshev operators: :func:`_band_agg`) through ``ops.band_spmm`` on the
int8 count band, its row and column scales applied outside; on the dense
path a GATConv goes through ``ops.graph_attention`` (``fused_factored`` or
``fused_attention``, by ``attn_impl``), at any width and any n: autograd
Functions that launch the hand-written kernels, forward and backward, when
the graph lies on a CUDA device, and run the kernels' plain versions on the
CPU. The graph carries the compressed index of each mask or band that the
kernels walk. The dense aggregations are one ``torch.einsum`` with the
template's ``[n, n]`` operator, as in the JAX layers. The padded path
gathers neighbour slots with ``ops.padded`` and reduces over them in plain
torch, as the JAX layers do in plain XLA. GENConv gathers over the edge list
and sums per receiver with ``ops.segment`` in every mode, as the JAX layer
does.

On a graph in none of those modes (the edge partition's local graph, or a
graph whose padded tables were taken out) every layer takes the edge-list
path of the JAX layers: ``ops.segment``'s ``spmm`` with the GCN or
Chebyshev edge weights, GATConv's ``segment_softmax`` over the
self-loop-augmented list; with ``graph.axis_name`` set the senders index
the graph group's all-gathered node blocks and padding edges are masked.
A halo-mode graph (``graph.halo``, the halo strategy's chunk) runs the
banded path, its window rows beyond the chunk taken from the neighbouring
ranks (``parallel.halo.halo_exchange``) instead of zeros.

Divergence from the JAX layers: at channel widths that are not a multiple
of 128 the JAX banded aggregations take plain XLA over the float bands
(``band_adj``, ``band_gcn``, ``band_cheb``); here every width goes through
the kernel over the counts and the scales. The math is the same; the order
of the sums differs.

Parameters are initialised as the JAX layers do, from an optional
``torch.Generator``: glorot-uniform for conv weights (flax's fans: a
``[K, in, out]`` Chebyshev weight has fan_in K·in, fan_out K·out),
U(±1/√fan_in) for the MLP and GIN heads (``torch_linear``), zero biases.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from gnn_pressure_estimation_tpu_torch.core.graph import BatchedGraph
from gnn_pressure_estimation_tpu_torch.ops import banded as bops
from gnn_pressure_estimation_tpu_torch.ops import segment
from gnn_pressure_estimation_tpu_torch.ops.band_attention import (
    band_attention, band_attention_acc, band_attention_flash, band_attention_window, round_bf16,
)
from gnn_pressure_estimation_tpu_torch.ops.band_spmm import band_spmm
from gnn_pressure_estimation_tpu_torch.ops.graph_attention import fused_attention, fused_factored

ATTN_IMPLS = ("softmax", "onepass", "factored", "band_factored")
# attn_dtype / gate_dtype values: None (f32), or a dtype the JAX layer accepts
ATTN_DTYPES = (None, torch.float32, torch.bfloat16)
NEG_INF = -1e9  # the masked logit of the padded path, as the JAX layer's
BAND_ATTEND = {"dma": band_attention, "flash": band_attention_flash, "acc": band_attention_acc}


def bf16_scalar(v: float) -> float:
    """``v`` rounded to bfloat16: a Python float that a JAX layer with bf16
    activations multiplies in (weak typing gives it the array's dtype)."""
    return float(torch.tensor(v, dtype=torch.bfloat16))


def _lrelu(z: torch.Tensor, slope: float) -> torch.Tensor:
    """LeakyReLU in ``z``'s dtype, the slope a tensor of that dtype (in bf16:
    the product rounded, the slope bf16's 0.2), the gradient at 0 that of
    the positive branch, as the JAX layer's ``jnp.where`` gives it."""
    return torch.where(z >= 0, z, torch.tensor(slope, dtype=z.dtype, device=z.device) * z)


def check_dtype_knob(name: str, value):
    """``value`` if the port computes it (``ATTN_DTYPES``), else raise."""
    if value not in ATTN_DTYPES:
        raise NotImplementedError(f"{name}={value!r} is not ported: None, torch.float32 or "
                                  "torch.bfloat16")
    return value


@torch.no_grad()
def glorot_(t: torch.Tensor, fan_in: int, fan_out: int,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Glorot-uniform in place: U(±sqrt(6 / (fan_in + fan_out))), the bound of
    flax's ``glorot_uniform`` for the same parameter."""
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return t.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def torch_linear_(t: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """U(±1/√fan_in) in place: ``torch.nn.Linear``'s default weight bound,
    the JAX layers' ``torch_linear`` initialiser."""
    bound = 1.0 / math.sqrt(fan_in)
    return t.uniform_(-bound, bound, generator=generator)


def _halo_rows(xb: torch.Tensor, graph: BatchedGraph) -> torch.Tensor:
    """A halo chunk [B, n_pad, ...] → [B, U + n_pad + R, ...] with the
    neighbouring ranks' rows around it (``bops.extend_rows`` puts zeros
    there on one device)."""
    from gnn_pressure_estimation_tpu_torch.parallel.halo import halo_exchange

    return halo_exchange(xb, graph.band_U, graph.band_R, graph.axis_name)


def _windows(xb: torch.Tensor, graph: BatchedGraph) -> torch.Tensor:
    """[B, n_pad, ...] → [nB, B, W, ...] band windows; in halo mode the
    window extension rows come from the neighbouring ranks."""
    if graph.halo:
        nB = len(graph.band_win_start)
        return bops.band_windows_ext(_halo_rows(xb, graph), nB, graph.band_n_pad // nB,
                                     graph.band_W)
    return bops.band_windows(xb, graph.band_win_start, graph.band_W)


def _band_agg(kind: str, x: torch.Tensor, graph: BatchedGraph) -> torch.Tensor:
    """A parameter-free banded aggregation through ``ops.band_spmm`` on the
    int8 count band, the factored scales applied outside (x in perm + pad
    space, [B·n_pad, C] → [B·n_pad, C]): ``"adj"`` the counts; ``"mean"``
    rows × 1/deg; ``"gcn"`` the counts with self-loops, rows and columns ×
    1/√(deg+1); ``"cheb"`` columns × 1/√deg, rows × −1/√deg."""
    B, n_pad = graph.n_graph, graph.band_n_pad
    band, index, rs, cs = graph.band_cnt, graph.band_cnt_index, None, None
    if kind == "mean":
        rs = graph.band_inv_deg
    elif kind == "gcn":
        band, index = graph.band_cnt_sl, graph.band_cnt_sl_index
        rs = cs = graph.band_dinv_sl
    elif kind == "cheb":
        rs, cs = -graph.band_dinv, graph.band_dinv
    elif kind != "adj":
        raise ValueError(f"unknown band aggregation {kind!r}")
    xb = x.reshape(B, n_pad, -1)
    if cs is not None:
        xb = xb * cs[None, :, None]
    x_ext = (_halo_rows(xb, graph) if graph.halo
             else bops.extend_rows(xb, graph.band_U, graph.band_R))
    out = band_spmm(band, x_ext, index)
    if rs is not None:
        out = out * rs[None, :, None]
    return out.reshape(B * n_pad, -1)


def _dense_agg(mat: torch.Tensor, x: torch.Tensor, graph: BatchedGraph) -> torch.Tensor:
    """``out[b] = mat @ x[b]`` with a template-level [n, n] operator."""
    B, n = graph.n_graph, graph.nodes_per_graph
    return torch.einsum("ij,bjc->bic", mat, x.reshape(B, n, -1)).reshape(B * n, -1)


def _padded_weighted_agg(gather_fn, x: torch.Tensor, w_dp: torch.Tensor) -> torch.Tensor:
    """Σ_d w[n, d] · x[senders[n, d]]: the degree-padded weighted sum (the
    weights are zero on empty slots)."""
    return torch.einsum("nd,ndc->nc", w_dp, gather_fn(x))


def _padded_sum(x: torch.Tensor, graph: BatchedGraph) -> torch.Tensor:
    """Σ over each node's valid in-edge slots."""
    return torch.where(graph.mask_dp[..., None], graph.gather_dp(x), 0.0).sum(dim=1)


def _aggregate(kind: str, x: torch.Tensor, graph: BatchedGraph) -> torch.Tensor:
    """One of the parameter-free aggregations in the graph's mode: ``"adj"``
    (the neighbour sum), ``"mean"``, ``"gcn"`` (symmetric-normalised, with
    self-loops) or ``"cheb"`` (the scaled Laplacian −D^-1/2 A D^-1/2)."""
    if graph.dense:
        mat = {"adj": graph.adj_mat, "mean": graph.mean_mat, "gcn": graph.gcn_mat,
               "cheb": graph.cheb_mat}[kind]
        return _dense_agg(mat, x, graph)
    if graph.banded or graph.halo:
        return _band_agg(kind, x, graph)
    if graph.padded:
        if kind == "adj":
            return _padded_sum(x, graph)
        if kind == "mean":
            return _padded_sum(x, graph) * graph.inv_degree[:, None]
        if kind == "gcn":
            return _padded_weighted_agg(graph.gather_dp_sl, x, graph.gcn_dp_sl)
        return _padded_weighted_agg(graph.gather_dp, x, graph.cheb_dp)
    # the edge-list path
    ax = graph.axis_name
    if kind == "gcn":
        return segment.spmm(x, graph.edges_sl, graph.gcn_norm, ax, graph.edge_mask_sl)
    if kind == "cheb":
        return segment.spmm(x, graph.edges, graph.cheb_norm, ax, graph.edge_mask)
    agg = segment.spmm(x, graph.edges, None, ax, graph.edge_mask)
    return agg * graph.inv_degree[:, None] if kind == "mean" else agg


class GATConv(nn.Module):
    """Graph attention conv (Velickovic et al.), PyG-compatible semantics.

    out[i] = Σ_{j∈N(i)∪{i}} α_ij · (W x_j) per head, heads concatenated or
    averaged, plus bias; α = softmax_i(LeakyReLU(a_s·Wx_j + a_d·Wx_i)).

    ``attn_impl`` selects the dense-path formulation: ``softmax`` (masked
    logits → softmax → weighted sum, through ``ops.fused_attention``),
    ``factored`` (the exp(LeakyReLU) numerator as two rank-1 products gated by
    the 0/1 sign matrix, its two gated sums through ``ops.fused_factored``) or
    ``onepass`` (the numerator materialised once, 1/Z applied after the
    product; plain torch, it has no kernel). Same math up to rounding.

    The banded path computes the windowed softmax for all three, as the JAX
    layer does, through the kernel the graph names (``graph.band_attn``):
    ``"dma"`` (``ops.band_attention``, the extended array, whole-window
    softmax), ``"flash"`` (``ops.band_attention_flash``, the extended array,
    streaming softmax), ``"window"`` (``ops.band_attention_window``, over
    window tensors the layer cuts with ``band_windows``; autograd folds their
    cotangents) or ``"acc"`` (``ops.band_attention_acc``, the extended array,
    v2's forward and the owner-row backward); the three that read the
    extended array build it from the projected rows inside their autograd
    Function, in bf16 under ``attn_dtype`` bf16. ``attn_impl="band_factored"``
    is ``factored`` on the dense path; on the banded path layers that the
    JAX layer hands to a Pallas kernel (slope 0.2, H·C at least 128) keep
    the graph's route, and narrower ones run
    ``ops.banded.band_attention_factored``, plain torch, as the JAX layer
    runs it in plain XLA. The padded path gathers each node's
    ``D + 1`` slots (in-edges and the self-loop) of α_src and of the
    projected features, masks the empty slots, and takes the softmax over
    the slots, for every ``attn_impl``, as the JAX layer does.

    ``attn_dtype`` (None = f32, or ``torch.bfloat16``) is the JAX layer's
    knob of the same name, honoured where the JAX layer honours it:
    banded, the bf16-operand instances of the band kernels (``mxu_bf16``)
    on the routes that have them ("dma", "flash", "acc") and only where the
    JAX layer reaches its v2-family kernel (negative slope 0.2, H·C a
    multiple of 128); dense ``factored``, the operands ``v·[x, 1]`` and
    ``q·[x, 1]`` stored in bf16 (the JAX layer's default, XLA, branch);
    dense ``onepass``, the numerator and the features stored in bf16; dense
    ``softmax``, the bf16 instances of ``ops.fused_attention`` (the features
    stored in bf16, the normalised weights rounded for the product, the
    product's output, dp and d x rounded to bf16, as the JAX layer's XLA
    branch rounds them). The window route, narrower banded layers and the
    padded mode ignore it, as in the JAX layer. ``gate_dtype`` is
    accepted and changes nothing: the gate is 0/1, exact in either type, and
    the factored kernel never stores it.

    ``dtype`` (None = f32, or ``torch.bfloat16``) is the JAX layer's
    activation dtype. Under bf16 the layer rounds where the JAX layer's bf16
    ops round in the JAX package's compiled (jit) program: ``x @ w`` on bf16
    operands, its output and the logit halves' f32 sums rounded; then the
    attention in bf16 tensors (each elementwise op rounded, the slope bf16's
    0.2), its products' operands in bf16 and their sums in f32; the output
    of each mode's product rounded; the bias added in f32 to the rounded
    values; the output f32. The kernels keep f32 interfaces and take
    bf16-valued operands: dense ``factored`` through ``fused_factored``
    (the gate's sign is that of the rounded sum), dense ``softmax`` through
    ``fused_attention``'s bf16 instance with the logits rounded
    (``logit_bf16``), banded layers narrower than the JAX layer's Pallas
    kernels through v2's bf16 instance with the logits rounded, on every
    route (the JAX layer runs its XLA band ops there whatever the route),
    or ``band_factored``. A banded layer that the JAX layer hands to a Pallas
    kernel (slope 0.2, H·C at least 128) does what the JAX layer does: on
    the v2 family (the "dma", "flash" and "acc" routes at H·C a multiple of
    128) it raises before any launch (the kernels' f32 VMEM scratch refuses
    the bf16 rows: ``lax.dynamic_update_slice`` requires one dtype); on v1
    (the window route, or another H·C) the forward runs through the window
    kernel with the logits rounded and the weights, the product and the
    output in f32, and the backward raises (the JAX v1 kernel's custom VJP
    returns f32 cotangents for bf16 operands).
    """

    FLAX_NAMES = {"lin.weight": "w"}   # the projection is the flax module's leaf w

    def __init__(self, in_channels: int, out_channels: int, heads: int = 1,
                 concat: bool = True, negative_slope: float = 0.2,
                 attn_impl: str = "softmax", attn_dtype=None, gate_dtype=None, dtype=None):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise NotImplementedError(f"attn_impl {attn_impl!r} is not yet ported")
        self.dtype = check_dtype_knob("dtype", dtype)
        self.in_channels, self.out_channels = in_channels, out_channels
        self.heads, self.concat = heads, concat
        self.negative_slope, self.attn_impl = negative_slope, attn_impl
        self.attn_dtype = check_dtype_knob("attn_dtype", attn_dtype)
        self.gate_dtype = check_dtype_knob("gate_dtype", gate_dtype)
        self.lin = nn.Linear(in_channels, heads * out_channels, bias=False)
        self.att_src = nn.Parameter(torch.empty(1, heads, out_channels))
        self.att_dst = nn.Parameter(torch.empty(1, heads, out_channels))
        self.bias = nn.Parameter(torch.empty(heads * out_channels if concat else out_channels))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        H, C = self.heads, self.out_channels
        glorot_(self.lin.weight, self.in_channels, H * C, generator)
        # flax fans of a (1, H, C) parameter: fan_in H, fan_out C
        glorot_(self.att_src, H, C, generator)
        glorot_(self.att_dst, H, C, generator)
        nn.init.zeros_(self.bias)

    def _kernel_width(self) -> bool:
        """Whether the JAX layer hands this layer's banded attention to a
        Pallas kernel (v2-family or v1): slope 0.2 and H·C at least 128."""
        return self.negative_slope == 0.2 and self.heads * self.out_channels >= 128

    def _v2_family(self, graph) -> bool:
        """Whether that kernel is the JAX layer's v2-family one (the "dma",
        "flash" and "acc" routes at H·C a multiple of 128), not v1."""
        return (self._kernel_width() and graph.band_attn != "window"
                and self.heads * self.out_channels % 128 == 0)

    def forward(self, x: torch.Tensor, graph: BatchedGraph) -> torch.Tensor:
        H, C = self.heads, self.out_channels
        act = self.dtype == torch.bfloat16
        if act and (graph.banded or graph.halo) and self._v2_family(graph):
            raise NotImplementedError(
                f"GATConv(dtype=bfloat16) at H·C {H * C} on the banded {graph.band_attn!r} route: "
                "the JAX layer hands this layer to its v2-family Pallas band kernel, whose f32 "
                "VMEM scratch refuses bf16 rows (lax.dynamic_update_slice requires one dtype), "
                "so the JAX package raises here; bf16 activations run on the dense and padded "
                "paths and on banded layers narrower than 128 channels")
        if act:
            bf = torch.bfloat16
            # x @ w on bf16 operands, summed in f32 and rounded; the halves'
            # products in f32 from the bf16 values, their sums rounded
            xp = F.linear(x.to(bf).float(), self.lin.weight.to(bf).float()).to(bf).view(-1, H, C)
            a_s = (xp.float() * self.att_src.to(bf).float()).sum(-1).to(bf)
            a_d = (xp.float() * self.att_dst.to(bf).float()).sum(-1).to(bf)
        else:
            xp = self.lin(x).view(-1, H, C)
            # per-node attention logit halves (a_s/a_d are rank-1 per head)
            a_s = (xp * self.att_src).sum(-1)                      # [N, H]
            a_d = (xp * self.att_dst).sum(-1)
        B = graph.n_graph
        if graph.dense:
            out = self._dense(xp.view(B, -1, H, C), a_s.view(B, -1, H), a_d.view(B, -1, H), graph)
        elif graph.banded or graph.halo:
            out = self._banded(xp, a_s, a_d, graph)
        elif graph.padded:
            # per-node neighbour slots (in-edges, then the self-loop), masked
            # softmax over the slots
            logits = _lrelu(graph.gather_dp_sl(a_s) + a_d[:, None, :], self.negative_slope)
            logits = torch.where(graph.mask_dp_sl[..., None], logits,
                                 torch.full((), NEG_INF, dtype=logits.dtype, device=logits.device))
            # the softmax in f32; under bf16 its weights rounded, the product
            # summed in f32 and rounded, as the JAX layer's bf16 einsum
            attn = torch.softmax(logits.float(), dim=1).to(xp.dtype)           # [N, D+1, H]
            out = torch.einsum("ndh,ndhc->nhc", attn.float(),
                               graph.gather_dp_sl(xp).float()).to(xp.dtype)
        else:
            # the edge list with self-loops: per-receiver softmax over its edges
            edges, emask, ax = graph.edges_sl, graph.edge_mask_sl, graph.axis_name
            logits = _lrelu(segment.gather_src(a_s, edges, ax) + segment.gather(a_d, edges),
                            self.negative_slope)
            alpha = segment.segment_softmax(logits.float(), edges, emask).to(xp.dtype)  # [E, H]
            out = segment.spmm(xp.float(), edges, alpha.float(), ax, emask).to(xp.dtype)
        out = out.reshape(-1, H, C)
        out = out.reshape(-1, H * C) if self.concat else out.mean(dim=1)
        if act:
            # the JAX layer adds the bias in bf16 and returns f32: XLA adds
            # the rounded values in f32 and keeps the sum
            return out.float() + self.bias.to(torch.bfloat16).float()
        return out + self.bias

    def _banded(self, xp, a_s, a_d, graph):
        """Banded local attention over the graph's windows: [B, n_pad, H, C]."""
        H, C = self.heads, self.out_channels
        B, n_pad = graph.n_graph, graph.band_n_pad
        if self.attn_impl == "band_factored" and not self._kernel_width():
            xp_win = _windows(xp.view(B, n_pad, H * C), graph)
            return bops.band_attention_factored(
                a_d.view(B, n_pad, H), _windows(a_s.view(B, n_pad, H), graph),
                xp_win.view(xp_win.shape[:3] + (H, C)), graph.band_adj_mask,
                self.negative_slope, store_dtype=self.attn_dtype)
        if self.dtype == torch.bfloat16 and self._kernel_width():
            # the JAX layer's v1 kernel (the window route, or H·C not a multiple
            # of 128; forward() raised on the v2 family): the logits rounded,
            # the weights, the product and the output in f32; its backward
            # raises, as the JAX one does
            xp_w = _windows(xp.float().view(B, n_pad, H * C), graph)
            return band_attention_window(
                a_d.float().view(B, n_pad, H).contiguous(),
                _windows(a_s.float().view(B, n_pad, H), graph),
                xp_w.view(xp_w.shape[:3] + (H, C)), graph.band_adj_mask,
                bf16_scalar(self.negative_slope), graph.band_adj_index, logit_bf16=True)
        if self.dtype == torch.bfloat16:
            # a narrow layer: the JAX layer's XLA band ops, as v2's bf16
            # instance with the logits rounded, on every route; the output
            # rounded, as their product's is
            xp_b = xp.float().view(B, n_pad, H, C)
            out = band_attention(
                a_d.float().view(B, n_pad, H).contiguous(),
                _windows(a_s.float().view(B, n_pad, H), graph),
                _halo_rows(xp_b, graph) if graph.halo else xp_b, graph.band_adj_mask,
                bf16_scalar(self.negative_slope), graph.band_adj_index, mxu_bf16=True,
                halo=None if graph.halo else (graph.band_U, graph.band_R), logit_bf16=True)
            return out.to(torch.bfloat16)
        a_src_win = _windows(a_s.view(B, n_pad, H), graph)
        xp_b = xp.view(B, n_pad, H, C)
        if graph.band_attn == "window":
            attend, kw = band_attention_window, {}
            x_in = _windows(xp_b, graph)
        else:
            # the Function extends the projected rows itself: in bf16 for the
            # bf16-operand instances, which run where the JAX layer takes its
            # v2-family kernel. A halo chunk hands it the exchanged rows
            # (halo=None): under mxu_bf16 the wrappers round f32 rows once
            attend = BAND_ATTEND[graph.band_attn]
            x_in = _halo_rows(xp_b, graph) if graph.halo else xp_b
            kw = {"halo": None if graph.halo else (graph.band_U, graph.band_R),
                  "mxu_bf16": (self.attn_dtype == torch.bfloat16
                               and self.negative_slope == 0.2 and H * C % 128 == 0)}
        return attend(a_d.view(B, n_pad, H).contiguous(), a_src_win, x_in,
                      graph.band_adj_mask, self.negative_slope, graph.band_adj_index, **kw)

    def _dense(self, xp_b, a_s, a_d, graph):
        """Dense masked attention over all pairs: [B, n, H, C] → [B, n, H, C].
        Under bf16 activations ``xp_b``, ``a_s``, ``a_d`` are bf16 and so is
        every op on them, as in the JAX layer; the products take their bf16
        operands in f32 and the result is rounded to bf16."""
        sl = self.negative_slope
        mask, index = graph.adj_sl_mask, graph.adj_sl_index
        act = self.dtype == torch.bfloat16
        bf16 = act or self.attn_dtype == torch.bfloat16
        store = round_bf16 if bf16 else (lambda t: t)
        if self.attn_impl == "softmax":
            if act:
                return fused_attention(a_d.float(), a_s.float(), xp_b.float(), mask, bf16_scalar(sl),
                                       index, True, logit_bf16=True).to(torch.bfloat16)
            return fused_attention(a_d, a_s, xp_b, mask, sl, index, bf16)
        C = xp_b.shape[-1]
        with torch.no_grad():
            # the row max of the logits from the sender halves alone: LeakyReLU
            # is monotone, so max_j lrelu(a_d[i] + a_s[j]) = lrelu(a_d[i] +
            # max_{j∈N(i)} a_s[j]). A shift only (softmax is shift-invariant),
            # so it carries no gradient. Taken over each row's neighbour list
            # (padded with the row itself, which is always a neighbour).
            ms = a_s[:, index.nbr].amax(dim=2)                             # [B,i,H]
            m = _lrelu(a_d + ms, sl)
        if self.attn_impl == "onepass":
            # the softmax numerator, materialised once; 1/Z after the product
            y = _lrelu(a_d[:, :, None, :] + a_s[:, None, :, :], sl)          # [B,i,j,H]
            num = store(torch.where(mask[None, :, :, None], torch.exp(y - m[:, :, None, :]), 0.0)
                        .float())
            out = torch.einsum("bijh,bjhc->bihc", num, store(xp_b.float()))
            out = out / num.sum(dim=2)[..., None]
            return out.to(torch.bfloat16) if act else out
        # factored: exp(lrelu(a_d+a_s)) = [s≥0]·e^{a_d}e^{a_s} + [s<0]·e^{αa_d}e^{αa_s}.
        # Working range: the exps of the per-node halves must stay finite in
        # f32 (|a| ≲ 80 after the shifts), as for the JAX layer. ("band_factored"
        # is this formulation on the dense path, as in the JAX layer.)
        al = torch.tensor(sl, dtype=a_s.dtype, device=a_s.device)
        with torch.no_grad():
            cs = F.relu(a_s.amax(dim=1, keepdim=True))                   # [B,1,H]
        u, p = torch.exp(a_d - m), torch.exp(al * a_d - m)                 # [B,i,H]
        v, q = torch.exp(a_s - cs), torch.exp(al * a_s - cs)               # [B,j,H]
        # a ones column carries the softmax denominator through the sums; bf16:
        # both operands stored in bf16, that column included, as the JAX layer
        # stores them (its products are exact in f32, only the sums' order differs)
        xa = torch.cat([xp_b, xp_b.new_ones(xp_b.shape[:-1] + (1,))], dim=-1)
        t_pv, t_nq = fused_factored(a_d.float(), a_s.float(), store((v[..., None] * xa).float()),
                                    store((q[..., None] * xa).float()), mask, index)
        outz = u[..., None].float() * t_pv + p[..., None].float() * t_nq
        out = outz[..., :C] / outz[..., C:]
        return out.to(torch.bfloat16) if act else out


class SimpleMeanConv(nn.Module):
    """Parameter-free neighbor mean, PyG ``SimpleConv(aggr='mean')``: no
    self-loops, mean over in-neighbors. Banded mode sums over the int8
    edge-count band and scales the rows by 1/deg afterwards; padded mode sums
    the valid in-edge slots and scales by 1/deg."""

    def forward(self, x: torch.Tensor, graph: BatchedGraph) -> torch.Tensor:
        return _aggregate("mean", x, graph)


class GCNConv(nn.Module):
    """GCN conv: symmetric normalisation with self-loops, D^-1/2 (A+I)
    D^-1/2 · x W (+ bias). ``normalize=False`` is PyG's flag: the plain
    neighbour sum, no self-loops, no normalisation (the remask stack's
    stem)."""

    FLAX_NAMES = {"lin.weight": "w"}   # the projection is the flax module's leaf w

    def __init__(self, in_channels: int, out_channels: int, use_bias: bool = True,
                 normalize: bool = True):
        super().__init__()
        self.in_channels, self.out_channels, self.normalize = in_channels, out_channels, normalize
        self.lin = nn.Linear(in_channels, out_channels, bias=False)
        self.bias = nn.Parameter(torch.empty(out_channels)) if use_bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        glorot_(self.lin.weight, self.in_channels, self.out_channels, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, graph: BatchedGraph) -> torch.Tensor:
        out = _aggregate("gcn" if self.normalize else "adj", self.lin(x), graph)
        return out if self.bias is None else out + self.bias


class GCN2Conv(nn.Module):
    """GCNII layer (Chen et al. 2020), PyG ``GCN2Conv`` with shared weights:
    H = (1−α)·Â x + α·x0; out = (1−β)·H + β·(H W), β = log(θ/ℓ + 1)."""

    FLAX_NAMES = {"lin.weight": "w"}

    def __init__(self, channels: int, alpha: float = 0.1, theta: float = 0.5,
                 layer_index: int = 1):
        super().__init__()
        self.channels, self.alpha = channels, alpha
        self.beta = math.log(theta / layer_index + 1.0)
        self.lin = nn.Linear(channels, channels, bias=False)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        glorot_(self.lin.weight, self.channels, self.channels, generator)

    def forward(self, x: torch.Tensor, x0: torch.Tensor, graph: BatchedGraph) -> torch.Tensor:
        h = (1.0 - self.alpha) * _aggregate("gcn", x, graph) + self.alpha * x0
        return (1.0 - self.beta) * h + self.beta * self.lin(h)


class ChebConv(nn.Module):
    """Chebyshev spectral conv, PyG ``ChebConv`` (sym norm, λmax = 2): the
    scaled Laplacian is L̃ = −D^-1/2 A D^-1/2; T0 = x, T1 = L̃ x,
    Tk = 2 L̃ T(k−1) − T(k−2); out = Σ Tk Wk (+ bias). The weight keeps the
    JAX layout, ``[K, in, out]``. Any K is a plain loop over the recurrence
    (the JAX layer rolls K > 8 into one ``lax.scan``, which changes its
    program, not its math)."""

    FLAX_NAMES = {"weight": "w"}

    def __init__(self, in_channels: int, out_channels: int, K: int, use_bias: bool = True):
        super().__init__()
        self.in_channels, self.out_channels, self.K = in_channels, out_channels, K
        self.weight = nn.Parameter(torch.empty(K, in_channels, out_channels))
        self.bias = nn.Parameter(torch.empty(out_channels)) if use_bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        K = self.K
        glorot_(self.weight, K * self.in_channels, K * self.out_channels, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, graph: BatchedGraph) -> torch.Tensor:
        w = self.weight
        tx_prev, out = x, x @ w[0]
        if self.K > 1:
            tx = _aggregate("cheb", x, graph)
            out = out + tx @ w[1]
            for k in range(2, self.K):
                tx_next = 2.0 * _aggregate("cheb", tx, graph) - tx_prev
                out = out + tx_next @ w[k]
                tx_prev, tx = tx, tx_next
        return out if self.bias is None else out + self.bias


class MLP(nn.Module):
    """Linear stack with SELU between hidden layers (the reference's custom
    MLP, which GIN and m_GCN use); weights U(±1/√fan_in), zero biases. The
    JAX layer's dropout, which no model of the zoo sets, is not ported."""

    FLAX_NAMES = {"layers": "Dense_{}"}

    def __init__(self, in_channels: int, dims: tuple, use_bias: bool = True):
        super().__init__()
        widths = (in_channels,) + tuple(dims)
        self.layers = nn.ModuleList(nn.Linear(a, b, bias=use_bias)
                                    for a, b in zip(widths[:-1], widths[1:]))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for lin in self.layers:
            torch_linear_(lin.weight, lin.in_features, generator)
            if lin.bias is not None:
                nn.init.zeros_(lin.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i < len(self.layers) - 1:
                x = F.selu(x)
        return x


class GINConv(nn.Module):
    """GIN conv: ``nn((1+eps)·x + Σ_j x_j)``, no self-loops; ``nn`` is the
    SELU MLP of ``mlp_dims`` or, with ``linear_out``, a bias-free Linear."""

    FLAX_NAMES = {"mlp": "MLP_0", "lin": "Dense_0"}

    def __init__(self, in_channels: int, mlp_dims: Optional[tuple] = None,
                 linear_out: Optional[int] = None, eps: float = 0.0):
        super().__init__()
        if (mlp_dims is None) == (linear_out is None):
            raise ValueError("GINConv takes mlp_dims or linear_out")
        self.eps = eps
        self.mlp = MLP(in_channels, mlp_dims) if mlp_dims is not None else None
        self.lin = nn.Linear(in_channels, linear_out, bias=False) if linear_out else None
        self.out_channels = mlp_dims[-1] if mlp_dims is not None else linear_out
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        if self.mlp is not None:
            self.mlp.reset_parameters(generator)
        else:
            torch_linear_(self.lin.weight, self.lin.in_features, generator)

    def forward(self, x: torch.Tensor, graph: BatchedGraph) -> torch.Tensor:
        h = (1.0 + self.eps) * x + _aggregate("adj", x, graph)
        return self.mlp(h) if self.mlp is not None else self.lin(h)


class GENConv(nn.Module):
    """m_GCN's GENConvolution (the reference's GraphModels.py:277-397):

        message = selu(concat(x_j, e_ij)) + eps      (eps 1e-7)
        e_ij    = edge_emb + |x_src − x_dst|
        latent  = Σ_j message                         (add aggregation)
        latent  = res(latent) [mlp] or tanh(res(latent)) [not mlp]
        latent += x_i                                 (residual)
        latent  = MLP(latent)                         [mlp only]

    Over the edge list in every mode: ``ops.segment`` gathers the endpoints
    and sums per receiver, with no atomics. ``edge_emb`` says whether the
    layer takes edge embeddings (then ``res`` reads 2·latent channels); the
    JAX layer infers that from its first call. The JAX layer's ``residual``
    and ``dropout`` options, which m_GCN never changes, are not ported."""

    def __init__(self, latent_dim: int, edge_emb: bool = True, use_bias: bool = False,
                 num_layers: int = 2, eps: float = 1e-7):
        super().__init__()
        d = latent_dim
        self.latent_dim, self.edge_emb, self.eps = d, edge_emb, eps
        self.res = nn.Linear(2 * d if edge_emb else d, d, bias=use_bias)
        self.mlp = MLP(d, tuple([2 * d] * (num_layers - 1) + [d]), use_bias=use_bias)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        torch_linear_(self.res.weight, self.res.in_features, generator)
        if self.res.bias is not None:
            nn.init.zeros_(self.res.bias)
        self.mlp.reset_parameters(generator)

    def forward(self, x: torch.Tensor, graph: BatchedGraph, edge_emb: Optional[torch.Tensor],
                mlp: bool = True) -> torch.Tensor:
        if (edge_emb is not None) != self.edge_emb:
            raise ValueError(f"GENConv built with edge_emb={self.edge_emb} got "
                             f"{'no ' if edge_emb is None else ''}edge embeddings")
        edges = graph.edges
        x_src = segment.gather_src(x, edges, graph.axis_name)
        if edge_emb is not None:
            e = edge_emb + torch.abs(x_src - segment.gather(x, edges))
            msg = torch.cat([x_src, e], dim=-1)
        else:
            msg = x_src
        msg = F.selu(msg) + self.eps
        if graph.edge_mask is not None:
            msg = torch.where(graph.edge_mask[:, None], msg, 0.0)
        latent = segment.segment_sum(msg, edges)
        latent = (self.res(latent) if mlp else torch.tanh(self.res(latent))) + x
        return self.mlp(latent) if mlp else latent
