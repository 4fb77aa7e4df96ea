"""Graph conv layers of GATRes as torch modules.

The counterparts of ``GATConv`` and ``SimpleMeanConv`` in
``gnn_pressure_estimation_tpu/models/layers.py``, in the dense, banded and
degree-padded aggregation modes. Attention math matches PyG GATConv
(LeakyReLU 0.2, self-loops added, per-receiver softmax).

On the banded path every GATConv goes through one of the four routes of
``ops.band_attention`` (the graph's ``band_attn``) and every SimpleMeanConv
through ``ops.band_spmm``; on the dense path a GATConv
goes through ``ops.graph_attention`` (``fused_factored`` or
``fused_attention``, by ``attn_impl``), at any width and any n: autograd
Functions that launch the hand-written kernels, forward and backward, when
the graph lies on a CUDA device, and run the kernels' plain versions on the
CPU. The graph carries the compressed index of each mask or band that the
kernels walk. The dense SimpleMeanConv is one ``torch.einsum`` with the
``[n, n]`` mean operator, as in the JAX layer. The padded path gathers
neighbour slots with ``ops.padded`` and reduces over them in plain torch, as
the JAX layer does in plain XLA.

Parameters are initialised glorot-uniform (weights) and zero (biases), as
the JAX layers do, from an optional ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from gnn_pressure_estimation_tpu_torch.core.graph import BatchedGraph
from gnn_pressure_estimation_tpu_torch.ops import banded as bops
from gnn_pressure_estimation_tpu_torch.ops.band_attention import (
    band_attention, band_attention_acc, band_attention_flash, band_attention_window, round_bf16,
)
from gnn_pressure_estimation_tpu_torch.ops.band_spmm import band_spmm
from gnn_pressure_estimation_tpu_torch.ops.graph_attention import fused_attention, fused_factored

ATTN_IMPLS = ("softmax", "onepass", "factored")
# attn_dtype / gate_dtype values: None (f32), or a dtype the JAX layer accepts
ATTN_DTYPES = (None, torch.float32, torch.bfloat16)
NEG_INF = -1e9  # the masked logit of the padded path, as the JAX layer's
BAND_ATTEND = {"dma": band_attention, "flash": band_attention_flash, "acc": band_attention_acc}


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
    Function, in bf16 under ``attn_dtype`` bf16. The JAX layer's
    ``band_factored`` is not ported. The padded path gathers each node's
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
    """

    def __init__(self, in_channels: int, out_channels: int, heads: int = 1,
                 concat: bool = True, negative_slope: float = 0.2,
                 attn_impl: str = "softmax", attn_dtype=None, gate_dtype=None):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise NotImplementedError(f"attn_impl {attn_impl!r} is not yet ported")
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

    def forward(self, x: torch.Tensor, graph: BatchedGraph) -> torch.Tensor:
        H, C = self.heads, self.out_channels
        xp = self.lin(x).view(-1, H, C)
        # per-node attention logit halves (a_s/a_d are rank-1 per head)
        a_s = (xp * self.att_src).sum(-1)                      # [N, H]
        a_d = (xp * self.att_dst).sum(-1)
        B = graph.n_graph
        if graph.dense:
            out = self._dense(xp.view(B, -1, H, C), a_s.view(B, -1, H), a_d.view(B, -1, H), graph)
        elif graph.banded:
            n_pad = graph.band_n_pad
            a_src_win = bops.band_windows(a_s.view(B, n_pad, H),
                                          graph.band_win_start, graph.band_W)
            xp_b = xp.view(B, n_pad, H, C)
            if graph.band_attn == "window":
                attend, kw = band_attention_window, {}
                x_in = bops.band_windows(xp_b, graph.band_win_start, graph.band_W)
            else:
                # the Function extends the projected rows itself: in bf16 for the
                # bf16-operand instances, which run where the JAX layer takes its
                # v2-family kernel
                attend, x_in = BAND_ATTEND[graph.band_attn], xp_b
                kw = {"halo": (graph.band_U, graph.band_R), "mxu_bf16": (
                    self.attn_dtype == torch.bfloat16 and self.negative_slope == 0.2
                    and H * C % 128 == 0)}
            out = attend(a_d.view(B, n_pad, H).contiguous(), a_src_win, x_in,
                         graph.band_adj_mask, self.negative_slope, graph.band_adj_index, **kw)
        elif graph.padded:
            # per-node neighbour slots (in-edges, then the self-loop), masked
            # softmax over the slots
            sl = self.negative_slope
            logits = graph.gather_dp_sl(a_s) + a_d[:, None, :]                  # [N, D+1, H]
            logits = torch.where(logits >= 0, logits, sl * logits)
            logits = torch.where(graph.mask_dp_sl[..., None], logits,
                                 torch.full((), NEG_INF, dtype=logits.dtype, device=logits.device))
            attn = torch.softmax(logits, dim=1)
            out = torch.einsum("ndh,ndhc->nhc", attn, graph.gather_dp_sl(xp))
        else:
            raise NotImplementedError("the segment aggregation mode is not yet ported")
        out = out.reshape(-1, H, C)
        out = out.reshape(-1, H * C) if self.concat else out.mean(dim=1)
        return out + self.bias

    def _dense(self, xp_b, a_s, a_d, graph):
        """Dense masked attention over all pairs: [B, n, H, C] → [B, n, H, C]."""
        sl = self.negative_slope
        mask, index = graph.adj_sl_mask, graph.adj_sl_index
        bf16 = self.attn_dtype == torch.bfloat16
        store = round_bf16 if bf16 else (lambda t: t)
        if self.attn_impl == "softmax":
            return fused_attention(a_d, a_s, xp_b, mask, sl, index, bf16)
        C = xp_b.shape[-1]
        with torch.no_grad():
            # the row max of the logits from the sender halves alone: LeakyReLU
            # is monotone, so max_j lrelu(a_d[i] + a_s[j]) = lrelu(a_d[i] +
            # max_{j∈N(i)} a_s[j]). A shift only (softmax is shift-invariant),
            # so it carries no gradient. Taken over each row's neighbour list
            # (padded with the row itself, which is always a neighbour).
            ms = a_s[:, index.nbr].amax(dim=2)                             # [B,i,H]
            m = F.leaky_relu(a_d + ms, sl)
        if self.attn_impl == "onepass":
            # the softmax numerator, materialised once; 1/Z after the product
            z = a_d[:, :, None, :] + a_s[:, None, :, :]                    # [B,i,j,H]
            y = torch.where(z >= 0, z, sl * z)
            num = store(torch.where(mask[None, :, :, None], torch.exp(y - m[:, :, None, :]), 0.0))
            out = torch.einsum("bijh,bjhc->bihc", num, store(xp_b))
            return out / num.sum(dim=2)[..., None]
        # factored: exp(lrelu(a_d+a_s)) = [s≥0]·e^{a_d}e^{a_s} + [s<0]·e^{αa_d}e^{αa_s}.
        # Working range: the exps of the per-node halves must stay finite in
        # f32 (|a| ≲ 80 after the shifts), as for the JAX layer.
        with torch.no_grad():
            cs = F.relu(a_s.amax(dim=1, keepdim=True))                   # [B,1,H]
        u, p = torch.exp(a_d - m), torch.exp(sl * a_d - m)                 # [B,i,H]
        v, q = torch.exp(a_s - cs), torch.exp(sl * a_s - cs)               # [B,j,H]
        # a ones column carries the softmax denominator through the sums; bf16:
        # both operands stored in bf16, that column included, as the JAX layer
        # stores them (its products are exact in f32, only the sums' order differs)
        xa = torch.cat([xp_b, xp_b.new_ones(xp_b.shape[:-1] + (1,))], dim=-1)
        t_pv, t_nq = fused_factored(a_d, a_s, store(v[..., None] * xa), store(q[..., None] * xa),
                                    mask, index)
        outz = u[..., None] * t_pv + p[..., None] * t_nq
        return outz[..., :C] / outz[..., C:]


class SimpleMeanConv(nn.Module):
    """Parameter-free neighbor mean, PyG ``SimpleConv(aggr='mean')``: no
    self-loops, mean over in-neighbors. Banded mode sums over the int8
    edge-count band and scales the rows by 1/deg afterwards; padded mode sums
    the valid in-edge slots and scales by 1/deg."""

    def forward(self, x: torch.Tensor, graph: BatchedGraph) -> torch.Tensor:
        B = graph.n_graph
        if graph.dense:
            out = torch.einsum("ij,bjc->bic", graph.mean_mat, x.view(B, graph.nodes_per_graph, -1))
        elif graph.banded:
            x_ext = bops.extend_rows(x.view(B, graph.band_n_pad, -1), graph.band_U, graph.band_R)
            out = band_spmm(graph.band_cnt, x_ext, graph.band_cnt_index) \
                * graph.band_inv_deg[None, :, None]
        elif graph.padded:
            nbr = graph.gather_dp(x)                                            # [N, D, C]
            out = torch.where(graph.mask_dp[..., None], nbr, 0.0).sum(dim=1) \
                * graph.inv_degree[:, None]
        else:
            raise NotImplementedError("the segment aggregation mode is not yet ported")
        return out.reshape(B * graph.nodes_per_graph, -1)
