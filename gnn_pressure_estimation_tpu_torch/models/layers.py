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


@torch.no_grad()
def torch_linear_(t: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """U(±1/√fan_in) in place: ``torch.nn.Linear``'s default weight bound,
    the JAX layers' ``torch_linear`` initialiser."""
    bound = 1.0 / math.sqrt(fan_in)
    return t.uniform_(-bound, bound, generator=generator)


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
    out = band_spmm(band, bops.extend_rows(xb, graph.band_U, graph.band_R), index)
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
    if graph.banded:
        return _band_agg(kind, x, graph)
    if graph.padded:
        if kind == "adj":
            return _padded_sum(x, graph)
        if kind == "mean":
            return _padded_sum(x, graph) * graph.inv_degree[:, None]
        if kind == "gcn":
            return _padded_weighted_agg(graph.gather_dp_sl, x, graph.gcn_dp_sl)
        return _padded_weighted_agg(graph.gather_dp, x, graph.cheb_dp)
    raise NotImplementedError("the segment aggregation mode is not yet ported")


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

    FLAX_NAMES = {"lin.weight": "w"}   # the projection is the flax module's leaf w

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
        x_src = segment.gather_src(x, edges)
        if edge_emb is not None:
            e = edge_emb + torch.abs(x_src - segment.gather(x, edges))
            msg = torch.cat([x_src, e], dim=-1)
        else:
            msg = x_src
        latent = segment.segment_sum(F.selu(msg) + self.eps, edges)
        latent = (self.res(latent) if mlp else torch.tanh(self.res(latent))) + x
        return self.mlp(latent) if mlp else latent
