"""Baseline model zoo: the counterparts of ``gnn_pressure_estimation_tpu/models/zoo.py``.

Every model has ``forward(x[N, 1], graph, training=False) -> [N, 1]``, the
signature the port's ``Trainer``, ``Inferencer`` and ``Evaluator`` call;
in banded mode ``x`` is in the graph's packed node space. ``training``
changes nothing: no model of the zoo sets a dropout. Only ``MGCN``
reads ``graph.edge_attr``. Weights are initialised as the JAX layers
initialise them (``reset_parameters(generator)``). Each class names its
parts as the flax model does in ``FLAX_NAMES`` (``weights.flax_names``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from gnn_pressure_estimation_tpu_torch.core.graph import BatchedGraph
from gnn_pressure_estimation_tpu_torch.models.layers import (
    ChebConv, GATConv, GCN2Conv, GENConv, GINConv, glorot_,
)


def _glorot_linear(lin: nn.Linear, generator: Optional[torch.Generator]):
    """A flax ``Dense`` with glorot kernel and zero bias."""
    glorot_(lin.weight, lin.in_features, lin.out_features, generator)
    if lin.bias is not None:
        nn.init.zeros_(lin.bias)


class _Zoo(nn.Module):
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Redraw every parameter as the JAX model's ``init`` draws its kind
        (not its values), from ``generator``: the model's own Linears are
        flax ``Dense`` layers with glorot kernels."""
        for child in self.children():
            for m in (child if isinstance(child, nn.ModuleList) else [child]):
                if isinstance(m, nn.Linear):
                    _glorot_linear(m, generator)
                else:
                    m.reset_parameters(generator)


class GIN(_Zoo):
    """GIN with SELU bottleneck MLPs and dim-matched residuals (the
    reference's GraphModels.py:233-260; preset 15 blocks, nc 32)."""

    FLAX_NAMES = {"convs": "GINConv_{}"}

    def __init__(self, num_blocks: int = 15, channels: int = 32, in_channels: int = 1,
                 out_channels: int = 1):
        super().__init__()
        nc, convs, width = channels, [], in_channels
        for i in range(num_blocks):
            conv = (GINConv(width, linear_out=out_channels) if i == num_blocks - 1
                    else GINConv(width, mlp_dims=(nc // 2, nc)))
            convs.append(conv)
            width = conv.out_channels
        self.convs = nn.ModuleList(convs)
        self.reset_parameters()

    def forward(self, x, graph: BatchedGraph, training: bool = False):
        for conv in self.convs:
            o, x = x, conv(x, graph)
            if x.shape[-1] == o.shape[-1]:
                x = x + o
        return x


class GAT(_Zoo):
    """Plain stacked GAT (the reference's GraphModels.py:210-230; 10 blocks,
    nc 32, 2 heads concatenated, a last layer of 1 head), no activation
    between layers, as in the JAX model. Each ``GATConv`` takes the
    kernels of its mode at any width; in the JAX model the banded layers,
    narrower than 128 lanes, run plain XLA."""

    FLAX_NAMES = {"convs": "GATConv_{}"}

    def __init__(self, num_blocks: int = 10, channels: int = 32, out_channels: int = 1,
                 in_channels: int = 1):
        super().__init__()
        convs, width = [], in_channels
        for i in range(num_blocks):
            last = i == num_blocks - 1
            convs.append(GATConv(width, out_channels if last else channels,
                                 heads=1 if last else 2, concat=True))
            width = 2 * channels
        self.convs = nn.ModuleList(convs)
        self.reset_parameters()

    def forward(self, x, graph: BatchedGraph, training: bool = False):
        for conv in self.convs:
            x = conv(x, graph)
        return x


class GCN2(_Zoo):
    """GCNII stack with the initial residual to the stem's output (the
    reference's GraphModels.py:188-208; 64 layers, nc 32, α 0.1, θ 0.5)."""

    FLAX_NAMES = {"convs": "GCN2Conv_{}"}

    def __init__(self, num_blocks: int = 64, channels: int = 32, out_channels: int = 1,
                 in_channels: int = 1):
        super().__init__()
        self.stem = nn.Linear(in_channels, channels)
        self.convs = nn.ModuleList(GCN2Conv(channels, alpha=0.1, theta=0.5, layer_index=i + 1)
                                   for i in range(num_blocks))
        self.lin = nn.Linear(channels, out_channels)
        self.reset_parameters()

    def forward(self, x, graph: BatchedGraph, training: bool = False):
        x = x0 = self.stem(x)
        for conv in self.convs:
            x = conv(x, x0, graph)
        return self.lin(x)


class _ChebStack(_Zoo):
    """Three ChebConvs with SiLU between, and a bias-free last one."""

    FLAX_NAMES = {"convs": "ChebConv_{}"}

    def __init__(self, in_channels: int, channels: tuple, ks: tuple, out_channels: int):
        super().__init__()
        widths = (in_channels,) + tuple(channels) + (out_channels,)
        self.convs = nn.ModuleList(
            ChebConv(widths[i], widths[i + 1], K=ks[i], use_bias=i < 3) for i in range(4))
        self.reset_parameters()

    def forward(self, x, graph: BatchedGraph, training: bool = False):
        for conv in self.convs[:3]:
            x = F.silu(conv(x, graph))
        return self.convs[3](x, graph)


class ChebNet(_ChebStack):
    """Tuned Chebyshev baseline (the reference's GraphModels.py:170-184):
    K 24/12/10/1, nc channels."""

    def __init__(self, channels: int = 32, out_channels: int = 1, ks: tuple = (24, 12, 10, 1),
                 in_channels: int = 1):
        super().__init__(in_channels, (channels,) * 3, ks, out_channels)


class GraphConvWat(_ChebStack):
    """GraphConvWat (the reference's GraphModels.py:154-168): ChebConv
    120/60/30 with K 240/120/20, SiLU, a bias-free K 1 head."""

    def __init__(self, out_channels: int = 1, channels: tuple = (120, 60, 30),
                 ks: tuple = (240, 120, 20, 1), in_channels: int = 1):
        super().__init__(in_channels, channels, ks, out_channels)


class MGCN(_Zoo):
    """m_GCN (the reference's GraphModels.py:399-449): node_in → n_aggr ×
    GENConv (SELU after each pass; n_hops − 1 passes without the MLP, then
    one with it, all through one conv's weights) → node_out. The only model
    that reads edge features (diameter, length): with ``edge_dim`` > 0 (the
    number of edge attributes, which the JAX model infers from the graph)
    it embeds ``graph.edge_attr`` and raises on a graph without them."""

    FLAX_NAMES = {"gcn": "gcn_{}"}

    def __init__(self, latent_dim: int = 96, n_aggr: int = 45, n_hops: int = 1,
                 num_layers: int = 2, edge_dim: int = 2, out_channels: int = 1,
                 use_bias: bool = False, with_sigmoid: bool = False, in_channels: int = 1):
        super().__init__()
        d = latent_dim
        self.n_hops, self.with_sigmoid = n_hops, with_sigmoid
        self.edge = nn.Linear(edge_dim, d, bias=use_bias) if edge_dim > 0 else None
        self.node_in = nn.Linear(in_channels, d, bias=use_bias)
        self.gcn = nn.ModuleList(GENConv(d, edge_emb=edge_dim > 0, use_bias=use_bias,
                                         num_layers=num_layers) for _ in range(n_aggr))
        self.node_out = nn.Linear(d, out_channels, bias=use_bias)
        self.reset_parameters()

    def forward(self, x, graph: BatchedGraph, training: bool = False):
        edge_emb = None
        if self.edge is not None:
            if graph.edge_attr is None:
                raise ValueError("MGCN with edge_dim > 0 needs a graph with edge attributes "
                                 "(a dataset built with edge_attrs)")
            edge_emb = self.edge(graph.edge_attr)
        z = self.node_in(x)
        for gen in self.gcn:
            for _ in range(self.n_hops - 1):
                z = F.selu(gen(z, graph, edge_emb, mlp=False))
            z = F.selu(gen(z, graph, edge_emb, mlp=True))
        y = self.node_out(z)
        return torch.sigmoid(y) if self.with_sigmoid else y
