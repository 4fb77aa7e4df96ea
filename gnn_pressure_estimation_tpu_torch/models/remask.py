"""Masked-token GATRes variants: the counterparts of
``gnn_pressure_estimation_tpu/models/remask.py`` (the reference's
GraphModels.py:498-605).

Unlike the zoo they take the batch mask explicitly,
``forward(x, graph, batch_mask, training=False)``: unmasked nodes are
encoded from their values, masked nodes carry a zero or learned token. As in
the JAX package they are not in the model registry; callers build them
directly. ``batch_mask`` is [N] bool in the graph's node space (packed, in
banded mode, where the pad rows count as unmasked, as in the JAX models).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from gnn_pressure_estimation_tpu_torch.core.graph import BatchedGraph
from gnn_pressure_estimation_tpu_torch.models.gatres import GATResBlock
from gnn_pressure_estimation_tpu_torch.models.layers import GATConv, GCNConv, glorot_


class _Remask(nn.Module):
    FLAX_NAMES = {"blocks": "block_{}"}

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for lin in (self.encoder, self.decoder):
            glorot_(lin.weight, lin.in_features, lin.out_features, generator)
            nn.init.zeros_(lin.bias)
        for m in self.modules():
            if isinstance(m, (GATConv, GCNConv)):
                m.reset_parameters(generator)


class GATResRemask(_Remask):
    """GATResMeanConvWithRemask (GraphModels.py:498-539): only unmasked nodes
    are encoded; masked nodes start from their (zeroed) value broadcast over
    the channels."""

    def __init__(self, num_blocks: int = 15, channels: int = 32, out_channels: int = 1,
                 in_channels: int = 1):
        super().__init__()
        self.channels = channels
        self.encoder = nn.Linear(in_channels, channels)
        self.blocks = nn.ModuleList(GATResBlock(channels) for _ in range(num_blocks))
        self.decoder = nn.Linear(channels, out_channels)
        self.reset_parameters()

    def forward(self, x, graph: BatchedGraph, batch_mask, training: bool = False):
        x = torch.where(batch_mask[:, None], x.repeat(1, self.channels), self.encoder(x))
        for blk in self.blocks:
            x = blk(x, graph)
        return self.decoder(x)


class GATResBlockNoMean(nn.Module):
    """GResBlockConv (GraphModels.py:548-561): the residual GAT block
    without the mean conv."""

    FLAX_NAMES = {"conv1": "GATConv_0", "conv2": "GATConv_1"}

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = GATConv(channels, channels, heads=2, concat=True)
        self.conv2 = GATConv(2 * channels, channels, heads=1, concat=False)

    def forward(self, x, graph: BatchedGraph):
        x0 = x
        x = F.relu(self.conv1(x, graph))
        return F.relu(self.conv2(x, graph) + x0)


class GATResRemaskStack(_Remask):
    """GATResMeanConvWithRemaskAndStack (GraphModels.py:563-605): a GCN stem
    (the plain neighbour sum) plus the mean of the unmasked encodings,
    pooled over the whole batch, on every node; blocks without the mean
    conv. The frozen mask token is a buffer of zeros (not saved in the
    ``state_dict``; the JAX model keeps it in a ``constants`` collection and
    never reads it)."""

    def __init__(self, num_blocks: int = 15, channels: int = 32, out_channels: int = 1,
                 in_channels: int = 1):
        super().__init__()
        self.encoder = nn.Linear(in_channels, channels)
        self.register_buffer("mask_token", torch.zeros(1, channels), persistent=False)
        self.stem = GCNConv(in_channels, channels, normalize=False)
        self.blocks = nn.ModuleList(GATResBlockNoMean(channels) for _ in range(num_blocks))
        self.decoder = nn.Linear(channels, out_channels)
        self.reset_parameters()

    def forward(self, x, graph: BatchedGraph, batch_mask, training: bool = False):
        unmask = (~batch_mask).to(x.dtype)[:, None]
        enc = self.encoder(x)
        gap = (enc * unmask).sum(dim=0, keepdim=True) / unmask.sum().clamp(min=1.0)
        x = self.stem(x, graph) + gap
        for blk in self.blocks:
            x = blk(x, graph)
        return self.decoder(x)
