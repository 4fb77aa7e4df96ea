"""GATRes — the flagship masked-pressure-reconstruction model.

The counterpart of ``gnn_pressure_estimation_tpu/models/gatres.py``:

    lin0: Linear(1 → nc)
    num_blocks × GATResBlock:
        x0 = x
        x  = relu(GATConv(nc → nc, heads=2, concat))      # [N, 2nc]
        x  = GATConv(2nc → nc, heads=1)                   # [N, nc]
        x  = SimpleMeanConv(x) + x0
        x  = relu(x)
    lin1: Linear(nc → 1)        (no output sigmoid)

Parameter names follow the PyG reference (``blocks.i.conv1.lin.weight``,
``lin0.weight`` …); ``weights.py`` maps JAX parameter trees onto them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from gnn_pressure_estimation_tpu_torch.core.graph import BatchedGraph
from gnn_pressure_estimation_tpu_torch.models.layers import GATConv, SimpleMeanConv, glorot_


class GATResBlock(nn.Module):
    def __init__(self, channels: int, attn_impl: str = "softmax"):
        super().__init__()
        self.conv1 = GATConv(channels, channels, heads=2, concat=True, attn_impl=attn_impl)
        self.conv2 = GATConv(2 * channels, channels, heads=1, concat=False, attn_impl=attn_impl)
        self.mean = SimpleMeanConv()

    def forward(self, x: torch.Tensor, graph: BatchedGraph) -> torch.Tensor:
        x0 = x
        x = F.relu(self.conv1(x, graph))
        x = self.conv2(x, graph)
        x = self.mean(x, graph) + x0
        return F.relu(x)


class GATRes(nn.Module):
    """``forward(x[N, 1], graph) -> [N, 1]``; in banded mode ``x`` is in the
    graph's packed node space (``BatchedGraph.pack_nodes``)."""

    def __init__(self, num_blocks: int = 15, channels: int = 32,
                 out_channels: int = 1, in_channels: int = 1,
                 attn_impl: str = "softmax"):
        super().__init__()
        self.num_blocks, self.channels = num_blocks, channels
        self.lin0 = nn.Linear(in_channels, channels)
        self.blocks = nn.ModuleList(
            GATResBlock(channels, attn_impl=attn_impl) for _ in range(num_blocks)
        )
        self.lin1 = nn.Linear(channels, out_channels)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for lin in (self.lin0, self.lin1):
            glorot_(lin.weight, lin.in_features, lin.out_features, generator)
            nn.init.zeros_(lin.bias)
        for blk in self.blocks:
            blk.conv1.reset_parameters(generator)
            blk.conv2.reset_parameters(generator)

    def forward(self, x: torch.Tensor, graph: BatchedGraph) -> torch.Tensor:
        x = self.lin0(x)
        for blk in self.blocks:
            x = blk(x, graph)
        return self.lin1(x)
