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
from torch.utils.checkpoint import checkpoint

from gnn_pressure_estimation_tpu_torch.core.graph import BatchedGraph
from gnn_pressure_estimation_tpu_torch.models.layers import GATConv, SimpleMeanConv, glorot_


class GATResBlock(nn.Module):
    FLAX_NAMES = {"conv1": "GATConv_0", "conv2": "GATConv_1"}

    def __init__(self, channels: int, attn_impl: str = "softmax", attn_dtype=None,
                 gate_dtype=None, dtype=None):
        super().__init__()
        knobs = dict(attn_impl=attn_impl, attn_dtype=attn_dtype, gate_dtype=gate_dtype,
                     dtype=dtype)
        self.conv1 = GATConv(channels, channels, heads=2, concat=True, **knobs)
        self.conv2 = GATConv(2 * channels, channels, heads=1, concat=False, **knobs)
        self.mean = SimpleMeanConv()

    def forward(self, x: torch.Tensor, graph: BatchedGraph) -> torch.Tensor:
        x0 = x
        x = F.relu(self.conv1(x, graph))
        x = self.conv2(x, graph)
        x = self.mean(x, graph) + x0
        return F.relu(x)


class GATRes(nn.Module):
    """``forward(x[N, 1], graph, training=False) -> [N, 1]``; in banded mode
    ``x`` is in the graph's packed node space (``BatchedGraph.pack_nodes``).

    ``remat=True`` wraps each block in ``torch.utils.checkpoint``: the
    backward recomputes the block's forward instead of keeping its
    activations, trading a second pass through the kernels for memory.
    ``training`` is accepted as in the JAX model and changes nothing: GATRes
    has no dropout or batch statistics. ``attn_impl``, ``attn_dtype`` and
    ``gate_dtype`` go to every ``GATConv`` (``models.presets.apply_model_knobs``
    sets them on a built model), and so does ``dtype``, the activation dtype
    (None = f32, or ``torch.bfloat16``; ``models.presets.select_model(...,
    dtype=)`` sets it): as in the JAX model only the GATConvs compute in it,
    each returning f32, and the parameters, the mean, the residual, the
    ReLUs and the two linear layers stay f32."""

    FLAX_NAMES = {"blocks": "block_{}"}

    def __init__(self, num_blocks: int = 15, channels: int = 32,
                 out_channels: int = 1, in_channels: int = 1,
                 attn_impl: str = "softmax", remat: bool = False, attn_dtype=None,
                 gate_dtype=None, dtype=None):
        super().__init__()
        self.num_blocks, self.channels, self.remat = num_blocks, channels, remat
        self.attn_impl, self.attn_dtype, self.gate_dtype = attn_impl, attn_dtype, gate_dtype
        self.dtype = dtype
        self.lin0 = nn.Linear(in_channels, channels)
        self.blocks = nn.ModuleList(
            GATResBlock(channels, attn_impl=attn_impl, attn_dtype=attn_dtype,
                        gate_dtype=gate_dtype, dtype=dtype) for _ in range(num_blocks)
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

    def forward(self, x: torch.Tensor, graph: BatchedGraph,
                training: bool = False) -> torch.Tensor:
        x = self.lin0(x)
        for blk in self.blocks:
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(blk, x, graph, use_reentrant=False)
            else:
                x = blk(x, graph)
        return self.lin1(x)
