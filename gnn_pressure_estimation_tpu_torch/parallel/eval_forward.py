"""The forward pass of evaluation over a ``dp × gp`` mesh of ranks.

The counterpart of ``gnn_pressure_estimation_tpu/parallel/eval_forward.py``.
The ``Evaluator``'s per-trial forwards take ``MeshTrainer``'s two
strategies without its optimizer:

- **graphs** (small templates): each rank runs its share of the batch's
  graphs, ``bs / (dp·gp)`` rounded up (zero graphs pad the last shares);
- **halo** (banded or large templates): the RCM band's block rows are cut
  over the graph group and the batch over the data group, each layer
  exchanging only its halo rows (``parallel/halo.py``).

``make_mesh_forward`` returns ``(fwd, adapter)``: ``fwd(x_in)`` takes the
whole batch on every rank (``[bs·n, C]``, or in the halo strategy the
adapter's packed ``[bs_pad·n_pad_dist, C]``) and returns the whole output,
gathered from every rank, the same on all of them; ``adapter`` has the
``BatchedGraph`` interface the harness drives (``banded``, ``pack_nodes``,
``unpack_nodes``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gnn_pressure_estimation_tpu_torch.core.graph import GraphTemplate
from gnn_pressure_estimation_tpu_torch.parallel.halo import build_halo_partition
from gnn_pressure_estimation_tpu_torch.parallel.mesh import Mesh


class _HaloAdapter:
    """``BatchedGraph``-like pack / unpack into the distributed band space
    ([bs·n, C] original order ↔ [bs_pad·n_pad_dist, C] band order)."""

    banded = True

    def __init__(self, part, bs: int, dp: int, n: int, device):
        self.part = part
        self.bs = bs
        self.bs_pad = -(-bs // dp) * dp
        self.n = n
        self.perm = torch.as_tensor(part.perm, dtype=torch.long, device=device)
        self.inv_perm = torch.as_tensor(np.argsort(part.perm), dtype=torch.long, device=device)
        self.n_pad_dist = part.n_pad_dist

    def pack_nodes(self, x_flat: torch.Tensor, n_orig: int) -> torch.Tensor:
        xb = x_flat.reshape(self.bs, n_orig, -1)[:, self.perm]
        out = xb.new_zeros((self.bs_pad, self.n_pad_dist, xb.shape[-1]))
        out[:self.bs, :n_orig] = xb
        return out.reshape(self.bs_pad * self.n_pad_dist, -1)

    def unpack_nodes(self, x_flat: torch.Tensor, n_orig: int) -> torch.Tensor:
        xb = x_flat.reshape(self.bs_pad, self.n_pad_dist, -1)[:self.bs]
        return xb[:, self.inv_perm].reshape(self.bs * n_orig, -1)


def make_mesh_forward(model: torch.nn.Module, template: GraphTemplate, bs: int, mesh: Mesh,
                      agg_mode: Optional[str] = None, band_block: Optional[int] = None):
    """``(fwd, graph_or_adapter)`` over ``mesh``; the strategy as
    ``MeshTrainer``'s: halo for banded or large templates (the chunks'
    band-attention route by ``band_attention_route``), whole-graph shares
    otherwise."""
    dp, gp, rank = mesh.dp, mesh.gp, mesh.rank
    large = template.n_node > GraphTemplate.DENSE_THRESHOLD
    halo = agg_mode == "banded" or (agg_mode is None and large)
    n = template.n_node

    if not halo:
        R = dp * gp
        bl = -(-bs // R)
        graph = template.batch(bl, mode=agg_mode, band_block=band_block, device=mesh.device)

        def fwd(x_in: torch.Tensor) -> torch.Tensor:
            xg = x_in.reshape(bs, n, -1)
            xp = xg.new_zeros((bl * R, n, xg.shape[-1]))
            xp[:bs] = xg
            out = model(xp[rank * bl:(rank + 1) * bl].reshape(bl * n, -1), graph)
            full = mesh.gather_blocks(out.contiguous(), "world")
            return full.reshape(bl * R, n, -1)[:bs].reshape(bs * n, -1)
        return fwd, graph

    part = build_halo_partition(template, gp, band_block=band_block)
    adapter = _HaloAdapter(part, bs, dp, n, mesh.device)
    B = adapter.bs_pad // dp
    graph = part.local_graph(mesh.g, B, mesh)

    def fwd(x_in: torch.Tensor) -> torch.Tensor:
        x3 = x_in.reshape(adapter.bs_pad, part.n_pad_dist, -1)
        own = x3[mesh.d * B:(mesh.d + 1) * B, mesh.g * part.chunk:(mesh.g + 1) * part.chunk]
        out = model(own.reshape(B * part.chunk, -1), graph)
        C = out.shape[-1]          # the model's own output width
        full = mesh.gather_blocks(out.contiguous(), "world")
        full = full.reshape(dp, gp, B, part.chunk, C).permute(0, 2, 1, 3, 4)
        return full.reshape(adapter.bs_pad * part.n_pad_dist, C)
    return fwd, adapter
