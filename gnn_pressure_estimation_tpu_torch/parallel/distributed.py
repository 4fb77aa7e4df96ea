"""Distributed training step: data-parallel × edge-partitioned.

The counterpart of ``gnn_pressure_estimation_tpu/parallel/distributed.py``,
over a ``parallel.mesh.Mesh`` of ranks:

- the snapshots are split over the data group; within a shard the node
  dimension of the disjoint-union batch is split over the graph group in
  contiguous blocks (``parallel/edgepart.py``);
- every message-passing layer all-gathers the graph group's node blocks
  (``ops.segment``, the edge-list path; no kernel), and the all-gather's
  backward sums each block's cotangent back to its rank;
- the loss is the rank's local masked sums over the global masked count,
  and the gradients are summed over both groups; the metrics come from the
  masked moments, summed the same way (one all-reduce a step);
- Adam (with the ``Trainer``'s L2 weight decay and optional AutoClip) runs
  replicated, so every rank's parameters stay bit-identical.

mse and mae only, as the JAX ``_dist_criterion`` allows.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from gnn_pressure_estimation_tpu_torch.core.graph import GraphTemplate
from gnn_pressure_estimation_tpu_torch.parallel.edgepart import partition_graph
from gnn_pressure_estimation_tpu_torch.parallel.mesh import Mesh
from gnn_pressure_estimation_tpu_torch.parallel.trainer import (
    broadcast_module_, masked_loss_sum, metrics_of, moments_of, sum_step,
)
from gnn_pressure_estimation_tpu_torch.train.autoclip import AutoClip
from gnn_pressure_estimation_tpu_torch.train.loop import TrainConfig
from gnn_pressure_estimation_tpu_torch.utils.masking import batch_node_mask
from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats


def _dist_criterion(name: str) -> str:
    if name not in ("mse", "mae"):
        raise KeyError(f"distributed criterion {name!r} unsupported (mse|mae)")
    return name


def make_distributed_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                                mesh: Mesh, template: GraphTemplate, batch_per_shard: int,
                                mask_rate: float, stats: NormStats, criterion: str,
                                autoclip: Optional[AutoClip] = None):
    """Returns ``(step, pack, part)``.

    ``step(batch [dp·B, n], mask=None, generator=None) -> (loss, metrics)``
    updates ``model`` in place through ``optimizer``; the global mask
    [dp·B·n] is given or drawn from ``generator`` (the same on every rank).
    ``pack(a [dp·B, n])`` gives this rank's block of the packed node vector
    [block, 1] on the mesh's device."""
    dp, gp = mesh.dp, mesh.gp
    n, B = template.n_node, batch_per_shard
    part = partition_graph(template, B, gp)
    block = part.block
    n_pad_shard = gp * block
    graph = part.local_graph(mesh.g, mesh)
    criterion = _dist_criterion(criterion)

    def pack(batch, dtype=np.float32) -> torch.Tensor:
        batch = np.asarray(batch)
        if batch.shape != (dp * B, n):
            raise ValueError(f"batch {batch.shape} is not {(dp * B, n)}")
        flat = np.zeros((dp, n_pad_shard), dtype)
        flat[:, :B * n] = batch.reshape(dp, B * n)
        own = flat[mesh.d, mesh.g * block:(mesh.g + 1) * block]
        return torch.as_tensor(np.ascontiguousarray(own).reshape(-1, 1), device=mesh.device)

    def step(batch, mask=None, generator: Optional[torch.Generator] = None):
        batch = np.asarray(batch, np.float32)
        if mask is None:
            mask = batch_node_mask(generator, dp * B, n, mask_rate)
        mask = np.asarray(torch.as_tensor(np.asarray(mask)).cpu()).astype(bool)
        cnt = max(float(mask.sum()), 1.0)
        x = pack(batch)
        mk = pack(mask.reshape(dp * B, n), dtype=bool)[:, 0]
        mask_f = mk.to(torch.float32)[:, None]
        model.train()
        optimizer.zero_grad(set_to_none=True)
        out = model(torch.where(mk[:, None], 0.0, x), graph)
        loss = masked_loss_sum(criterion, out, x, mask_f) / cnt
        loss.backward()
        with torch.no_grad():
            mo = moments_of(out, x, mask_f, stats)
        params = [p for p in model.parameters() if p.grad is not None]
        loss, mo = sum_step(mesh, params, loss, mo)
        if autoclip is not None:
            autoclip.clip_(params)
        optimizer.step()
        return loss, metrics_of(mo, "train")

    return step, pack, part


class DistributedTrainer:
    """Mesh-parallel counterpart of ``train.loop.Trainer`` on the
    edge-partitioned path (same config). ``model`` arrives initialised;
    rank 0's weights are broadcast to every rank."""

    def __init__(self, model: torch.nn.Module, cfg: TrainConfig, stats: NormStats,
                 template: GraphTemplate, mesh: Mesh):
        if not isinstance(mesh, Mesh):
            raise TypeError("DistributedTrainer takes a parallel.mesh.Mesh (make_mesh)")
        if cfg.batch_size % mesh.dp:
            raise ValueError(f"batch_size {cfg.batch_size} not divisible by data axis {mesh.dp}")
        self.model = model.to(mesh.device)
        self.cfg, self.stats, self.mesh, self.template = cfg, stats, mesh, template
        self.batch_per_shard = cfg.batch_size // mesh.dp
        broadcast_module_(mesh, self.model)
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=cfg.lr, betas=(0.9, 0.999),
                                          eps=1e-8, weight_decay=cfg.weight_decay)
        self.autoclip = (AutoClip(cfg.clip_percentile, device=mesh.device)
                         if cfg.use_gradient_clipping else None)
        self.step, self.pack, self.part = make_distributed_train_step(
            self.model, self.optimizer, mesh, template, self.batch_per_shard, cfg.mask_rate,
            stats, _dist_criterion(cfg.criterion), self.autoclip)

    def train_epoch(self, snapshots: np.ndarray, rng: np.random.Generator,
                    log_fn: Callable[[str], None] = lambda *_: None):
        """``snapshots`` [S, n] scaled; iterates the full dp·B batches in the
        order ``rng`` permutes them, one mask generator a batch seeded from
        it. Returns (mean loss, last batch's metrics)."""
        dpB = self.cfg.batch_size
        order = rng.permutation(len(snapshots))
        losses, last = [], {}
        for s in range(0, len(order) - dpB + 1, dpB):
            gen = torch.Generator().manual_seed(int(rng.integers(0, 2**31 - 1)))
            loss, last = self.step(snapshots[order[s:s + dpB]], generator=gen)
            losses.append(float(loss))
        return (float(np.mean(losses)) if losses else math.nan,
                {k: float(v) for k, v in last.items()})
