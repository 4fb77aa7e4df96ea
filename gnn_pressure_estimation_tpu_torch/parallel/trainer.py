"""MeshTrainer: the full ``Trainer`` (fit, evaluation epochs, checkpoints,
early stopping, scheduler, AutoClip) over a ``dp × gp`` mesh of ranks.

The counterpart of ``gnn_pressure_estimation_tpu/parallel/trainer.py``. Two
partition strategies, chosen per template (``_strategy_for``):

- **graphs** (templates of at most ``GraphTemplate.DENSE_THRESHOLD``
  nodes): each rank owns whole graphs of the batch, ``bs / (dp·gp)`` of
  them, and runs the single-device layers (the dense kernels) on them;
  one gradient sum a step.
- **halo** (larger templates): the RCM band's block rows are cut over the
  graph group (``parallel.halo``) and the batch over the data group; every
  layer exchanges only its U / R halo rows with the neighbouring ranks and
  runs the band kernels on its chunk.

Both strategies override only the step (``train_step``, ``eval_step``), so
``fit``, AutoClip, the scheduler, early stopping and checkpoints are the
single-device ``Trainer``'s. Every rank runs the same loader and draws the
same global mask from the same seeded generator, and takes its shard.

- The loss is the rank's *local* masked sums over the *global* masked
  count; the gradients are then **summed** over both groups (not averaged:
  the ranks hold different masked counts). One all-reduce a step carries
  the gradients, the loss and the masked moments the metrics come from.
- Parameters are broadcast from rank 0 at construction; after every step
  the ranks' parameters, Adam state and AutoClip history are bit-identical
  (they apply the same summed gradients).
- A batch the data group (graphs: the whole mesh) does not divide is padded
  with all-false masks, which the global count ignores.
- Rank 0 writes the checkpoints and the log; a resume reads the same file on
  every rank.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from gnn_pressure_estimation_tpu_torch.core.graph import GraphTemplate
from gnn_pressure_estimation_tpu_torch.parallel.halo import build_halo_partition
from gnn_pressure_estimation_tpu_torch.parallel.mesh import Mesh
from gnn_pressure_estimation_tpu_torch.train.loop import Trainer, TrainConfig, _global_norm
from gnn_pressure_estimation_tpu_torch.train.precision import matmul_precision
from gnn_pressure_estimation_tpu_torch.utils import metrics as metrics_mod
from gnn_pressure_estimation_tpu_torch.utils.masking import batch_node_mask
from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats, descale_with

MOMENTS = ("count", "sum_p", "sum_t", "sum_pp", "sum_tt", "sum_pt", "sum_abs_err", "sum_sq_err",
           "sum_rel", "count_rel", "sum_acc")


def masked_loss_sum(criterion: str, out: torch.Tensor, y: torch.Tensor,
                    mask_f: torch.Tensor) -> torch.Tensor:
    """Σ over the masked rows of the criterion's per-row term (``mask_f``
    [N, 1] 0/1): mse (out − y)², mae |out − y|, sce (1 − cos(out, y))³. The
    loss is this over the global masked count."""
    if criterion == "mse":
        diff = (out - y) * mask_f
        return torch.sum(diff * diff)
    if criterion == "mae":
        return torch.sum(torch.abs((out - y) * mask_f))
    if criterion == "sce":
        pn = out / torch.linalg.norm(out, dim=-1, keepdim=True).clamp(min=1e-12)
        tn = y / torch.linalg.norm(y, dim=-1, keepdim=True).clamp(min=1e-12)
        return torch.sum((1.0 - torch.sum(pn * tn, dim=-1)) ** 3 * mask_f[:, 0])
    raise KeyError(f"criterion {criterion!r} is not supported")


def moments_of(out: torch.Tensor, y: torch.Tensor, mask_f: torch.Tensor,
               stats: NormStats) -> torch.Tensor:
    """The masked moments of the descaled values, stacked in ``MOMENTS`` order."""
    mo = metrics_mod.masked_moments(descale_with(out, stats), descale_with(y, stats), mask_f)
    return torch.stack([mo[k] for k in MOMENTS])


def metrics_of(moments: torch.Tensor, prefix: str) -> dict:
    return metrics_mod.metrics_from_moments(dict(zip(MOMENTS, moments)), prefix)


def sum_step(mesh: Mesh, params, loss: torch.Tensor, moments: torch.Tensor):
    """One all-reduce over the world: every gradient of ``params`` (replaced
    in place by the sum), the loss and the moments. Returns (loss, moments)."""
    grads = [p.grad.reshape(-1) for p in params]
    flat = mesh.all_reduce(torch.cat(grads + [loss.detach().reshape(1).to(torch.float32),
                                              moments.to(torch.float32)]))
    k = 0
    for p in params:
        n = p.grad.numel()
        p.grad.copy_(flat[k:k + n].view_as(p.grad))
        k += n
    return flat[k], flat[k + 1:]


def broadcast_module_(mesh: Mesh, module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers on every rank (one broadcast)."""
    ts = [t for t in list(module.parameters()) + list(module.buffers())]
    if mesh.world == 1 or not ts:
        return
    with torch.no_grad():
        flat = mesh.broadcast_(torch.cat([t.reshape(-1).to(torch.float32) for t in ts]))
        k = 0
        for t in ts:
            t.copy_(flat[k:k + t.numel()].view_as(t).to(t.dtype))
            k += t.numel()


class MeshTrainer(Trainer):
    """The ``Trainer`` over a ``parallel.mesh.Mesh`` (see the module
    docstring). ``train_step`` / ``eval_step`` take the whole batch ``xb``
    [bs, n] on every rank, and the global mask (or a generator to draw it);
    ``eval_step`` returns the output gathered from every rank in original
    node order, [bs·n, 1], and the mask. ``epochs_per_dispatch`` above 1
    keeps the per-epoch path, as the JAX mesh trainer does."""

    supports_fast_fit = False

    def __init__(self, model, cfg: TrainConfig, stats: NormStats,
                 sample_template: GraphTemplate, mesh: Mesh, required_mask_idx: tuple = ()):
        if not isinstance(mesh, Mesh):
            raise TypeError("MeshTrainer takes a parallel.mesh.Mesh (make_mesh)")
        self.mesh = mesh
        self.dp, self.gp = mesh.dp, mesh.gp
        # the strategy is resolved per template (a multi-dataset loader mixes
        # sizes); ``strategy`` records the sample template's
        self._halo_parts: dict = {}
        self.strategy = self._strategy_for(sample_template)
        if self.strategy == "graphs" and cfg.batch_size % (self.dp * self.gp):
            raise ValueError(f"batch_size {cfg.batch_size} must divide over the "
                             f"{self.dp}x{self.gp} mesh (whole-graph shards)")
        if self.strategy == "halo" and cfg.batch_size % self.dp:
            raise ValueError(f"batch_size {cfg.batch_size} not divisible by data axis {self.dp}")
        super().__init__(model, cfg, stats, sample_template, required_mask_idx,
                         device=mesh.device)
        broadcast_module_(mesh, self.model)

    @staticmethod
    def _strategy_for(template: GraphTemplate) -> str:
        """Whole-graph shards for dense-path templates, block-row halo shards
        past the dense threshold."""
        return "halo" if template.n_node > GraphTemplate.DENSE_THRESHOLD else "graphs"

    def _halo_part(self, template: GraphTemplate):
        key = id(template)
        if key not in self._halo_parts:
            self._halo_parts[key] = build_halo_partition(
                template, self.gp, band_attn=self.cfg.band_attn, band_block=self.cfg.band_block)
        return self._halo_parts[key]

    # -- the rank's shard ---------------------------------------------------
    def _global_mask(self, bs, n, mask, generator, required):
        if mask is None:
            return batch_node_mask(generator, bs, n, self.cfg.mask_rate, required_idx=required)
        return torch.as_tensor(np.asarray(mask), dtype=torch.bool).reshape(-1).cpu()

    def _shard(self, template: GraphTemplate, xb: np.ndarray, mask: torch.Tensor):
        """The whole batch [bs, n] and mask [bs·n] → this rank's graph, x [N,
        1] and mask [N] in the graph's node space."""
        bs, n = xb.shape
        m = mask.numpy().reshape(bs, n)
        mesh, dev = self.mesh, self.device
        if self._strategy_for(template) == "graphs":
            R = self.dp * self.gp
            bl = -(-bs // R)
            xp = np.zeros((bl * R, n), np.float32)
            mp = np.zeros((bl * R, n), bool)
            xp[:bs], mp[:bs] = xb, m
            sl = slice(mesh.rank * bl, (mesh.rank + 1) * bl)
            graph = self._batched_graph(template, bl)
            x = torch.as_tensor(xp[sl].reshape(-1, 1), device=dev)
            mk = torch.as_tensor(mp[sl].reshape(-1), device=dev)
            if graph.banded:
                x = graph.pack_nodes(x, n)
                mk = graph.pack_nodes(mk.to(torch.float32)[:, None], n)[:, 0] > 0.5
            return graph, x, mk
        part = self._halo_part(template)
        B = -(-bs // self.dp)
        xp = np.zeros((B * self.dp, part.n_pad_dist), np.float32)
        mp = np.zeros((B * self.dp, part.n_pad_dist), bool)
        xp[:bs, :n], mp[:bs, :n] = xb[:, part.perm], m[:, part.perm]
        rows = slice(mesh.d * B, (mesh.d + 1) * B)
        cols = slice(mesh.g * part.chunk, (mesh.g + 1) * part.chunk)
        graph = part.local_graph(mesh.g, B, mesh)
        return (graph, torch.as_tensor(np.ascontiguousarray(xp[rows, cols]).reshape(-1, 1),
                                       device=dev),
                torch.as_tensor(np.ascontiguousarray(mp[rows, cols]).reshape(-1), device=dev))

    def _gather_out(self, template: GraphTemplate, graph, out: torch.Tensor, bs: int):
        """Every rank's output → [bs·n, C] in original node order."""
        n = template.n_node
        full = self.mesh.gather_blocks(out.detach().contiguous(), "world")
        C = out.shape[-1]
        if self._strategy_for(template) == "graphs":
            R = self.dp * self.gp
            if graph.banded:
                parts = full.reshape(R, -1, C)
                full = torch.cat([graph.unpack_nodes(p_, n) for p_ in parts])
            return full.reshape(-1, n, C)[:bs].reshape(-1, C)
        part = self._halo_part(template)
        B = -(-bs // self.dp)
        full = full.reshape(self.dp, self.gp, B, part.chunk, C).permute(0, 2, 1, 3, 4)
        full = full.reshape(self.dp * B, part.n_pad_dist, C)[:bs, :n]
        inv = torch.as_tensor(np.argsort(part.perm), device=full.device)
        return full[:, inv].reshape(-1, C)

    # -- steps ---------------------------------------------------------------
    def _local_loss(self, graph, x, mk, cnt, prefix):
        x_in = torch.where(mk[:, None], 0.0, x)
        out = self.model(x_in, graph, training=(prefix == "train"))
        mask_f = mk.to(torch.float32)[:, None]
        loss = masked_loss_sum(self.cfg.criterion, out, x, mask_f) / cnt
        with torch.no_grad():
            mo = moments_of(out, x, mask_f, self.stats)
        return loss, mo, out

    def train_step(self, template: GraphTemplate, xb, mask=None,
                   generator: Optional[torch.Generator] = None):
        """One optimizer step of the mesh on the batch ``xb`` [bs, n] (the
        same on every rank). Returns ``(loss, metrics)`` as device tensors,
        the same on every rank."""
        xb = np.asarray(xb, np.float32)
        bs, n = xb.shape
        gmask = self._global_mask(bs, n, mask, generator, None)
        cnt = max(float(gmask.sum()), 1.0)
        graph, x, mk = self._shard(template, xb, gmask)
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        with matmul_precision(self.cfg.matmul_precision):
            loss, mo, _ = self._local_loss(graph, x, mk, cnt, "train")
            loss.backward()
        params = [p for p in self.model.parameters() if p.grad is not None]
        loss, mo = sum_step(self.mesh, params, loss, mo)
        mets = metrics_of(mo, "train")
        if self.cfg.log_gradient:
            with torch.no_grad():
                mets = {**mets, "grad_norm": _global_norm(p.grad for p in params),
                        **self._block_grad_norms()}
        if self.autoclip is not None:
            self.autoclip.clip_(params)
        self.optimizer.step()
        return loss, mets

    @torch.no_grad()
    def eval_step(self, template: GraphTemplate, xb, mask=None,
                  generator: Optional[torch.Generator] = None, prefix: str = "val"):
        """Returns ``(loss, metrics, out, mask)``: ``out`` [bs·n, 1] gathered
        from every rank in original node order, ``mask`` [bs·n] the global
        mask (it always holds ``required_mask_idx``)."""
        xb = np.asarray(xb, np.float32)
        bs, n = xb.shape
        gmask = self._global_mask(bs, n, mask, generator, self.required_mask_idx)
        cnt = max(float(gmask.sum()), 1.0)
        graph, x, mk = self._shard(template, xb, gmask)
        self.model.eval()
        with matmul_precision(self.cfg.matmul_precision):
            loss, mo, out = self._local_loss(graph, x, mk, cnt, prefix)
        flat = self.mesh.all_reduce(torch.cat([loss.reshape(1), mo]))
        out = self._gather_out(template, graph, out, bs)
        return flat[0], metrics_of(flat[1:], prefix), out, gmask.to(self.device)

    # -- run bookkeeping: rank 0 writes -----------------------------------------
    def fit(self, train_ds, val_ds, log_fn: Callable[[str], None] = print,
            on_epoch_end: Optional[Callable[[int, dict], None]] = None) -> dict:
        """``Trainer.fit`` on every rank; rank 0 logs and writes the
        checkpoints, and every rank waits for it at the end."""
        quiet = (lambda *_: None) if self.mesh.rank else log_fn
        best = super().fit(train_ds, val_ds, log_fn=quiet, on_epoch_end=on_epoch_end)
        self.mesh.barrier()
        return best

    def _save(self, *args, **kwargs):
        if self.mesh.rank == 0:
            super()._save(*args, **kwargs)

    def restore(self, path: str, log_fn: Callable[[str], None] = print):
        return super().restore(path, log_fn if self.mesh.rank == 0 else (lambda *_: None))
