"""Training / validation loop for masked-node pressure reconstruction.

The counterpart of ``gnn_pressure_estimation_tpu/train/loop.py``:

- One step is mask draw, input zeroing, forward, masked loss, backward,
  AutoClip, Adam update and descaled metrics, all on the trainer's device;
  loss and metrics stay device tensors until the epoch's end, so a step makes
  no host sync.
- The masked-node count is fixed (``int(n * mask_rate)`` per graph).
- Optimizer: AutoClip (optional) → L2 weight decay added to the gradient →
  Adam (``torch.optim.Adam(weight_decay=…)``, betas 0.9/0.999, eps 1e-8): the
  JAX package's ``add_decayed_weights`` before ``scale_by_adam``.
- On a CUDA device every banded ``GATConv`` and ``SimpleMeanConv`` runs the
  hand-written kernels, forward and backward (``ops/``); the padded mode runs
  plain gathers whose backward is a gather too (``ops/padded.py``).

The mask of a batch is drawn from a ``torch.Generator`` seeded from the
epoch's ``numpy`` stream (``default_rng([seed, epoch, 0|1])``), on the CPU,
so a run on the card and a run on the CPU see the same masks and a resumed
run replays the masks of an uninterrupted one. The JAX package's PRNG stream
is not reproduced. Batches are taken in the loader's order.

``TrainConfig.matmul_precision`` scopes the GEMMs of the train and eval
steps (:func:`matmul_precision`), as the JAX package's ``_with_precision``
scopes its jitted steps; the setting the process had is restored after each
step. ``epochs_per_dispatch > 1`` takes :meth:`Trainer._fit_fast`, the JAX
package's multi-epoch block: the snapshots stay on the device, each epoch's
order is ``default_rng([seed, epoch]).permutation``, the tail batch is padded
with graph 0 under a zeroed mask, the host reads the block's losses back once
and early stop, the scheduler and the checkpoints decide per block.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from gnn_pressure_estimation_tpu_torch.core.graph import BatchedGraph, GraphTemplate
from gnn_pressure_estimation_tpu_torch.data.dataset import SnapshotLoader, WDNDataset
from gnn_pressure_estimation_tpu_torch.device import resolve_device
from gnn_pressure_estimation_tpu_torch.train.autoclip import AutoClip
from gnn_pressure_estimation_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from gnn_pressure_estimation_tpu_torch.train.early_stopping import EarlyStopping
from gnn_pressure_estimation_tpu_torch.train.precision import MATMUL_PRECISIONS, matmul_precision
from gnn_pressure_estimation_tpu_torch.utils import metrics as metrics_mod
from gnn_pressure_estimation_tpu_torch.utils import tracing
from gnn_pressure_estimation_tpu_torch.utils.masking import (
    batch_node_mask, mask_from_uniform, masked_count,
)
from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats, descale_with


@dataclasses.dataclass
class TrainConfig:
    """The reference's training flag surface as a typed config (the fields of
    the JAX package's ``TrainConfig``)."""

    lr: float = 5e-4
    weight_decay: float = 6e-6
    epochs: int = 500
    mask_rate: float = 0.95
    batch_size: int = 8
    criterion: str = "mse"           # mse | mae | sce
    norm_type: str = "znorm"
    patience: int = 100
    min_delta: float = 1e-4
    scheduler: Optional[str] = None  # None | "ReduceLROnPlateau"
    scheduler_patience: int = 2
    scheduler_factor: float = 0.1
    use_gradient_clipping: bool = False
    clip_percentile: float = 10.0
    seed: int = 42
    save_path: Optional[str] = None
    model_name: str = "model"
    variant: str = ""
    log_every: int = 5
    # total and per-block gradient norms, and the model's drift on a fixed
    # probe batch against epoch 1
    log_gradient: bool = False
    # the GEMMs of the train and eval steps: None (the process's setting) |
    # "highest" (f32) | "tensorfloat32" (TF32) | "bfloat16" (bf16-rounded
    # operands, f32 sums); see matmul_precision()
    matmul_precision: Optional[str] = None
    # accepted and ignored: PyTorch updates parameters and optimizer state in
    # place, there is no buffer to donate
    donate_state: bool = True
    # >1: blocks of that many epochs (train + validation) with the snapshots
    # on the device, one read-back a block; best-epoch checkpoints then hold
    # block-end parameters (see Trainer._fit_fast)
    epochs_per_dispatch: int = 1
    # aggregation mode of the batched template: None = auto (dense up to
    # DENSE_THRESHOLD nodes, banded above) | "dense" | "banded" | "padded"
    # (degree-padded neighbour slots, original node order); band_block sets
    # the banded block-row size (default 256); band_attn names the
    # band-attention kernel (None = by layout | "dma" | "flash" | "window" |
    # "acc": v2's forward with the owner-row backward)
    agg_mode: Optional[str] = None
    band_block: Optional[int] = None
    band_attn: Optional[str] = None


def make_criterion(name: str) -> Callable:
    """Loss on *scaled* masked values."""
    if name == "mse":
        return lambda p, t: torch.mean((p - t) ** 2)
    if name == "mae":
        return lambda p, t: torch.mean(torch.abs(p - t))
    if name == "sce":
        def sce(p, t, alpha=3.0):
            pn = p / torch.linalg.norm(p, dim=-1, keepdim=True).clamp(min=1e-12)
            tn = t / torch.linalg.norm(t, dim=-1, keepdim=True).clamp(min=1e-12)
            return torch.mean((1.0 - torch.sum(pn * tn, dim=-1)) ** alpha)
        return sce
    raise KeyError(f"criterion {name!r} is not supported")


class ReduceLROnPlateau:
    """mode=min, relative threshold 1e-4, factor, patience. A copy of the JAX
    package's class: it takes and returns the learning rate and keeps only
    ``best`` and ``num_bad``, which the checkpoints store; its state handling
    differs from ``torch.optim.lr_scheduler.ReduceLROnPlateau``'s."""

    def __init__(self, patience: int = 2, factor: float = 0.1,
                 threshold: float = 1e-4, min_lr: float = 0.0):
        self.patience = patience
        self.factor = factor
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = math.inf
        self.num_bad = 0

    def step(self, metric: float, lr: float) -> float:
        metric = float(metric)
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            self.num_bad = 0
            return max(lr * self.factor, self.min_lr)
        return lr

    def state_dict(self) -> dict:
        return {"best": self.best, "num_bad": self.num_bad}

    def load_state_dict(self, state: dict):
        self.best = float(state.get("best", math.inf))
        self.num_bad = int(state.get("num_bad", 0))


def _global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum((g.to(torch.float32) ** 2).sum() for g in grads))


class Trainer:
    """Drives train/val epochs over a :class:`WDNDataset`.

    ``model`` arrives initialised (``select_model(name, seed=…)`` draws the
    glorot weights; loading a ``state_dict`` replaces them) and is moved to
    ``device``, ``"cuda"`` unless the caller asks for the CPU. One batched
    graph is built per (template, batch size) and cached for the whole run.
    """

    # the multi-epoch block (epochs_per_dispatch > 1) runs single-device
    # steps; the mesh trainer opts out, as the JAX one does
    supports_fast_fit = True

    def __init__(
        self,
        model: nn.Module,
        cfg: TrainConfig,
        stats: NormStats,
        sample_template: GraphTemplate,
        required_mask_idx: tuple = (),
        device="cuda",
    ):
        if cfg.matmul_precision not in MATMUL_PRECISIONS:
            raise ValueError(f"matmul_precision {cfg.matmul_precision!r} is not one of "
                             f"{MATMUL_PRECISIONS}")
        # host transfers of the multi-epoch block: blocks run, read-backs,
        # uploads (snapshots once; orders and masks or uniforms per block)
        self.fast_io = {"blocks": 0, "readbacks": 0, "uploads": 0}
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.stats = stats
        self.criterion = make_criterion(cfg.criterion)
        self.required_mask_idx = tuple(required_mask_idx)
        self.sample_template = sample_template
        self._graph_cache: dict = {}
        self._resume: Optional[dict] = None

        self.autoclip = (AutoClip(cfg.clip_percentile, device=self.device)
                         if cfg.use_gradient_clipping else None)
        self.optimizer = torch.optim.Adam(
            self.model.parameters(), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=cfg.weight_decay)
        self.n_params = sum(p.numel() for p in self.model.parameters())

    # -- learning rate ---------------------------------------------------
    @property
    def lr(self) -> float:
        return float(self.optimizer.param_groups[0]["lr"])

    @lr.setter
    def lr(self, value: float):
        for group in self.optimizer.param_groups:
            group["lr"] = float(value)

    # ------------------------------------------------------------------
    def _batched_graph(self, template: GraphTemplate, bs: int) -> BatchedGraph:
        key = (id(template), bs)
        if key not in self._graph_cache:
            self._graph_cache[key] = template.batch(
                bs, mode=self.cfg.agg_mode, band_block=self.cfg.band_block, device=self.device,
                band_attn=self.cfg.band_attn)
        return self._graph_cache[key]

    def _masked_loss_and_metrics(self, graph, x, y, mask, n_masked, prefix):
        """``x``, ``y`` [N, 1] and ``mask`` [N] bool in the graph's node space
        → ``(loss, metrics, out)``. ``n_masked=None`` divides by the mask's own
        count (the float sum of 0/1 flags is exact)."""
        out = self._masked_forward(graph, x, mask, prefix)
        return (*self._loss_and_metrics(out, y, mask, n_masked, prefix), out)

    def _masked_forward(self, graph, x, mask, prefix):
        """The model on ``x`` with the masked nodes zeroed."""
        x_in = torch.where(mask[:, None], 0.0, x)
        return self.model(x_in, graph, training=(prefix == "train"))

    def _loss_and_metrics(self, out, y, mask, n_masked, prefix):
        """The masked loss of ``out`` against ``y`` and the descaled metrics."""
        st = self.stats
        if self.cfg.criterion in ("mse", "mae"):
            # mask-weighted: no gather on the hot path; metrics from masked
            # moments (algebraically the gathered formulas)
            mask_f = mask.to(torch.float32)[:, None]
            if n_masked is None:
                n_masked = mask_f.sum().clamp(min=1.0)
            diff = (out - y) * mask_f
            if self.cfg.criterion == "mse":
                loss = torch.sum(diff * diff) / n_masked
            else:
                loss = torch.sum(torch.abs(diff)) / n_masked
            with torch.no_grad():
                mo = metrics_mod.masked_moments(
                    descale_with(out, st), descale_with(y, st), mask_f)
                mets = metrics_mod.metrics_from_moments(mo, prefix)
            return loss, mets
        midx = torch.nonzero(mask, as_tuple=True)[0]
        yp, yt = out[midx], y[midx]
        loss = self.criterion(yp, yt)
        with torch.no_grad():
            mets = metrics_mod.compute_all(descale_with(yp, st), descale_with(yt, st), prefix)
        return loss, mets

    def _prepare(self, template, xb, mask, generator, required):
        """Host batch [bs, n] (+ an explicit [bs·n] mask, or a generator to
        draw one) → graph, x and mask on the device in the graph's node
        space, and the fixed masked count. The uploads are the span
        ``train.upload`` (``h2d_bytes``: the snapshots, and the mask where it
        is on the host): from pageable memory, so the host waits there for
        the stream to drain."""
        xb = np.asarray(xb, np.float32)
        bs, n = xb.shape
        graph = self._batched_graph(template, bs)
        n_masked = bs * masked_count(n, self.cfg.mask_rate)
        if mask is None:
            mask = batch_node_mask(generator, bs, n, self.cfg.mask_rate,
                                   required_idx=required, device=generator.device)
        else:
            mask = torch.as_tensor(np.asarray(mask), dtype=torch.bool)
        mask_bytes = mask.numel() * mask.element_size() if mask.device.type == "cpu" else 0
        with tracing.span("train.upload", h2d_bytes=xb.nbytes + mask_bytes):
            mask = mask.to(self.device)
            x = torch.as_tensor(xb.reshape(-1, 1), device=self.device)
        if graph.banded:
            # banded graphs run in RCM-permuted padded node space
            x = graph.pack_nodes(x, n)
            mask = graph.pack_nodes(mask.to(torch.float32)[:, None], n)[:, 0] > 0.5
        return graph, x, mask, n_masked

    def train_step(self, template: GraphTemplate, xb, mask=None,
                   generator: Optional[torch.Generator] = None):
        """One optimizer step on the batch ``xb`` [bs, n] (scaled snapshots;
        the target is the unmasked field). Returns ``(loss, metrics)`` as
        device tensors.

        Spans (``utils.tracing``): ``train_step`` over ``train.prepare``
        (graph lookup, node packing, and the uploads of the snapshots and a
        mask handed in as its child ``train.upload``) and :meth:`_train_on`'s."""
        with tracing.span("train_step"):
            with tracing.span("train.prepare"):
                graph, x, mask, n_masked = self._prepare(template, xb, mask, generator, None)
            return self._train_on(graph, x, mask, n_masked)

    def _train_on(self, graph, x, mask, n_masked):
        """The step on device tensors in the graph's node space, at the
        configured matmul precision; ``n_masked=None``: the mask's count.
        Spans: ``train.zero_grad``, ``train.forward`` (the model),
        ``train.loss`` (masked loss and metrics), ``train.backward`` and
        ``train.optimizer`` (gradient norms, clipping, the Adam step)."""
        self.model.train()
        with tracing.span("train.zero_grad"):
            self.optimizer.zero_grad(set_to_none=True)
        with matmul_precision(self.cfg.matmul_precision):
            with tracing.span("train.forward"):
                out = self._masked_forward(graph, x, mask, "train")
            with tracing.span("train.loss"):
                loss, mets = self._loss_and_metrics(out, x, mask, n_masked, "train")
            with tracing.span("train.backward"):
                loss.backward()
            with tracing.span("train.optimizer"):
                params = [p for p in self.model.parameters() if p.grad is not None]
                if self.cfg.log_gradient:
                    with torch.no_grad():
                        mets = {**mets, "grad_norm": _global_norm(p.grad for p in params),
                                **self._block_grad_norms()}
                if self.autoclip is not None:
                    self.autoclip.clip_(params)
                self.optimizer.step()
        return loss.detach(), mets

    def _block_grad_norms(self) -> dict:
        """Gradient norm of every top-level part whose flax name holds block,
        mlp, res or gcn (``grad_norm_block_3``, ``grad_norm_gcn_0``,
        ``grad_norm_GCN2Conv_5`` …), as the JAX package logs them."""
        from gnn_pressure_estimation_tpu_torch.weights import flax_names

        names = flax_names(self.model)
        groups: dict[str, list] = {}
        for key, p in self.model.named_parameters():
            if p.grad is None:
                continue
            top = names[key][0][0]
            if any(tag in top.lower() for tag in ("block", "mlp", "res", "gcn")):
                groups.setdefault(top, []).append(p.grad)
        return {f"grad_norm_{k}": _global_norm(v) for k, v in groups.items()}

    @torch.no_grad()
    def eval_step(self, template: GraphTemplate, xb, mask=None,
                  generator: Optional[torch.Generator] = None, prefix: str = "val"):
        """Returns ``(loss, metrics, out, mask)`` in the graph's node space;
        the drawn mask always holds ``required_mask_idx``."""
        graph, x, mask, n_masked = self._prepare(
            template, xb, mask, generator, self.required_mask_idx)
        self.model.eval()
        with matmul_precision(self.cfg.matmul_precision):
            loss, mets, out = self._masked_loss_and_metrics(graph, x, x, mask, n_masked, prefix)
        return loss, mets, out, mask

    # ------------------------------------------------------------------
    @staticmethod
    def _reduce_batch_stats(per_batch: list) -> tuple[float, dict]:
        """(bs, loss, mets) device scalars → weighted epoch means, brought to
        the host in one transfer."""
        if not per_batch:
            return 0.0, {}
        keys = list(per_batch[0][2])
        w = torch.tensor([bs for bs, _, _ in per_batch], dtype=torch.float64)
        vals = torch.stack([torch.stack([loss] + [mets[k] for k in keys]).to(torch.float64)
                            for _, loss, mets in per_batch]).cpu()
        means = (vals * w[:, None]).sum(0) / w.sum().clamp(min=1)
        return float(means[0]), {k: float(v) for k, v in zip(keys, means[1:])}

    @staticmethod
    def _batch_generator(rng: np.random.Generator) -> torch.Generator:
        return torch.Generator().manual_seed(int(rng.integers(0, 2**31 - 1)))

    def train_one_epoch(self, loader: SnapshotLoader, rng: np.random.Generator):
        per_batch = []
        for template, xb, _ in loader:
            loss, mets = self.train_step(template, xb, generator=self._batch_generator(rng))
            per_batch.append((xb.shape[0], loss, mets))
        return self._reduce_batch_stats(per_batch)

    def eval_one_epoch(self, loader: SnapshotLoader, rng: np.random.Generator,
                       prefix: str = "val"):
        per_batch = []
        for template, xb, _ in loader:
            loss, mets, _, _ = self.eval_step(
                template, xb, generator=self._batch_generator(rng), prefix=prefix)
            per_batch.append((xb.shape[0], loss, mets))
        return self._reduce_batch_stats(per_batch)

    # ------------------------------------------------------------------
    def fit(
        self,
        train_ds: WDNDataset,
        val_ds: WDNDataset,
        log_fn: Callable[[str], None] = print,
        on_epoch_end: Optional[Callable[[int, dict], None]] = None,
        masks: Optional[Callable[[int], tuple]] = None,
    ) -> dict:
        """Train for ``cfg.epochs`` (from the restored epoch on), validating
        each epoch; returns the best epoch's ``{"loss", "epoch", "metrics",
        "train_time_s"}``. ``masks``, on the multi-epoch block path only:
        ``masks(epoch) -> (train [steps_tr, bs·n], val [steps_val, bs·n])``
        bool arrays in place of the drawn masks (the tail's padded graphs
        are unmasked either way), so a test can replay another stream."""
        cfg = self.cfg
        train_loader = SnapshotLoader(train_ds, cfg.batch_size, shuffle=True, seed=cfg.seed)
        val_loader = SnapshotLoader(val_ds, cfg.batch_size, shuffle=False)

        early = EarlyStopping(mode="min", min_delta=cfg.min_delta, patience=cfg.patience)
        sched = (ReduceLROnPlateau(cfg.scheduler_patience, cfg.scheduler_factor)
                 if cfg.scheduler == "ReduceLROnPlateau" else None)

        # model-update drift against epoch 1, on one fixed probe batch
        probe = drift_ref = None
        accum_update = 0.0
        if cfg.log_gradient:
            for template, xb, _ in val_loader:
                probe = (template, xb)
                break

        best = {"loss": math.inf, "epoch": 0, "metrics": {}}

        # true resume: restore() stashes the checkpoint's epoch, early-stop,
        # scheduler and best-so-far state; each epoch's randomness derives
        # from (seed, epoch), so the continuation replays what an
        # uninterrupted run would do
        start_epoch = 1
        rs = self._resume
        if rs:
            start_epoch = int(rs["epoch"]) + 1
            if rs.get("early"):
                early.load_state_dict(rs["early"])
            if sched is not None and rs.get("sched"):
                sched.load_state_dict(rs["sched"])
            if rs.get("best"):
                best.update(rs["best"])

        if (cfg.epochs_per_dispatch > 1 and self.supports_fast_fit
                and len(train_ds.members) == 1 and len(val_ds.members) == 1
                and train_ds.members[0].template is val_ds.members[0].template
                and cfg.criterion in ("mse", "mae") and probe is None):
            return self._fit_fast(train_ds, val_ds, log_fn, on_epoch_end, early, sched, best,
                                  start_epoch, masks)
        if masks is not None:
            raise ValueError("masks= applies to the multi-epoch block path only "
                             "(epochs_per_dispatch > 1)")

        t0 = time.time()
        for epoch in range(start_epoch, cfg.epochs + 1):
            train_loader.set_epoch(epoch)
            rng_tr = np.random.default_rng([cfg.seed, epoch, 0])
            rng_val = np.random.default_rng([cfg.seed, epoch, 1])
            tr_loss, tr_mets = self.train_one_epoch(train_loader, rng_tr)
            val_loss, val_mets = self.eval_one_epoch(val_loader, rng_val)

            if probe is not None:
                out = self._probe_forward(*probe)
                if drift_ref is None:
                    drift_ref, model_update = out, 0.0
                else:
                    model_update = float(torch.mean(torch.abs(out - drift_ref)))
                accum_update += model_update
                tr_mets = {**tr_mets, "model_update": model_update,
                           "accum_model_update": accum_update}

            # step early-stop/scheduler BEFORE checkpointing, so the saved
            # resume state is what an uninterrupted run carries into epoch+1
            stop = early.step(val_loss)
            if not stop and sched is not None:
                new_lr = sched.step(val_loss, self.lr)
                if new_lr != self.lr:
                    self.lr = new_lr

            if val_loss < best["loss"]:
                best = {"loss": val_loss, "epoch": epoch, "metrics": val_mets}
                if cfg.save_path:
                    self._save("best", epoch, val_loss, val_mets, early, sched, best)

            if epoch == 1 or epoch % cfg.log_every == 0:
                mstr = ", ".join(f"{mk}: {mv:.4f}" for mk, mv in val_mets.items())
                log_fn(f"Epoch: {epoch:03d}, train loss: {tr_loss:.4f}, "
                       f"val_loss: {val_loss:.4f}, {mstr}")
            # 'last' is written every epoch, so an interrupted run loses at
            # most the epoch in flight
            if cfg.save_path and not math.isnan(tr_loss):
                self._save("last", epoch, val_loss, val_mets, early, sched, best)

            if on_epoch_end:
                on_epoch_end(epoch, {"train_loss": tr_loss, "val_loss": val_loss,
                                     **tr_mets, **val_mets})
            if stop:
                log_fn(f"\n!! No improvement for {cfg.patience} epochs. Training stopped!")
                break

        best["train_time_s"] = time.time() - t0
        return best

    # -- the multi-epoch block (epochs_per_dispatch > 1) ---------------------
    @staticmethod
    def _block_layout(S: int, bs: int):
        """(steps, valid [steps, bs]) for one pass over S samples with the
        tail padded to a full batch of zero-weight graphs."""
        steps = max(-(-S // bs), 1)
        valid = np.ones((steps, bs), np.float32)
        t = S - (steps - 1) * bs
        if t < bs:
            valid[-1, t:] = 0.0
        return steps, valid

    def _block_uniforms(self, ep: int, split: int, steps: int, bs: int, n: int) -> torch.Tensor:
        """The mask draws of one epoch's train (split 0) or validation (1)
        steps, [steps, bs, n] on the CPU: one generator an (epoch, split),
        seeded from ``default_rng([seed, epoch, split])``, so a block's
        boundaries do not change them."""
        rng = np.random.default_rng([self.cfg.seed, ep, split])
        return torch.rand((steps, bs, n), generator=self._batch_generator(rng))

    def _fit_fast(self, train_ds, val_ds, log_fn, on_epoch_end, early, sched, best,
                  start_epoch: int = 1, masks=None):
        """``fit`` in blocks of ``cfg.epochs_per_dispatch`` epochs, the JAX
        package's ``_fit_fast``. The snapshots go to the device once. A block
        uploads its epochs' orders (``default_rng([seed, epoch]).permutation``,
        the tail padded with graph 0) and mask draws (or ``masks``) in one
        copy each, runs every step with no host sync (the masked count of a
        step is its mask's, so a padded tail weighs as its true size), and
        reads back every epoch's loss and metrics in one copy; the epoch's
        values are means over its steps weighted by their valid graphs.

        Early stop, the scheduler and the checkpoints decide per block, in
        epoch order: a best epoch inside a block is saved with the
        block-end parameters, its write deferred to the block's end so that
        the stored early-stop and scheduler state match ``params_epoch``,
        and 'last' is written once a block."""
        cfg = self.cfg
        m_tr, m_val = train_ds.members[0], val_ds.members[0]
        template = m_tr.template
        bs, n, dev = cfg.batch_size, template.n_node, self.device
        k = masked_count(n, cfg.mask_rate)
        graph = self._batched_graph(template, bs)
        S_tr, S_val = len(m_tr.array), len(m_val.array)
        steps_tr, valid_tr = self._block_layout(S_tr, bs)
        steps_val, valid_val = self._block_layout(S_val, bs)
        data_tr = torch.as_tensor(np.asarray(m_tr.array, np.float32), device=dev)
        data_val = torch.as_tensor(np.asarray(m_val.array, np.float32), device=dev)
        valid_tr, valid_val = (torch.as_tensor(v, device=dev) for v in (valid_tr, valid_val))
        vidx = torch.arange(steps_val * bs, device=dev).reshape(steps_val, bs).clamp(max=S_val - 1)
        self.fast_io["uploads"] += 4

        def batch(data, idx, draw, valid, required):
            x = data[idx].reshape(bs * n, 1)
            if draw.dtype == torch.bool:
                mask = draw
            else:
                mask = mask_from_uniform(draw, k, required).reshape(-1)
            mask = mask & (valid > 0.5).repeat_interleave(n)
            if graph.banded:
                x = graph.pack_nodes(x, n)
                mask = graph.pack_nodes(mask.to(torch.float32)[:, None], n)[:, 0] > 0.5
            return x, mask

        def wmean(vals, valid):
            w = valid.sum(dim=1)
            return (torch.stack(vals) * w).sum() / w.sum().clamp(min=1.0)

        t0 = time.time()
        epoch, stop = start_epoch, False
        while epoch <= cfg.epochs and not stop:
            E = min(cfg.epochs_per_dispatch, cfg.epochs - epoch + 1)
            perms = np.zeros((E, steps_tr, bs), np.int64)
            for e in range(E):
                order = np.random.default_rng([cfg.seed, epoch + e]).permutation(S_tr)
                perms[e] = np.concatenate(
                    [order, np.zeros((-S_tr) % (steps_tr * bs), np.int64)]).reshape(steps_tr, bs)
            if masks is None:
                draws = [torch.stack([self._block_uniforms(epoch + e, 0, steps_tr, bs, n)
                                      for e in range(E)]),
                         torch.stack([self._block_uniforms(epoch + e, 1, steps_val, bs, n)
                                      for e in range(E)])]
            else:
                given = [masks(epoch + e) for e in range(E)]
                draws = [torch.as_tensor(np.stack([np.asarray(g[i], bool).reshape(-1, bs * n)
                                                   for g in given])) for i in (0, 1)]
            perms_d, draws_tr, draws_val = (t.to(dev) for t in (torch.as_tensor(perms), *draws))
            self.fast_io["uploads"] += 3
            rows = []                       # per epoch: train loss, val loss, metrics
            for e in range(E):
                tr = [self._train_on(graph, *batch(data_tr, perms_d[e, s], draws_tr[e, s],
                                                   valid_tr[s], None), None)
                      for s in range(steps_tr)]
                with torch.no_grad():
                    self.model.eval()
                    va = []
                    for s in range(steps_val):
                        x, mask = batch(data_val, vidx[s], draws_val[e, s], valid_val[s],
                                        self.required_mask_idx)
                        with matmul_precision(cfg.matmul_precision):
                            loss, mets, _ = self._masked_loss_and_metrics(graph, x, x, mask, None,
                                                                          "val")
                        va.append((loss, mets))
                    tr_keys, val_keys = list(tr[0][1]), list(va[0][1])
                    rows.append(torch.stack(
                        [wmean([l for l, _ in tr], valid_tr), wmean([l for l, _ in va], valid_val)]
                        + [wmean([m[key] for _, m in tr], valid_tr) for key in tr_keys]
                        + [wmean([m[key] for _, m in va], valid_val) for key in val_keys]))
            host = torch.stack(rows).to(torch.float64).cpu().numpy()   # the block's one read-back
            self.fast_io["readbacks"] += 1
            self.fast_io["blocks"] += 1
            best_dirty = False
            for j in range(E):
                ep = epoch + j
                tr_loss, val_loss = float(host[j, 0]), float(host[j, 1])
                tm = {key: float(v) for key, v in zip(tr_keys, host[j, 2:2 + len(tr_keys)])}
                vm = {key: float(v) for key, v in zip(val_keys, host[j, 2 + len(tr_keys):])}
                stop = early.step(val_loss)
                if not stop and sched is not None:
                    new_lr = sched.step(val_loss, self.lr)
                    if new_lr != self.lr:
                        self.lr = new_lr
                if val_loss < best["loss"]:
                    best.update({"loss": val_loss, "epoch": ep, "metrics": vm})
                    best_dirty = True
                if ep == 1 or ep % cfg.log_every == 0:
                    mstr = ", ".join(f"{mk}: {mv:.4f}" for mk, mv in vm.items())
                    log_fn(f"Epoch: {ep:03d}, train loss: {tr_loss:.4f}, "
                           f"val_loss: {val_loss:.4f}, {mstr}")
                if cfg.save_path and not math.isnan(tr_loss) and (j == E - 1 or stop):
                    # the block-end parameters are the only ones there are
                    self._save("last", ep, val_loss, vm, early, sched, best,
                               params_epoch=epoch + E - 1)
                if on_epoch_end:
                    on_epoch_end(ep, {"train_loss": tr_loss, "val_loss": val_loss, **tm, **vm})
                if stop:
                    log_fn(f"\n!! No improvement for {cfg.patience} epochs. Training stopped!")
                    break
            if best_dirty and cfg.save_path:
                # at the block's end, so that the stored early-stop and
                # scheduler state is that of params_epoch
                self._save("best", best["epoch"], best["loss"], best["metrics"], early, sched,
                           best, params_epoch=epoch + E - 1)
            epoch += E
        best["train_time_s"] = time.time() - t0
        return best

    @torch.no_grad()
    def _probe_forward(self, template, xb):
        graph = self._batched_graph(template, xb.shape[0])
        x = torch.as_tensor(np.asarray(xb, np.float32).reshape(-1, 1), device=self.device)
        if graph.banded:
            x = graph.pack_nodes(x, template.n_node)
        self.model.eval()
        return self.model(x, graph)

    # -- optimizer state and checkpoints -----------------------------------
    def opt_state_dict(self) -> dict[str, torch.Tensor]:
        """The optimizer's state as a flat name → tensor dict: the learning
        rate, Adam's step count and moments per parameter name, and
        AutoClip's ring buffer."""
        out = {"lr": torch.tensor(self.lr, dtype=torch.float64)}
        for name, p in self.model.named_parameters():
            st = self.optimizer.state.get(p)
            if st:
                out[f"adam.step.{name}"] = torch.as_tensor(st["step"]).detach().clone()
                out[f"adam.exp_avg.{name}"] = st["exp_avg"].detach().clone()
                out[f"adam.exp_avg_sq.{name}"] = st["exp_avg_sq"].detach().clone()
        if self.autoclip is not None:
            for k, v in self.autoclip.state_dict().items():
                out[f"autoclip.{k}"] = v
        return out

    def load_opt_state_dict(self, state: dict):
        self.lr = float(state["lr"])
        for name, p in self.model.named_parameters():
            if f"adam.step.{name}" not in state:
                continue
            self.optimizer.state[p] = {
                "step": state[f"adam.step.{name}"].to(torch.float32).clone(),
                "exp_avg": state[f"adam.exp_avg.{name}"].to(p.device, p.dtype).clone(),
                "exp_avg_sq": state[f"adam.exp_avg_sq.{name}"].to(p.device, p.dtype).clone(),
            }
        if self.autoclip is not None and "autoclip.history" in state:
            self.autoclip.load_state_dict(
                {"history": state["autoclip.history"], "count": state["autoclip.count"]})

    def _save(self, kind, epoch, loss, metrics, early, sched, best, params_epoch=None):
        save_checkpoint(
            path=self._ckpt_path(kind), params=self.model.state_dict(),
            opt_state=self.opt_state_dict(), epoch=epoch, loss=loss, metrics=metrics,
            stats=self.stats, extra=self._resume_extra(early, sched, best, params_epoch))

    def _resume_extra(self, early, sched, best, params_epoch=None) -> dict:
        """Serializable continuation state stored in every checkpoint, plus
        the aggregation layout the model was trained under (so evaluation can
        default to the same layout). ``params_epoch``: the epoch the stored
        parameters belong to where it differs from the checkpoint's
        reporting epoch (a block's best or early-stop epoch holds the
        block-end parameters), so a resume continues after it."""
        return {
            "resume": {
                "early": early.state_dict(),
                "sched": sched.state_dict() if sched is not None else None,
                "best": {"loss": best["loss"], "epoch": best["epoch"],
                         "metrics": best.get("metrics", {})},
                **({"params_epoch": int(params_epoch)} if params_epoch is not None else {}),
            },
            "layout": {"agg_mode": self.cfg.agg_mode, "band_block": self.cfg.band_block,
                       "band_attn": self.cfg.band_attn},
        }

    def restore(self, path: str, log_fn: Callable[[str], None] = print):
        """Full-state resume from a checkpoint written by this Trainer:
        parameters, optimizer state, epoch counter, early-stop / scheduler /
        best-so-far state. A weights-only checkpoint still loads and restarts
        the bookkeeping at epoch ``meta['epoch'] + 1``. A checkpoint of the
        multi-epoch block (this trainer's or the JAX package's, converted)
        holds the block-end parameters: the run continues after the later of
        its epoch and its ``params_epoch``."""
        params, opt_state, meta = load_checkpoint(path, self.model.state_dict())
        self.model.load_state_dict(params)
        if opt_state is not None:
            self.load_opt_state_dict(opt_state)
        else:
            log_fn(f"WARNING: {path} has no optimizer state; Adam moments reset")
        rs = (meta.get("extra") or {}).get("resume") or {}
        epoch = max(int(meta.get("epoch", 0)), int(rs.get("params_epoch") or 0))
        self._resume = {**rs, "epoch": epoch}
        return meta

    def _ckpt_path(self, kind: str) -> str:
        name = f"{kind}_{self.cfg.model_name}"
        if self.cfg.variant:
            name += f"_{self.cfg.variant}"
        return os.path.join(self.cfg.save_path, name + ".ckpt")
