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
from gnn_pressure_estimation_tpu_torch.utils import metrics as metrics_mod
from gnn_pressure_estimation_tpu_torch.utils.masking import batch_node_mask, masked_count
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
    # kept for the JAX package's configs; "bfloat16" is not ported
    matmul_precision: Optional[str] = None  # None | "highest"
    # accepted and ignored: PyTorch updates parameters and optimizer state in
    # place, there is no buffer to donate
    donate_state: bool = True
    # >1 runs several epochs per device dispatch in the JAX package (a cure
    # for its dispatch latency); not ported: a value above 1 raises
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

    def __init__(
        self,
        model: nn.Module,
        cfg: TrainConfig,
        stats: NormStats,
        sample_template: GraphTemplate,
        required_mask_idx: tuple = (),
        device="cuda",
    ):
        if cfg.epochs_per_dispatch > 1:
            raise NotImplementedError(
                "epochs_per_dispatch > 1 (several epochs per device dispatch) is not yet ported")
        if cfg.matmul_precision not in (None, "highest"):
            raise NotImplementedError(f"matmul_precision {cfg.matmul_precision!r} is not yet ported")
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
        x_in = torch.where(mask[:, None], 0.0, x)
        out = self.model(x_in, graph, training=(prefix == "train"))
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
            return loss, mets, out
        midx = torch.nonzero(mask, as_tuple=True)[0]
        yp, yt = out[midx], y[midx]
        loss = self.criterion(yp, yt)
        with torch.no_grad():
            mets = metrics_mod.compute_all(descale_with(yp, st), descale_with(yt, st), prefix)
        return loss, mets, out

    def _prepare(self, template, xb, mask, generator, required):
        """Host batch [bs, n] (+ an explicit [bs·n] mask, or a generator to
        draw one) → graph, x and mask on the device in the graph's node
        space, and the fixed masked count."""
        xb = np.asarray(xb, np.float32)
        bs, n = xb.shape
        graph = self._batched_graph(template, bs)
        n_masked = bs * masked_count(n, self.cfg.mask_rate)
        if mask is None:
            mask = batch_node_mask(generator, bs, n, self.cfg.mask_rate,
                                   required_idx=required, device=self.device)
        else:
            mask = torch.as_tensor(np.asarray(mask), dtype=torch.bool, device=self.device)
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
        device tensors."""
        graph, x, mask, n_masked = self._prepare(template, xb, mask, generator, None)
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss, mets, _ = self._masked_loss_and_metrics(graph, x, x, mask, n_masked, "train")
        loss.backward()
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
    ) -> dict:
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

    def _save(self, kind, epoch, loss, metrics, early, sched, best):
        save_checkpoint(
            path=self._ckpt_path(kind), params=self.model.state_dict(),
            opt_state=self.opt_state_dict(), epoch=epoch, loss=loss, metrics=metrics,
            stats=self.stats, extra=self._resume_extra(early, sched, best))

    def _resume_extra(self, early, sched, best) -> dict:
        """Serializable continuation state stored in every checkpoint, plus
        the aggregation layout the model was trained under (so evaluation can
        default to the same layout)."""
        return {
            "resume": {
                "early": early.state_dict(),
                "sched": sched.state_dict() if sched is not None else None,
                "best": {"loss": best["loss"], "epoch": best["epoch"],
                         "metrics": best.get("metrics", {})},
            },
            "layout": {"agg_mode": self.cfg.agg_mode, "band_block": self.cfg.band_block,
                       "band_attn": self.cfg.band_attn},
        }

    def restore(self, path: str, log_fn: Callable[[str], None] = print):
        """Full-state resume from a checkpoint written by this Trainer:
        parameters, optimizer state, epoch counter, early-stop / scheduler /
        best-so-far state. A weights-only checkpoint still loads and restarts
        the bookkeeping at epoch ``meta['epoch'] + 1``."""
        params, opt_state, meta = load_checkpoint(path, self.model.state_dict())
        self.model.load_state_dict(params)
        if opt_state is not None:
            self.load_opt_state_dict(opt_state)
        else:
            log_fn(f"WARNING: {path} has no optimizer state; Adam moments reset")
        rs = (meta.get("extra") or {}).get("resume") or {}
        self._resume = {**rs, "epoch": int(meta.get("epoch", 0))}
        return meta

    def _ckpt_path(self, kind: str) -> str:
        name = f"{kind}_{self.cfg.model_name}"
        if self.cfg.variant:
            name += f"_{self.cfg.variant}"
        return os.path.join(self.cfg.save_path, name + ".ckpt")
