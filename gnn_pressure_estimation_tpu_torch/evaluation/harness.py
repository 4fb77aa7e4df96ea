"""Multi-trial statistical evaluation harness.

The counterpart of ``gnn_pressure_estimation_tpu/evaluation/harness.py``
(reference evaluation.py:240-803):

- ``clean``:    N mask redraws over a fixed snapshot dataset
- ``noisy11``:  N noise scenes (online re-simulation), 1 mask each
- ``noisyNN``:  N noise scenes × N masks (N² runs)
- every trial reports all-nodes *and* sensors-only passes
  (``test_and_collect_once``, evaluation.py:525-598); sensors come from an
  optional secrets plug-in or an explicit name list and are always-masked
- metrics: the 7-metric suite on descaled values, plus ``test_time`` (ms per
  snapshot) and ``test_throughput`` measured after warm-up on trial 0, between
  CUDA events on the card
- aggregation: mean ± (std + 1e-6) across trials (evaluation.py:739-761)

The model holds its weights and runs on ``device`` (the card by default). The
masks are drawn in the JAX package's order, one per batch (one per pass on
the scene path), each from a CPU ``torch.Generator`` seeded by the same
``rng.integers`` draw; the JAX PRNG stream itself cannot be reproduced.
Losses and metrics stay on the device until the end of a trial (of a scene
block), which reads them back to the host at once.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Optional, Sequence

import numpy as np
import torch
from torch.func import vmap

from gnn_pressure_estimation_tpu_torch.data.dataset import SnapshotLoader, WDNDataset
from gnn_pressure_estimation_tpu_torch.data.noisy import NoisyWDNDataset
from gnn_pressure_estimation_tpu_torch.device import resolve_device
from gnn_pressure_estimation_tpu_torch.evaluation.sensors import get_sensors
from gnn_pressure_estimation_tpu_torch.evaluation.timer import Timer
from gnn_pressure_estimation_tpu_torch.train.loop import make_criterion
from gnn_pressure_estimation_tpu_torch.utils import metrics as metrics_mod
from gnn_pressure_estimation_tpu_torch.utils.masking import batch_node_mask, masked_count
from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats, descale_with


@dataclasses.dataclass
class EvalConfig:
    """Evaluation flag surface (reference evaluation.py:823-926)."""

    test_type: str = "clean"          # clean | noisy11 | noisyNN
    num_test_trials: int = 10
    batch_size: int = 32
    mask_rate: float = 0.95
    criterion: str = "mse"
    use_same_mask: bool = False
    gpu_warmup_times: int = 10
    seed: int = 1234
    # sensors
    test_input_path: Optional[str] = None
    sensor_names: Optional[Sequence[str]] = None
    include_reservoir: bool = False
    # noisy-simulation knobs (reference get_default_datasets defaults,
    # evaluation.py:69)
    mean_dmd: float = 0.1
    std_dmd: float = 1.0
    feature: str = "pressure"
    removal: str = "keep_junction"
    # aggregation-layout overrides, mirroring TrainConfig.agg_mode/band_block:
    # a model trained banded must evaluate banded (same layout → same
    # numerics); None = auto like training
    agg_mode: Optional[str] = None
    band_block: Optional[int] = None


class Evaluator:
    """Per-trial evaluation over a dataset, with optional sensor set, on
    ``device`` (the card by default; raises if none is present).

    The model is moved to ``device`` and put in eval mode. One
    ``BatchedGraph`` is built per (template, batch size) and reused: noise
    scenes share their template, so N scenes build one graph and one band
    index. ``mesh`` (the JAX package's SPMD evaluation over a device mesh)
    is not ported yet."""

    def __init__(self, model: torch.nn.Module, cfg: EvalConfig, stats: NormStats, mesh=None,
                 device="cuda"):
        if mesh is not None:
            raise NotImplementedError(
                "mesh evaluation is not yet ported (ROADMAP Queue 1 item 7, parallel)")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = cfg
        self.stats = stats
        self.criterion = make_criterion(cfg.criterion)
        self._graphs: dict = {}
        self._sensor_cache: dict = {}

    def _sensor_idx(self, template) -> tuple:
        # depends only on (cfg, template): cache to avoid re-parsing the INP
        # on every batch of every trial
        ck = id(template)
        if ck not in self._sensor_cache:
            self._sensor_cache[ck] = self._sensor_idx_uncached(template)
        return self._sensor_cache[ck]

    def _sensor_idx_uncached(self, template) -> tuple:
        cfg = self.cfg
        if cfg.sensor_names is not None:
            names = list(cfg.sensor_names)
        elif cfg.test_input_path is not None:
            _, names = get_sensors(cfg.test_input_path, cfg.feature, cfg.include_reservoir)
        else:
            return ()
        if not names:
            return ()
        kept = template.node_names or []
        lookup = {n: i for i, n in enumerate(kept)}
        return tuple(lookup[n] for n in names if n in lookup)

    def _graph(self, template, bs: int):
        # honor the training layout (a model trained with --agg_mode banded
        # --band_block 128 must evaluate under the same layout)
        key = (id(template), bs)
        if key not in self._graphs:
            self._graphs[key] = template.batch(bs, mode=self.cfg.agg_mode,
                                               band_block=self.cfg.band_block,
                                               device=self.device)
        return self._graphs[key]

    def _draw_mask(self, rng, bs, n, required_idx):
        """One mask for ``bs`` graphs, drawn from a generator seeded by the
        next ``rng`` draw (the JAX package seeds its PRNG key the same way)."""
        gen = torch.Generator().manual_seed(int(rng.integers(0, 2**31 - 1)))
        return batch_node_mask(gen, bs, n, self.cfg.mask_rate, required_idx=required_idx,
                               shared=self.cfg.use_same_mask, device=self.device)

    def _metrics(self, template, bs, prefix, out, y, mask):
        """Loss and metrics over the masked rows, gathered in ascending index
        order: exactly ``bs * k`` of them, so no host sync sizes the gather."""
        n_masked = bs * masked_count(template.n_node, self.cfg.mask_rate)
        midx = torch.argsort((~mask).to(torch.uint8), stable=True)[:n_masked]
        yp, yt = out[midx], y[midx]
        st = self.stats
        loss = self.criterion(yp, yt)
        return loss, metrics_mod.compute_all(descale_with(yp, st), descale_with(yt, st), prefix)

    # -- batched noisy scenes -------------------------------------------
    # noisy11/noisyNN scenes are single-snapshot datasets sharing one
    # GraphTemplate: all N scenes go on the batch axis and the metrics come
    # per scene from mask-weighted moments — algebraically the gathered
    # per-trial metrics (utils/metrics.py), one forward instead of N.

    def _scenes_batchable(self, datasets) -> bool:
        if self.cfg.criterion not in ("mse", "mae"):
            return False
        if not isinstance(datasets, (list, tuple)) or len(datasets) < 2:
            return False
        if not all(len(ds.members) == 1 and len(ds.members[0].array) == 1 for ds in datasets):
            return False
        tid = id(datasets[0].members[0].template)
        return all(id(ds.members[0].template) == tid for ds in datasets)

    def _scene_metrics(self, n_scenes, n, prefix, out, y, mask):
        o = out.reshape(n_scenes, n)
        t = y.reshape(n_scenes, n)
        m = mask.reshape(n_scenes, n).to(torch.float32)
        cnt = m.sum(dim=1).clamp(min=1.0)
        if self.cfg.criterion == "mse":
            loss = (torch.square(o - t) * m).sum(dim=1) / cnt
        else:  # mae
            loss = (torch.abs(o - t) * m).sum(dim=1) / cnt
        st = self.stats
        mo = vmap(metrics_mod.masked_moments)(descale_with(o, st), descale_with(t, st), m)
        return loss, metrics_mod.metrics_from_moments(mo, prefix)  # [N], dict of [N]

    @torch.inference_mode()
    def run_scene_trials(
        self,
        datasets,
        n_mask_draws: int,
        prefix: str = "test",
        timer: Optional[Timer] = None,
    ) -> list[dict]:
        """All scenes in one batch, ``n_mask_draws`` mask redraws.

        Returns scene-major trial rows (matching the sequential noisyNN
        loop order): each row has a/s (all-nodes / sensors-only)
        (loss, metrics) scalars, plus timing, read back once."""
        cfg = self.cfg
        tpl = datasets[0].members[0].template
        n = tpl.n_node
        N = len(datasets)
        xs = np.stack([np.asarray(ds.members[0].array[0], np.float32) for ds in datasets])
        x = torch.as_tensor(xs.reshape(-1, 1), device=self.device)  # [N*n, 1]
        graph = self._graph(tpl, N)
        fwd = lambda x_in: self.model(x_in, graph)  # noqa: E731
        req = self._sensor_idx(tpl)
        rng = np.random.default_rng(cfg.seed)
        draws = []   # device values, one read-back at the end
        times = []
        for _ in range(n_mask_draws):
            row = {}
            for sensors in (False, True):
                mask = self._draw_mask(rng, N, n, req if sensors else ())
                x_in = torch.where(mask[:, None], 0.0, x)
                if graph.banded:
                    x_in = graph.pack_nodes(x_in, n)
                f = fwd
                if timer is not None and not sensors:
                    warm = cfg.gpu_warmup_times if not timer.finished_warmup else 0
                    f = timer.auto_measure(fwd, N, warmup_times=warm)
                out = f(x_in)
                if graph.banded:
                    out = graph.unpack_nodes(out, n)
                row["s" if sensors else "a"] = self._scene_metrics(N, n, prefix, out, x, mask)
            if timer is not None:
                times.append((timer.compute_time(N), timer.compute_throughput(N)))
                timer.timings.clear()
                timer.num_graphs.clear()
            draws.append(row)
        keys = list(draws[0]["a"][1])
        # the single read-back: [draw, a/s, loss + metrics, scene]
        host = torch.stack([
            torch.stack([torch.stack([loss, *(mets[k] for k in keys)]) for loss, mets in
                         (row["a"], row["s"])]) for row in draws]).cpu().tolist()
        rows = []
        for i in range(N):          # scene-major like the sequential loop
            for j in range(n_mask_draws):
                (a_loss, *a_mets), (s_loss, *s_mets) = ([v[i] for v in side] for side in host[j])
                rows.append({
                    "loss": a_loss,
                    "mets": dict(zip(keys, a_mets)),
                    "s_loss": s_loss,
                    "s_mets": dict(zip(keys, s_mets)),
                    "time": times[j] if times else None,
                })
        return rows

    @torch.inference_mode()
    def run_trial(
        self,
        dataset: WDNDataset,
        trial: int,
        prefix: str = "test",
        sensors: bool = False,
        timer: Optional[Timer] = None,
        rng: Optional[np.random.Generator] = None,
    ) -> tuple[float, dict]:
        """One pass over the dataset with fresh masks (reference
        test_one_epoch, evaluation.py:240-347)."""
        cfg = self.cfg
        rng = rng or np.random.default_rng(cfg.seed + trial)
        loader = SnapshotLoader(dataset, cfg.batch_size, shuffle=False)
        per_batch = []  # (bs, loss, mets) device scalars
        shared_mask = {}

        for template, xb, _ in loader:
            bs = xb.shape[0]
            n = template.n_node
            req = self._sensor_idx(template) if sensors else ()
            x = torch.as_tensor(np.asarray(xb, np.float32).reshape(-1, 1), device=self.device)
            mkey = (id(template), bs, sensors)
            if cfg.use_same_mask and mkey in shared_mask:
                rng.integers(0, 2**31 - 1)   # the draw the JAX package makes all the same
                mask = shared_mask[mkey]
            else:
                mask = self._draw_mask(rng, bs, n, req)
                shared_mask[mkey] = mask

            graph = self._graph(template, bs)
            if graph.banded:
                # banded graphs run in RCM-permuted padded node space
                x = graph.pack_nodes(x, n)
                mask = graph.pack_nodes(mask.to(torch.float32)[:, None], n)[:, 0] > 0.5
            x_in = torch.where(mask[:, None], 0.0, x)
            fwd = lambda x_in_: self.model(x_in_, graph)  # noqa: E731
            if timer is not None:
                warm = cfg.gpu_warmup_times if (trial == 0 and not timer.finished_warmup) else 0
                out = timer.auto_measure(fwd, bs, warmup_times=warm)(x_in)
            else:
                out = fwd(x_in)

            loss, mets = self._metrics(template, bs, prefix, out, x, mask)
            per_batch.append((bs, loss, mets))

        # one read-back at trial end (a per-batch float() would make the card
        # wait for the host each batch; noisyNN runs N² trials and feels it)
        keys = list(per_batch[0][2])
        host = torch.stack([torch.stack([loss, *(mets[k] for k in keys)])
                            for _, loss, mets in per_batch]).cpu().tolist()
        ntot = max(sum(bs for bs, _, _ in per_batch), 1)
        total_loss = 0.0
        sums: dict[str, float] = {}
        for (bs, _, _), (loss, *mets) in zip(per_batch, host):
            total_loss += loss * bs
            for mk, mv in zip(keys, mets):
                sums[mk] = sums.get(mk, 0.0) + mv * bs
        return total_loss / ntot, {mk: v / ntot for mk, v in sums.items()}

    # -- public API ------------------------------------------------------
    def evaluate(self, datasets, log_fn=print) -> tuple[dict, dict, dict]:
        """Full multi-trial evaluation; ``datasets`` is one WDNDataset
        (clean) or a list (noisy11/noisyNN scenes).

        Returns (loss_dict, metric_dict, sensor_metric_dict) with
        ``*_mean`` / ``*_std`` entries (reference internal_test,
        evaluation.py:739-778)."""
        cfg = self.cfg
        timer = Timer(self.device)
        losses, sensor_losses = [], []
        metric_lists: dict[str, list] = defaultdict(list)
        sensor_metric_lists: dict[str, list] = defaultdict(list)

        def collect_once(ds, trial):
            loss, mets = self.run_trial(ds, trial, "test", sensors=False, timer=timer)
            s_loss, s_mets = self.run_trial(ds, trial, "test", sensors=True)
            losses.append(loss)
            sensor_losses.append(s_loss)
            mets["test_time"] = timer.compute_time(len(ds))
            mets["test_throughput"] = timer.compute_throughput(len(ds))
            for mk, mv in mets.items():
                metric_lists[mk].append(mv)
            for mk, mv in s_mets.items():
                sensor_metric_lists[mk + "_sensor"].append(mv)
            timer.timings.clear()
            timer.num_graphs.clear()

        def collect_rows(rows):
            for row in rows:
                losses.append(row["loss"])
                sensor_losses.append(row["s_loss"])
                mets = dict(row["mets"])
                if row["time"] is not None:
                    mets["test_time"], mets["test_throughput"] = row["time"]
                for mk, mv in mets.items():
                    metric_lists[mk].append(mv)
                for mk, mv in row["s_mets"].items():
                    sensor_metric_lists[mk + "_sensor"].append(mv)

        if cfg.test_type == "clean":
            assert isinstance(datasets, WDNDataset)
            for trial in range(cfg.num_test_trials):
                collect_once(datasets, trial)
        elif cfg.test_type == "noisy11":
            assert isinstance(datasets, (list, tuple))
            if self._scenes_batchable(datasets):
                collect_rows(self.run_scene_trials(datasets, 1, timer=timer))
            else:
                for trial, ds in enumerate(datasets):
                    collect_once(ds, trial)
        elif cfg.test_type == "noisyNN":
            assert isinstance(datasets, (list, tuple))
            if self._scenes_batchable(datasets):
                collect_rows(self.run_scene_trials(datasets, cfg.num_test_trials, timer=timer))
            else:
                t = 0
                for ds in datasets:
                    for _ in range(cfg.num_test_trials):
                        collect_once(ds, t)
                        t += 1
        else:
            raise NotImplementedError(f"test type {cfg.test_type}")

        trials = len(losses)
        loss_dict = {
            "test_loss_mean": float(np.mean(losses)),
            "test_loss_std": float(np.std(losses) + 1e-6),
            "test_loss_sensor_mean": float(np.mean(sensor_losses)),
            "test_loss_sensor_std": float(np.std(sensor_losses) + 1e-6),
        }
        metric_dict = {}
        for mk, vals in metric_lists.items():
            metric_dict[f"{mk}_mean"] = float(np.mean(vals))
            metric_dict[f"{mk}_std"] = float(np.std(vals) + 1e-6)
        sensor_metric_dict = {}
        for mk, vals in sensor_metric_lists.items():
            sensor_metric_dict[f"{mk}_mean"] = float(np.mean(vals))
            sensor_metric_dict[f"{mk}_std"] = float(np.std(vals) + 1e-6)

        summary = ", ".join(
            f"{mk[:-5]}: {v:.4f} +/- {metric_dict[mk[:-5] + '_std']:.4f}"
            for mk, v in metric_dict.items() if mk.endswith("_mean")
        )
        log_fn(f"\nThis TEST experiment reports the average result of {trials} runs.")
        log_fn(
            f"test_loss: {loss_dict['test_loss_mean']:.4f} +/- "
            f"{loss_dict['test_loss_std']:.4f}, {summary}"
        )
        return loss_dict, metric_dict, sensor_metric_dict


def make_noisy_scenes(
    inp_paths: Sequence[str],
    cfg: EvalConfig,
    stats: NormStats,
    edge_attrs=None,
    norm_type: str = "znorm",
    backend: Optional[str] = None,
) -> list[NoisyWDNDataset]:
    """N independent noise scenes (reference evaluation.py:104-127: a list of
    NoisyWDNDataset, one per trial). Scenes share GraphTemplates, so the
    evaluator builds one batched graph for all of them, not one per scene."""
    shared: dict = {}
    return [
        NoisyWDNDataset(
            inp_paths,
            feature=cfg.feature,
            removal=cfg.removal,
            stats=stats,
            edge_attrs=edge_attrs,
            norm_type=norm_type,
            mean_dmd=cfg.mean_dmd,
            std_dmd=cfg.std_dmd,
            seed=cfg.seed + t,
            backend=backend,
            shared_templates=shared,
        )
        for t in range(cfg.num_test_trials)
    ]


def evaluate(
    model,
    cfg: EvalConfig,
    stats: NormStats,
    test_ds=None,
    inp_paths: Optional[Sequence[str]] = None,
    edge_attrs=None,
    norm_type: str = "znorm",
    log_fn=print,
    device="cuda",
):
    """Convenience wrapper: builds noisy scenes if needed, runs the harness."""
    ev = Evaluator(model, cfg, stats, device=device)
    if cfg.test_type in ("noisy11", "noisyNN"):
        assert inp_paths, "noisy tests need inp_paths for online simulation"
        datasets = make_noisy_scenes(inp_paths, cfg, stats, edge_attrs, norm_type)
    else:
        assert test_ds is not None
        datasets = test_ds
    return ev.evaluate(datasets, log_fn=log_fn)
