"""Batch inference: reconstruct full pressure fields from sparse sensor
readings — the serving surface.

The counterpart of ``gnn_pressure_estimation_tpu/evaluation/infer.py``: one
masked forward pass per snapshot, keeping the descaled field. The model
input is the scaled field with unobserved nodes zeroed; the output is
descaled with the normalization stats; observed nodes are served at their
readings. The observed set can be explicit node names, the sensors plug-in
(``evaluation/sensors.py``), or a seeded random draw at ``1 - mask_rate``
density. :class:`InferenceResult` writes the fields as ``.npz`` or ``.csv``
in the JAX package's layout.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from gnn_pressure_estimation_tpu_torch.device import resolve_device
from gnn_pressure_estimation_tpu_torch.utils import tracing
from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats, descale_with, scale_with


@dataclass
class InferenceResult:
    """Full-field estimates for a batch of snapshots (physical units)."""

    node_names: list
    pred: np.ndarray              # [S, n] descaled predictions
    observed: np.ndarray          # [n] bool — nodes whose values were given
    true: Optional[np.ndarray] = None   # [S, n] descaled ground truth if known
    metrics: dict = field(default_factory=dict)  # on hidden nodes, if truth

    def save_npz(self, path: str):
        payload = dict(
            node_names=np.asarray(self.node_names),
            pred=self.pred,
            observed=self.observed,
        )
        if self.true is not None:
            payload["true"] = self.true
        np.savez(path, **payload)

    def save_csv(self, path: str):
        import csv

        with open(path, "w", newline="") as f:
            wr = csv.writer(f)
            cols = ["snapshot", "node", "observed", "pred"]
            if self.true is not None:
                cols += ["true", "abs_error"]
            wr.writerow(cols)
            for s in range(self.pred.shape[0]):
                for i, name in enumerate(self.node_names):
                    row = [s, name, int(self.observed[i]),
                           f"{self.pred[s, i]:.6g}"]
                    if self.true is not None:
                        row += [f"{self.true[s, i]:.6g}",
                                f"{abs(self.pred[s, i] - self.true[s, i]):.6g}"]
                    wr.writerow(row)


class Inferencer:
    """Masked forward for serving, on ``device`` (the card by default; raises
    if none is present).

    The model holds its weights; it is moved to ``device`` and put in eval
    mode. The ``BatchedGraph`` is built once per (template, batch size) and
    reused, so steady-state cost is one forward per batch. ``agg_mode``
    (``None``, ``"dense"``, ``"banded"`` or ``"padded"``), ``band_block`` and
    ``band_attn`` go to ``GraphTemplate.batch``. Only a banded graph works in
    its own node order (``pack_nodes``); the others take the template's.
    """

    def __init__(self, model: torch.nn.Module, stats: NormStats,
                 agg_mode: Optional[str] = None, band_block: Optional[int] = None,
                 device="cuda", band_attn: Optional[str] = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.stats = stats
        self.agg_mode = agg_mode
        self.band_block = band_block
        self.band_attn = band_attn
        self._graphs: dict = {}

    def _graph(self, template, bs: int):
        key = (id(template), bs)
        if key not in self._graphs:
            self._graphs[key] = template.batch(bs, mode=self.agg_mode,
                                               band_block=self.band_block,
                                               device=self.device, band_attn=self.band_attn)
        return self._graphs[key]

    def observed_indices(
        self,
        template,
        observed: str | Sequence[str],
        test_input_path: Optional[str] = None,
        mask_rate: float = 0.95,
        seed: int = 0,
    ) -> np.ndarray:
        """Resolve the observed-node set to indices in template node order.

        ``observed`` is either a sequence of node names, the string
        ``"sensors"`` (evaluation/sensors.py plug-in), or ``"random"``
        (seeded draw keeping ``round(n · (1 - mask_rate))`` nodes — the
        training distribution's observation density).
        """
        n = template.n_node
        names = list(template.node_names or [])
        if isinstance(observed, str) and observed == "random":
            rng = np.random.default_rng(seed)
            n_obs = max(1, n - int(round(n * mask_rate)))
            return np.sort(rng.choice(n, size=n_obs, replace=False))
        if isinstance(observed, str) and observed == "sensors":
            from gnn_pressure_estimation_tpu_torch.evaluation.sensors import get_sensors

            if not test_input_path:
                raise ValueError("observed='sensors' needs test_input_path")
            idx, found = get_sensors(test_input_path)
            if not idx:
                raise ValueError(
                    "no sensors configured (mysecrets.py absent) — pass "
                    "explicit node names or observed='random'"
                )
            # sensor indices are in canonical INP order; map into the
            # template's kept order by name
            if names:
                lookup = {nm: i for i, nm in enumerate(names)}
                return np.array(sorted(lookup[nm] for nm in found if nm in lookup))
            return np.asarray(idx)
        if not names:
            raise ValueError("template carries no node names; pass indices")
        lookup = {nm: i for i, nm in enumerate(names)}
        missing = [nm for nm in observed if nm not in lookup]
        if missing:
            raise ValueError(f"unknown node names: {missing}")
        return np.array(sorted(lookup[nm] for nm in observed))

    @torch.inference_mode()
    def infer(
        self,
        template,
        values: np.ndarray,
        observed_idx: np.ndarray,
        scaled: bool = False,
        batch_size: int = 32,
        with_truth: bool = False,
    ) -> InferenceResult:
        """Reconstruct full fields.

        ``values`` is ``[S, n]`` (full snapshots, of which only
        ``observed_idx`` columns are consumed) or ``[S, k]`` (readings for
        the k observed nodes only), in physical units unless ``scaled``.
        ``with_truth`` treats full-width ``values`` as ground truth for
        hidden-node error metrics.

        Spans (``utils.tracing``): ``infer`` (attributes ``S``,
        ``batch_size``, ``observed``) over ``infer.scale`` (widen, scale,
        mask on the host); per chunk ``infer.upload`` (graph lookup, upload,
        node packing; ``h2d_bytes``), ``infer.forward`` (model, descale,
        unpacking, enqueued) and ``infer.readback`` (the host waits for the
        fields; ``d2h_bytes``); and ``infer.serve`` (metrics, readings
        served, the result).
        """
        n = template.n_node
        values = np.atleast_2d(np.asarray(values, np.float32))
        S = values.shape[0]
        with tracing.span("infer", S=S, batch_size=batch_size) as root:
            with tracing.span("infer.scale"):
                obs = np.zeros(n, bool)
                obs[np.asarray(observed_idx, int)] = True
                k = int(obs.sum())
                root.set(observed=k)

                if values.shape[1] == n:
                    full = values
                elif values.shape[1] == k:
                    full = np.zeros((S, n), np.float32)
                    full[:, obs] = values
                else:
                    raise ValueError(f"values width {values.shape[1]} is neither n={n} nor k={k}")
                truth = full if (with_truth and values.shape[1] == n) else None

                scaled_full = full if scaled else np.asarray(scale_with(full, self.stats),
                                                             np.float32)
                x_obs = np.where(obs[None, :], scaled_full, 0.0).astype(np.float32)

            preds = np.empty((S, n), np.float32)
            for lo in range(0, S, batch_size):
                chunk = x_obs[lo:lo + batch_size]
                bs = chunk.shape[0]
                with tracing.span("infer.upload", h2d_bytes=chunk.nbytes):
                    graph = self._graph(template, bs)
                    x = torch.from_numpy(chunk.reshape(-1, 1)).to(self.device)
                    if graph.banded:
                        x = graph.pack_nodes(x, n)
                with tracing.span("infer.forward"):
                    out = descale_with(self.model(x, graph), self.stats)
                    if graph.banded:
                        out = graph.unpack_nodes(out, n)
                    out = out.reshape(bs, -1)[:, :n]
                with tracing.span("infer.readback", d2h_bytes=out.numel() * out.element_size()):
                    preds[lo:lo + bs] = out.cpu().numpy()

            with tracing.span("infer.serve"):
                return self._serve(template, preds, full, obs, k, truth, scaled)

    def _serve(self, template, preds, full, obs, k, truth, scaled) -> InferenceResult:
        """The result from the model's fields ``preds``: hidden-node metrics
        where ``truth`` is given, observed nodes served at their readings."""
        n = template.n_node
        if truth is not None and not scaled:
            true_phys = truth
        elif truth is not None:
            true_phys = np.asarray(descale_with(truth, self.stats), np.float32)
        else:
            true_phys = None

        metrics = {}
        if true_phys is not None and (~obs).any():
            diff = preds[:, ~obs] - true_phys[:, ~obs]
            metrics = {
                "hidden_mae": float(np.mean(np.abs(diff))),
                "hidden_rmse": float(np.sqrt(np.mean(diff ** 2))),
                "hidden_max_abs": float(np.max(np.abs(diff))),
                "n_hidden": int((~obs).sum()),
                "n_observed": k,
            }
        # observed nodes are known exactly — serve the readings, not the
        # model's re-estimate of them
        preds_served = preds.copy()
        preds_served[:, obs] = (full if not scaled else np.asarray(
            descale_with(full, self.stats), np.float32))[:, obs]

        return InferenceResult(
            node_names=list(template.node_names or range(n)),
            pred=preds_served,
            observed=obs,
            true=true_phys,
            metrics=metrics,
        )
