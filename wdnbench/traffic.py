"""The one generator of traffic: a closed loop of one client, in two kinds.

- ``serve``: each request is ``Inferencer.infer`` on ``batch`` snapshots of
  sensor readings (the sensor set drawn once a run; fresh readings, in
  metres, every request); the fields come back to the host.
- ``train``: each step is ``Trainer.train_step`` on ``batch`` snapshots from
  a seeded pool in host memory, with a seeded mask handed in through
  ``mask=``; the losses are read back once, when the window closes.

A mix (``workloads/<traffic>.json``) sets the sizes; the configuration
(``configs/<config>.json``) the model and the network. The program is
driven through its entry points only; the reference gets the same inputs.
"""

from __future__ import annotations

import contextlib
import importlib
import time
from pathlib import Path

import numpy as np
import torch

from wdnbench import check, inputs, network, reference
from wdnbench.counts import Shapes

PROGRAM = "gnn_pressure_estimation_tpu_torch"


def program_dir() -> Path:
    return Path(importlib.import_module(PROGRAM).__file__).parent


def percentile(values, q: float) -> float:
    """The ``q``-th percentile by linear interpolation between order statistics."""
    return float(np.percentile(np.asarray(values, np.float64), q))


class Run:
    """What both kinds share: the network, read by both sides from the
    configuration's file, the program's graph and kernels, the seeded
    weights, and the reference's own graph."""

    def __init__(self, cell, seed: int, dev: torch.device):
        self.cell, self.seed, self.dev = cell, int(seed), dev
        self.cfg, self.mix = cell.config, cell.traffic
        self.batch = int(self.mix["batch"])
        m = self.cfg["model"]
        self.model_dims = {k: m[k] for k in ("blocks", "heads1", "heads2")}
        self.weight_shapes = inputs.param_shapes(m["blocks"], m["channels"], m["heads1"],
                                                 m["heads2"])
        self.text = network.read_text(cell.root / self.cfg["network"]["file"])
        self.setup_times = {}
        self.attempted = self.failed = 0

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def feed(self, n: int):
        """Draw from the seed everything both sides are fed for a network of
        ``n`` nodes: the weights, on the device, and the kind's own inputs."""
        self.n = n
        self.weights0 = inputs.make_weights(self.weight_shapes, self.seed, self.dev)

    def _program_setup(self):
        from gnn_pressure_estimation_tpu_torch.data.dataset import build_template, get_keep_list
        from gnn_pressure_estimation_tpu_torch.data.inp import parse_inp
        from gnn_pressure_estimation_tpu_torch.models.presets import select_model

        net, m = self.cfg["network"], self.cfg["model"]
        t0 = time.perf_counter()
        wn = parse_inp(self.text)
        self.template, _ = build_template(
            wn, get_keep_list(wn, net["removal"], None, "pressure"), None, name=net["name"])
        self.graph = self.template.batch(self.batch, device=self.dev)
        self.sync()
        self.setup_times["graph_build_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.shapes = Shapes(B=self.batch, n=self.template.n_node, E=self.template.n_edge,
                             blocks=m["blocks"], channels=m["channels"], heads1=m["heads1"],
                             heads2=m["heads2"])
        self.feed(self.template.n_node)
        self.model, self.preset = select_model(m["preset"], device=self.dev)
        self.model.load_state_dict(self.weights0, strict=True)
        torch.set_float32_matmul_precision(self.cfg["matmul_precision"])
        self.sync()
        self.setup_times["model_s"] = time.perf_counter() - t0

    @contextlib.contextmanager
    def warming_up(self):
        """Time the warm-up, and within it the program's loads of its CUDA
        kernels (``ops._build.load``: built first in a checkout's first run),
        which its first calls make for just the kernels the cell's path
        uses."""
        from gnn_pressure_estimation_tpu_torch.ops import _build

        load, spent, names = _build.load, [0.0], set()

        def timed_load(name):
            t0 = time.perf_counter()
            try:
                return load(name)
            finally:
                spent[0] += time.perf_counter() - t0
                names.add(name)

        t0 = time.perf_counter()
        _build.load = timed_load
        try:
            yield
            self.sync()
        finally:
            _build.load = load
        self.setup_times["warmup_s"] = time.perf_counter() - t0
        if names:
            self.setup_times["kernel_load_s"] = spent[0]
            self.setup_times["kernels_loaded"] = sorted(names)

    def _reference_graph(self):
        names, s, r = network.junction_graph(self.text)
        return reference.Graph(len(names), s, r, self.dev)

    def finish(self):
        """After the window and the memory's peak: the last of the program's
        work that the check reads."""

    def release(self):
        """Free the program's state, so that the reference runs in memory of its own."""
        for attr in ("model", "template", "graph", "inferencer", "trainer", "preset"):
            if hasattr(self, attr):
                delattr(self, attr)


class ServeRun(Run):
    def feed(self, n: int):
        super().feed(n)
        mix = self.mix
        self.mean, self.std = float(mix["value_mean_m"]), float(mix["value_std_m"])
        k = n - int(n * float(mix["mask_rate"]))
        self.observed = inputs.observed_nodes(self.seed, n, k)
        self.base = inputs.sensor_base(self.seed, k, self.mean, self.std)

    def setup(self):
        from gnn_pressure_estimation_tpu_torch.evaluation.infer import Inferencer
        from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats

        self._program_setup()
        self.inferencer = Inferencer(self.model, NormStats(norm_type="znorm", mean=self.mean,
                                                           std=self.std), device=self.dev)
        self.preds, self.latency = [], []
        with self.warming_up():
            for i in range(int(self.mix["warmup_batches"])):
                self._infer(self._readings(i, inputs.WARMUP))

    def _readings(self, index: int, stream: int = inputs.READINGS) -> np.ndarray:
        return inputs.reading_batch(self.seed, index, self.batch, self.base, self.std, stream)

    def _infer(self, readings: np.ndarray) -> np.ndarray:
        return self.inferencer.infer(self.template, readings, self.observed,
                                     batch_size=self.batch).pred

    def iteration(self):
        readings = self._readings(len(self.preds))
        t0 = time.perf_counter()
        pred = self._infer(readings)
        self.latency.append(time.perf_counter() - t0)
        self.preds.append(pred)
        self.attempted += 1
        self.failed += int(not np.isfinite(pred).all())

    def settle(self):
        """Every request has returned its fields already."""

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.iteration()
        span = time.perf_counter() - t0
        return {"serve_snapshots_per_s": self.batch * len(self.preds) / span,
                "serve_batch_p95_ms": 1e3 * percentile(self.latency, 95),
                "_window": {"batches": len(self.latency), "latency_ms": {
                    f"p{q}": 1e3 * percentile(self.latency, q) for q in (5, 50, 90, 95, 99, 100)}}}

    def check(self) -> dict:
        """The sampled requests' fields against the reference's."""
        picks = inputs.sample(self.seed, len(self.preds), int(self.mix["check_batches"]))
        g = self._reference_graph()
        p = {k: v.to(self.dev) for k, v in self.weights0.items()}
        readings = np.concatenate([self._readings(int(i)) for i in picks])
        with reference.precision("highest"):
            ref = reference.serve(p, torch.as_tensor(readings, device=self.dev), self.observed,
                                  self.mean, self.std, g, self.model_dims,
                                  int(self.mix["reference_rows"])).cpu().numpy()
        pred = np.concatenate([self.preds[int(i)] for i in picks])
        return check.serve_numbers(pred, ref, readings, self.observed, self.mean)


class TrainRun(Run):
    def feed(self, n: int):
        super().feed(n)
        mix = self.mix
        self.hidden = int(n * float(mix["mask_rate"]))
        self.pool = inputs.snapshot_pool(self.seed, int(mix["pool_snapshots"]), n)
        self.masks = inputs.mask_pool(self.seed, int(mix["pool_masks"]), self.batch, n,
                                      self.hidden)

    def setup(self):
        from gnn_pressure_estimation_tpu_torch.train.loop import Trainer
        from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats

        self._program_setup()
        self.trainer = Trainer(self.model, self.preset.train_config(
            batch_size=self.batch, mask_rate=float(self.mix["mask_rate"])),
            NormStats(norm_type="znorm"), self.template, device=self.dev)
        self.step = 0
        self.losses = []
        # the first steps, through the window's own call and feed, are the
        # warm-up and the ones the reference follows
        prog = {"params0": check.to_host(self.weights0), "losses": []}
        with self.warming_up():
            moment = self._first_moments()
            for s in range(int(self.mix["checked_steps"])):
                prog["losses"].append(self.iteration())
                if s == 0:
                    prog["grad1"] = self._received(moment)
            prog["params"] = check.to_host(dict(self.model.named_parameters()))
            prog["losses"] = [float(v) for v in torch.stack(prog["losses"]).cpu()]
        self.prog = prog
        self.losses = []

    def _first_moments(self) -> dict:
        """Adam's first moment of each leaf; a state it never wrote reads as zero."""
        state = self.trainer.optimizer.state
        return {n: state.get(p, {}).get("exp_avg", torch.zeros_like(p)).detach().clone()
                for n, p in self.model.named_parameters()}

    def _received(self, before: dict) -> dict:
        """The gradient Adam received in the step just taken, decay added: its
        first moment moves as m' = b1·m + (1 - b1)·g."""
        b1 = self.trainer.optimizer.param_groups[0]["betas"][0]
        after = self._first_moments()
        return check.to_host({n: (after[n] - b1 * before[n]) / (1 - b1) for n in after})

    def batch_of(self, j: int):
        rows = (j * self.batch + np.arange(self.batch)) % self.pool.shape[0]
        return self.pool[rows], self.masks[j % self.masks.shape[0]]

    def iteration(self):
        xb, mask = self.batch_of(self.step)
        loss, _ = self.trainer.train_step(self.template, xb, mask=mask)
        self.step += 1
        self.losses.append(loss)
        return loss

    def settle(self):
        """Read the window's losses back, once: the host has run ahead."""
        losses = torch.stack(self.losses).cpu()
        self.attempted = len(losses)
        self.failed = int((~torch.isfinite(losses)).sum())

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.iteration()
        self.settle()
        span = time.perf_counter() - t0
        return {"train_snapshots_per_s": self.batch * self.attempted / span,
                "_window": {"steps": self.attempted}}

    def reference_batches(self, first: int, count: int):
        out = []
        for j in range(first, first + count):
            xb, mask = self.batch_of(j)
            out.append((torch.as_tensor(xb, device=self.dev),
                        torch.as_tensor(mask.reshape(self.batch, self.n), device=self.dev)))
        return out

    def finish(self):
        """One more step through ``train_step``, on the next batch, from the
        state the window left: the weights it starts from and the gradient
        Adam received in it."""
        self.prog["wparams"] = check.to_host(dict(self.model.named_parameters()))
        self.wstep = self.step
        moment = self._first_moments()
        self.iteration()
        self.prog["wgrad"] = self._received(moment)

    def check(self) -> dict:
        """The first steps' losses, first gradient and change of the weights,
        and the gradient at the window's end, against the reference's. The
        reference follows the first steps from the seeded weights; at the
        window's end it starts from the program's weights, as no reference
        can follow thousands of steps within a run."""
        g = self._reference_graph()
        p0 = {k: v.to(self.dev) for k, v in self.weights0.items()}
        opt = self.mix["optimizer"]
        with reference.precision("highest"):
            ref = reference.train(p0, self.reference_batches(0, len(self.prog["losses"])),
                                  self.hidden, g, self.model_dims, opt,
                                  int(self.mix["reference_rows"]))
            ref = {"losses": ref["losses"], "grad1": check.to_host(ref["grad1"]),
                   "params": check.to_host(ref["params"]), "params0": check.to_host(p0)}
            if "wgrad" in self.prog:
                ref["wgrad"] = self.reference_grad(self.prog["wparams"], self.wstep, g)
        return check.train_numbers(self.prog, ref)

    def reference_grad(self, params: dict, step: int, g) -> dict:
        """The reference's gradient of batch ``step`` at ``params``, as Adam
        receives it (decay added), on the host."""
        p = {k: v.to(self.dev) for k, v in params.items()}
        (x, mask), = self.reference_batches(step, 1)
        _, grads = reference.loss_and_grad(p, x, mask, self.hidden, g, self.model_dims,
                                           int(self.mix["reference_rows"]))
        wd = self.mix["optimizer"]["weight_decay"]
        return check.to_host({k: grads[k] + wd * p[k] for k in p})


KINDS = {"serve": ServeRun, "train": TrainRun}
