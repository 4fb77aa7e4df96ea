"""Rank-side drivers of the port's parallel entry points, for the CPU tests.

The tests start ranks through ``parallel.launch`` with :func:`spawn_jobs`,
which puts this directory on the ranks' ``PYTHONPATH``; each rank reads one
spec (a pickle: ``{"jobs": [...], "out": dir}``), runs its jobs in order and
writes its results to ``out/rank<r>.pkl``::

    code = spawn_jobs(4, "/tmp/spec.pkl", device="cpu", threads=1)

A job is a dict with a ``kind`` (a function below) and its inputs as numpy
arrays: the template's edge list, the model's name, arguments and
``state_dict``, the config's fields, batches and explicit masks (the caller
passes masks so that another package's draw can be replayed). Every rank
runs every job, so the process groups are made in the same order on all.
This module imports no JAX and no test module: the ranks import it.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from gnn_pressure_estimation_tpu_torch.core.graph import GraphTemplate
from gnn_pressure_estimation_tpu_torch.parallel.launch import spawn

HERE = os.path.dirname(os.path.abspath(__file__))


def spawn_jobs(n_ranks: int, spec: str, **kw) -> int:
    """``launch.spawn`` of :func:`run` on ``n_ranks`` ranks with the spec at
    ``spec``, this directory on their ``PYTHONPATH``; ``kw`` goes to
    ``spawn``."""
    path = [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]
    if HERE not in path:
        os.environ["PYTHONPATH"] = os.pathsep.join([HERE] + path)
    return spawn(n_ranks, "torch_rank_jobs:run", spec, **kw)


def _template(t: dict) -> GraphTemplate:
    tpl = GraphTemplate(t["n"], t["senders"], t["receivers"], edge_attr=t.get("edge_attr"),
                        node_names=t.get("node_names"))
    if t.get("band"):
        tpl.band_layout(*t["band"])           # the default layout: (block, lane)
    return tpl


def _model(spec: tuple) -> torch.nn.Module:
    from gnn_pressure_estimation_tpu_torch.models.gatres import GATRes
    from gnn_pressure_estimation_tpu_torch.models.zoo import GCN2, GIN, ChebNet

    name, kwargs, state = spec
    model = {"gatres": GATRes, "gin": GIN, "chebnet": ChebNet, "gcn2": GCN2}[name](**kwargs)
    model.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in state.items()})
    return model


def _mesh(job: dict):
    from gnn_pressure_estimation_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(job["dp"], job["gp"], device=job.get("device", "cpu"))


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


class _Threshold:
    """``GraphTemplate.DENSE_THRESHOLD`` set for one job (the tests push small
    templates onto the halo strategy)."""

    def __init__(self, value):
        self.value, self.old = value, GraphTemplate.DENSE_THRESHOLD

    def __enter__(self):
        if self.value is not None:
            GraphTemplate.DENSE_THRESHOLD = self.value

    def __exit__(self, *exc):
        GraphTemplate.DENSE_THRESHOLD = self.old


def halo_exchange(job: dict) -> dict:
    """``parallel.halo.halo_exchange`` on ``x[g]`` and its gradient under the
    cotangent ``cot[g]``."""
    from gnn_pressure_estimation_tpu_torch.parallel.halo import halo_exchange as exchange

    mesh = _mesh(job)
    x = torch.as_tensor(job["x"][mesh.d, mesh.g], device=mesh.device).requires_grad_(True)
    ext = exchange(x, job["U"], job["R"], mesh)
    (ext * torch.as_tensor(job["cot"][mesh.d, mesh.g], device=mesh.device)).sum().backward()
    return _cpu({"ext": ext, "grad": x.grad})


def mesh_step(job: dict) -> dict:
    """``MeshTrainer``: ``len(masks)`` train steps on ``x`` with the given
    masks, then (with ``eval_mask``) one eval step. Returns the losses,
    metrics, parameters and optimizer state after the steps."""
    from gnn_pressure_estimation_tpu_torch.parallel.trainer import MeshTrainer
    from gnn_pressure_estimation_tpu_torch.train import TrainConfig
    from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats

    with _Threshold(job.get("dense_threshold")):
        mesh = _mesh(job)
        tpl = _template(job["template"])
        tr = MeshTrainer(_model(job["model"]), TrainConfig(**job["cfg"]),
                         NormStats(**job["stats"]), tpl, mesh)
        res = {"strategy": tr.strategy, "losses": [], "mets": []}
        for m in job["masks"]:
            loss, mets = tr.train_step(tpl, job["x"], mask=m)
            res["losses"].append(float(loss))
            res["mets"].append({k: float(v) for k, v in mets.items()})
        if job.get("eval_mask") is not None:
            loss, mets, out, mask = tr.eval_step(tpl, job["x"], mask=job["eval_mask"])
            res["eval"] = {"loss": float(loss), "mets": {k: float(v) for k, v in mets.items()},
                           "out": out, "mask": mask}
        res["state"] = tr.model.state_dict()
        res["opt"] = tr.opt_state_dict()
        return _cpu(res)


def dist_step(job: dict) -> dict:
    """``DistributedTrainer``: one step per mask on ``x`` [dp·B, n]."""
    from gnn_pressure_estimation_tpu_torch.parallel.distributed import DistributedTrainer
    from gnn_pressure_estimation_tpu_torch.train import TrainConfig
    from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats

    mesh = _mesh(job)
    tpl = _template(job["template"])
    dtr = DistributedTrainer(_model(job["model"]), TrainConfig(**job["cfg"]),
                             NormStats(**job["stats"]), tpl, mesh)
    res = {"losses": [], "mets": [], "grads": []}
    for m in job["masks"]:
        loss, mets = dtr.step(job["x"], mask=m)
        res["losses"].append(float(loss))
        res["mets"].append({k: float(v) for k, v in mets.items()})
        res["grads"].append({k: p.grad.detach().clone() for k, p in dtr.model.named_parameters()})
    res["state"] = dtr.model.state_dict()
    return _cpu(res)


def fit_resume(job: dict) -> dict:
    """``MeshTrainer.fit`` for ``cfg.epochs`` epochs in ``dir/full``; then one
    epoch in ``dir/part``, a fresh trainer restored from its last checkpoint
    and fitted to the end. Returns both runs' parameters and optimizer
    states and their best records."""
    from gnn_pressure_estimation_tpu_torch.data.dataset import WDNDataset, _Member
    from gnn_pressure_estimation_tpu_torch.parallel.trainer import MeshTrainer
    from gnn_pressure_estimation_tpu_torch.train import TrainConfig
    from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats

    with _Threshold(job.get("dense_threshold")):
        mesh = _mesh(job)
        tpl = _template(job["template"])
        stats = NormStats(**job["stats"])

        def ds(a):
            return WDNDataset.from_members([_Member(tpl, np.asarray(a, np.float32), [], None)],
                                           stats)
        train, val = ds(job["train"]), ds(job["val"])
        out = {}
        for tag, epochs, resume in (("full", None, None), ("part", 1, None),
                                    ("resumed", None, "part")):
            kw = dict(job["cfg"])
            kw["save_path"] = os.path.join(job["dir"], resume or tag)
            if epochs:
                kw["epochs"] = epochs
            tr = MeshTrainer(_model(job["model"]), TrainConfig(**kw), stats, tpl, mesh)
            if resume:
                tr.restore(tr._ckpt_path("last"), log_fn=lambda *_: None)
            best = tr.fit(train, val, log_fn=lambda *_: None)
            out[tag] = {"state": tr.model.state_dict(), "opt": tr.opt_state_dict(),
                        "best": {k: best[k] for k in ("loss", "epoch")}}
        return _cpu(out)


def evaluate(job: dict) -> dict:
    """``Evaluator(mesh=...)``: ``evaluate`` on a clean dataset (``x`` [S, n])
    or on noise scenes (``scenes`` [N, n], one snapshot each, one template),
    each mask the harness asks for taken in order from ``masks``."""
    from gnn_pressure_estimation_tpu_torch.data.dataset import WDNDataset, _Member
    from gnn_pressure_estimation_tpu_torch.evaluation import EvalConfig, Evaluator, harness
    from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats

    masks = list(job["masks"])
    draw = harness.batch_node_mask

    def replay(generator, n_graph, n, mask_rate, required_idx=None, shared=False, device="cpu"):
        m = masks.pop(0)
        if m.shape != (n_graph * n,):
            raise ValueError(f"replayed mask of shape {m.shape} for {n_graph} graphs of {n}")
        return torch.as_tensor(m, dtype=torch.bool, device=device)

    with _Threshold(job.get("dense_threshold")):
        mesh = _mesh(job)
        tpl = _template(job["template"])
        stats = NormStats(**job["stats"])

        def ds(a):
            return WDNDataset.from_members([_Member(tpl, np.asarray(a, np.float32), [], None)],
                                           stats)
        data = ds(job["x"]) if "x" in job else [ds(s[None]) for s in job["scenes"]]
        harness.batch_node_mask = replay
        try:
            ev = Evaluator(_model(job["model"]), EvalConfig(**job["cfg"]), stats, mesh=mesh)
            got = ev.evaluate(data, log_fn=lambda *_: None)
        finally:
            harness.batch_node_mask = draw
        return {"result": got, "masks_left": len(masks)}


def spmm(job: dict) -> dict:
    """``ops.segment.spmm`` with ``axis`` on the edge partition of ``B``
    copies of the template: this rank's block of the output and of the
    gradient of x under the cotangent ``cot``, weighted by ``weight`` (the
    GCN weights over the self-loop list, or none)."""
    from gnn_pressure_estimation_tpu_torch.ops import segment
    from gnn_pressure_estimation_tpu_torch.parallel.edgepart import partition_graph

    mesh = _mesh(job)
    tpl = _template(job["template"])
    part = partition_graph(tpl, job["B"], mesh.gp)
    graph = part.local_graph(mesh.g, mesh)
    blk = slice(mesh.g * part.block, (mesh.g + 1) * part.block)

    def own(a):
        full = np.zeros((part.n_node_global,) + a.shape[1:], np.float32)
        full[:len(a)] = a
        return torch.as_tensor(full[blk], device=mesh.device)
    x = own(job["x"]).requires_grad_(True)
    sl = job["self_loops"]
    out = segment.spmm(x, graph.edges_sl if sl else graph.edges,
                       graph.gcn_norm if sl else None, mesh,
                       graph.edge_mask_sl if sl else graph.edge_mask)
    (out * own(job["cot"])).sum().backward()
    return _cpu({"out": out, "grad": x.grad})


def lost_rank(job: dict) -> dict:
    """Rank ``job["lost"]`` leaves at once (exit 17, no teardown) while the
    others wait in an all-reduce that needs it: the launch must end, not
    hang."""
    mesh = _mesh(job)
    if mesh.rank == job["lost"]:
        os._exit(17)
    mesh.all_reduce(torch.ones(4))
    return {}


def run(payload: str) -> int:
    """The launch entry point: run the spec's jobs, write this rank's results."""
    with open(payload, "rb") as f:
        spec = pickle.load(f)
    rank = dist.get_rank()
    results = [globals()[job["kind"]](job) for job in spec["jobs"]]
    with open(os.path.join(spec["out"], f"rank{rank}.pkl"), "wb") as f:
        pickle.dump({"results": results}, f)
    return 0
