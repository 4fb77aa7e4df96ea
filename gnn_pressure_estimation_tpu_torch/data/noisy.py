"""Online-simulation datasets: ground truth regenerated by the hydraulic
solver, with optional Gaussian demand noise.

Reference parity: ``NoisyWDNDataset`` (DataLoader.py:261-423) — used by the
evaluation harness as the *oracle* for noisy11/noisyNN robustness tests
(SURVEY §4). Demand perturbation follows DataLoader.py:317-323:
``d ← d + N(mean_dmd, std_dmd)·d`` applied only when the result is
non-negative. (The reference's epynet path accidentally pops ``std_dmd`` with
the wrong key so its noise std is always 0 — fixed here, SURVEY §2 quirk.)

The simulation engine is the in-repo GGA solver (C++ component when built)
instead of wntr/epynet ctypes.

A copy of ``gnn_pressure_estimation_tpu/data/noisy.py`` on the port's own
``WDNDataset`` and solver copy: the same seed gives the same perturbed
demands, draw for draw.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from gnn_pressure_estimation_tpu_torch.data.dataset import (
    WDNDataset,
    _Member,
    build_template,
    get_keep_list,
)
from gnn_pressure_estimation_tpu_torch.data.inp import parse_inp
from gnn_pressure_estimation_tpu_torch.simgen.network_state import build_state
from gnn_pressure_estimation_tpu_torch.simgen.solver_api import solve
from gnn_pressure_estimation_tpu_torch.utils.scaling import (
    NormStats,
    scale_with,
    scale_edges_with,
)


class NoisyWDNDataset(WDNDataset):
    """One freshly-simulated snapshot per INP, optionally demand-perturbed."""

    def __init__(
        self,
        inp_paths: Sequence[str],
        feature: str = "pressure",
        removal: str = "keep_junction",
        stats: Optional[NormStats] = None,
        edge_attrs: Optional[Sequence[str]] = None,
        norm_type: str = "znorm",
        mean_dmd: float = 0.05,
        std_dmd: float = 0.2,
        seed: Optional[int] = None,
        backend: Optional[str] = None,
        shared_templates: Optional[dict] = None,
    ):
        self.mean_dmd = mean_dmd
        self.std_dmd = std_dmd
        self._rng = np.random.default_rng(seed)
        self._backend = backend
        # the evaluator caches batched graphs by template identity: scenes
        # that share a dict reuse one GraphTemplate per INP, so N noise scenes
        # build one BatchedGraph (and band index) instead of N (only safe
        # without per-template edge-attr scaling, which mutates
        # template.edge_attr)
        self._shared_templates = (
            shared_templates if (shared_templates is not None and not edge_attrs)
            else None
        )
        self.feature = feature
        self.from_set = "sim"
        self.norm_type = norm_type
        self.edge_attrs = tuple(edge_attrs) if edge_attrs else None
        self.members = []

        for ip in inp_paths:
            self.members.append(self._simulate(ip, feature, removal))

        if stats is None:
            flat = np.concatenate([m.array.ravel() for m in self.members])
            stats = NormStats.from_array(flat, norm_type)
            if self.edge_attrs:
                edge_flat = np.concatenate(
                    [m.template.edge_attr for m in self.members], axis=0
                )
                stats = stats.with_edge_stats(edge_flat)
        self.stats = stats

        if norm_type in ("znorm", "minmax"):
            for m in self.members:
                m.array = scale_with(m.array, stats).astype(np.float32)
                if self.edge_attrs and m.template.edge_attr is not None:
                    m.template.edge_attr = scale_edges_with(
                        m.template.edge_attr, stats
                    ).astype(np.float32)
        else:
            for m in self.members:
                m.array = m.array.astype(np.float32)

        self._lengths = [len(m.array) for m in self.members]
        self.length = sum(self._lengths)

    def _simulate(self, inp_path, feature, removal):
        wn = parse_inp(inp_path)
        ns = build_state(wn)
        nj = ns.n_junctions
        if self.mean_dmd != 0.0 or self.std_dmd != 0.0:
            noise = self._rng.normal(self.mean_dmd, self.std_dmd, nj)
            perturbed = ns.demand[:nj] + noise * ns.demand[:nj]
            keep = perturbed >= 0  # negative results keep the original demand
            ns.demand[:nj] = np.where(keep, perturbed, ns.demand[:nj])
        res = solve(ns, backend=self._backend)
        if feature == "pressure":
            values = res.pressure
        elif feature == "head":
            values = res.head
        elif feature == "flow":
            values = res.flow
        else:
            raise KeyError(f"feature {feature!r} unsupported for simulation")

        keep_list = get_keep_list(wn, removal, None, feature)
        if keep_list is not None and feature in ("pressure", "head"):
            keep = set(keep_list)
            idx = [i for i, n in enumerate(wn.node_names) if n in keep]
            values = values[idx]
        cache_key = (inp_path, feature, removal)
        if self._shared_templates is not None and cache_key in self._shared_templates:
            tpl, kept = self._shared_templates[cache_key]
        else:
            tpl, kept = build_template(wn, keep_list, self.edge_attrs, name=inp_path)
            if self._shared_templates is not None:
                self._shared_templates[cache_key] = (tpl, kept)
        return _Member(
            template=tpl,
            array=np.reshape(np.asarray(values, np.float64), (1, -1)),
            kept_names=kept,
            wn=wn,
        )
