"""Template building from an INP topology and the snapshot dataset (numpy
only).

The counterparts of ``get_keep_list``, ``build_template``, ``WDNDataset`` and
``SnapshotLoader`` in ``gnn_pressure_estimation_tpu/data/dataset.py``. The
zarr-zip store is not ported yet, so a :class:`WDNDataset` is built from
arrays in memory (:meth:`WDNDataset.from_members`); building one from zips
raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from gnn_pressure_estimation_tpu_torch.core.graph import GraphTemplate
from gnn_pressure_estimation_tpu_torch.data.inp import WaterNetwork
from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats

REMOVALS = ("keep_list", "reservoir", "tank", "keep_junction", "keep_all")


def get_keep_list(
    wn: WaterNetwork, removal: str, root_attrs: Optional[dict], feature: str
) -> Optional[list[str]]:
    """Node-name keep list per removal strategy (reference DataLoader.py:40-58)."""
    if removal == "keep_list":
        if root_attrs and "ordered_name_list" in root_attrs:
            return root_attrs["ordered_name_list"]
        if (
            root_attrs
            and "ordered_names_by_attr" in root_attrs
            and feature in root_attrs["ordered_names_by_attr"]
        ):
            return root_attrs["ordered_names_by_attr"][feature]
        return wn.junction_names
    if removal == "reservoir":
        rs = set(wn.reservoir_names)
        return [n for n in wn.node_names if n not in rs] if rs else None
    if removal == "tank":
        ts = set(wn.tank_names)
        return [n for n in wn.node_names if n not in ts] if ts else None
    if removal == "keep_junction":
        return wn.junction_names
    if removal == "keep_all":
        return None
    raise ValueError(f"removal {removal!r} not in {REMOVALS}")


def build_template(
    wn: WaterNetwork,
    keep_list: Optional[list[str]],
    edge_attrs: Optional[Sequence[str]],
    name: str = "wdn",
) -> tuple[GraphTemplate, list[str]]:
    """GraphTemplate over the kept node subset, with per-directed-edge
    attributes gathered from link attributes (diameter/length/...)."""
    n_kept, senders, receivers, kept_names, link_ids = wn.to_edges(keep_list)
    edge_attr = None
    if edge_attrs:
        per_link = np.stack(
            [wn.link_attribute(a) for a in edge_attrs], axis=1
        )  # [n_links, d]
        edge_attr = per_link[link_ids].astype(np.float32)  # [n_directed_edges, d]
    tpl = GraphTemplate(
        n_kept, senders, receivers, edge_attr=edge_attr,
        node_names=kept_names, name=name,
    )
    return tpl, kept_names


@dataclasses.dataclass
class _Member:
    template: GraphTemplate
    array: np.ndarray          # [S, n_kept] snapshots, scaled
    kept_names: list
    wn: Optional[WaterNetwork]


class WDNDataset:
    """Multi-network snapshot dataset: one :class:`_Member` (template and
    ``[S, n]`` scaled snapshots) per network, and the normalization
    statistics they were scaled with."""

    def __init__(self, zip_paths: Sequence[str], inp_paths: Sequence[str], **kwargs):
        raise NotImplementedError(
            "reading snapshot zips needs the zarr-zip layer (data/zarrzip.py, data/codecs.py), "
            "which is not yet ported; build the dataset in memory with WDNDataset.from_members")

    @classmethod
    def from_members(cls, members: Sequence[_Member], stats: Optional[NormStats] = None,
                     feature: str = "pressure", from_set: str = "train",
                     norm_type: str = "znorm") -> "WDNDataset":
        """A dataset over snapshots already in memory and already scaled."""
        out = object.__new__(cls)
        out.feature, out.from_set, out.norm_type, out.edge_attrs = feature, from_set, norm_type, None
        out.stats = stats if stats is not None else NormStats(norm_type=norm_type)
        out.members = list(members)
        out._lengths = [len(m.array) for m in out.members]
        out.length = sum(out._lengths)
        return out

    def __len__(self) -> int:
        return self.length

    def __add__(self, other: "WDNDataset") -> "WDNDataset":
        """Concatenate datasets; their stats must already be aligned (the
        same train stats)."""
        return WDNDataset.from_members(
            list(self.members) + list(other.members), self.stats, self.feature,
            f"{self.from_set}+{other.from_set}", self.norm_type)


class SnapshotLoader:
    """Batch iterator grouping snapshots by template.

    Yields ``(template, x_batch [B, n], indices)`` tuples. The final partial
    batch of each template is emitted at its true size, so evaluation stays
    exact (no padding bias). The shuffle is numpy's, stream for stream the
    JAX package's: the same seed and epoch give the same batches.
    """

    def __init__(self, dataset: WDNDataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self._rng = np.random.default_rng(seed)

    def set_epoch(self, epoch: int):
        """Derive this epoch's shuffle stream from (seed, epoch) instead of
        sequential rng state, so a run resumed at epoch k replays the batch
        order an uninterrupted run would use."""
        self._rng = np.random.default_rng([self.seed, int(epoch)])

    def __iter__(self):
        order_per_member = []
        for m in self.ds.members:
            idx = np.arange(len(m.array))
            if self.shuffle:
                self._rng.shuffle(idx)
            order_per_member.append(idx)

        # round-robin over members so multi-dataset training interleaves
        batches = []
        for mi, idx in enumerate(order_per_member):
            for s in range(0, len(idx), self.batch_size):
                chunk = idx[s: s + self.batch_size]
                if self.drop_last and len(chunk) < self.batch_size:
                    continue
                batches.append((mi, chunk))
        if self.shuffle:
            self._rng.shuffle(batches)
        for mi, chunk in batches:
            m = self.ds.members[mi]
            yield m.template, m.array[chunk], chunk

    def num_batches(self) -> int:
        n = 0
        for m in self.ds.members:
            full, rem = divmod(len(m.array), self.batch_size)
            n += full + (0 if (self.drop_last or rem == 0) else 1)
        return n
