"""Snapshot datasets: zarr-zip pressure arrays + INP topology → templates
and scaled snapshot arrays (numpy only).

The counterparts of ``get_keep_list``, ``build_template``, ``WDNDataset``,
``stacked_dataset`` and ``SnapshotLoader`` in
``gnn_pressure_estimation_tpu/data/dataset.py`` (reference
utils/DataLoader.py):

- Each (zip, inp) pair yields one :class:`GraphTemplate` plus a scaled
  ``[num_snapshots, n_kept]`` array; the loader batches snapshots of one
  template together.
- Normalization statistics are computed over the concatenation of all member
  arrays exactly like the reference (DataLoader.py:142-155) and propagate
  train → valid/test through :class:`NormStats`.
- Node-type removal mirrors ``get_keep_list`` (DataLoader.py:40-58).

:meth:`WDNDataset.from_members` builds a dataset from arrays already in
memory and already scaled.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from gnn_pressure_estimation_tpu_torch.core.graph import GraphTemplate
from gnn_pressure_estimation_tpu_torch.data.inp import WaterNetwork, parse_inp
from gnn_pressure_estimation_tpu_torch.data.zarrzip import ZarrZipReader
from gnn_pressure_estimation_tpu_torch.utils import tracing
from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats, scale_edges_with, scale_with

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
    attributes gathered from link attributes (diameter/length/...); the span
    ``template.build``."""
    with tracing.setup_span("template.build"):
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


def _take_columns(
    array: np.ndarray,
    col_names: list[str],
    keep_list: Optional[list[str]],
    order: Optional[list[int]] = None,
) -> np.ndarray:
    """Select the zarr columns of kept nodes. ``col_names`` is the store's
    own column-name list when recorded (``ordered_names_by_attr`` —
    generators with skip_nodes write compacted columns), else the canonical
    node order (reference analog DataLoader.py:244-252). ``order`` gives the
    exact column positions to take (template kept-node order)."""
    if keep_list is None:
        return array
    if array.shape[-1] < len(col_names):
        raise ValueError(
            f"snapshot width {array.shape[-1]} < named columns {len(col_names)}"
        )
    if order is None:
        keep = set(keep_list)
        order = [i for i, n in enumerate(col_names) if n in keep]
    return np.take(array, order, axis=-1)


@dataclasses.dataclass
class _Member:
    template: GraphTemplate
    array: np.ndarray          # [S, n_kept] snapshots, scaled after __init__
    kept_names: list
    wn: Optional[WaterNetwork]


class WDNDataset:
    """Multi-zip snapshot dataset (reference WDNDataset, DataLoader.py:61-258):
    one :class:`_Member` (template and ``[S, n]`` scaled snapshots) per
    (zip, inp) pair, and the normalization statistics they were scaled with.

    Pass ``stats=None`` to compute the statistics from this dataset (the
    training set), or the train stats for valid/test.
    """

    def __init__(
        self,
        zip_paths: Sequence[str],
        inp_paths: Sequence[str],
        feature: str = "pressure",
        from_set: str = "train",
        num_records: Optional[int] = None,
        removal: str = "keep_junction",
        stats: Optional[NormStats] = None,
        edge_attrs: Optional[Sequence[str]] = None,
        norm_type: str = "znorm",
        do_scale: bool = True,
    ):
        assert norm_type in ("znorm", "minmax", "unused")
        assert removal in REMOVALS, f"removal {removal!r} not in {REMOVALS}"
        assert len(zip_paths) == len(inp_paths)
        if edge_attrs is not None:
            assert set(edge_attrs).issubset({"diameter", "length", "valve_mask"})

        self.feature = feature
        self.from_set = from_set
        self.norm_type = norm_type
        self.edge_attrs = tuple(edge_attrs) if edge_attrs else None
        self.members: list[_Member] = [
            self._collect(zp, ip, feature, from_set, num_records, removal)
            for zp, ip in zip(zip_paths, inp_paths)
        ]

        if stats is None:
            flat = np.concatenate([m.array.ravel() for m in self.members])
            stats = NormStats.from_array(flat, norm_type)
            if self.edge_attrs:
                stats = stats.with_edge_stats(
                    np.concatenate([m.template.edge_attr for m in self.members], axis=0))
        else:
            stats = dataclasses.replace(stats, norm_type=norm_type)
        self.stats = stats

        scaled = do_scale and norm_type in ("znorm", "minmax")
        for m in self.members:
            m.array = (scale_with(m.array, stats) if scaled else m.array).astype(np.float32)
            if scaled and self.edge_attrs and m.template.edge_attr is not None:
                m.template.edge_attr = scale_edges_with(m.template.edge_attr, stats).astype(
                    np.float32)

        self._lengths = [len(m.array) for m in self.members]
        self.length = sum(self._lengths)

    # -- reference ``collect`` analog (DataLoader.py:206-258) --------------
    def _collect(self, zip_path, inp_path, feature, from_set, num_records, removal):
        wn = parse_inp(inp_path)
        with ZarrZipReader(zip_path) as r:
            root = r.root()
            attrs = root.attrs
            if not r.is_group(feature):
                raise KeyError(f"feature {feature!r} not in zarr store {zip_path}")
            array = np.asarray(root[feature][from_set])
        if num_records is not None:
            array = array[:num_records]
        keep_list = get_keep_list(wn, removal, attrs, feature)
        col_names = (attrs.get("ordered_names_by_attr") or {}).get(feature) or wn.node_names
        if keep_list is not None:
            # a node skipped at generation time has no column to reconstruct
            have = set(col_names)
            dropped = [nm for nm in keep_list if nm not in have]
            if dropped:
                print(f"WARN! {len(dropped)} kept nodes have no columns in {zip_path}; dropped")
                keep_list = [nm for nm in keep_list if nm in have]
        tpl, kept = build_template(wn, keep_list, self.edge_attrs, name=inp_path)
        # columns selected in the template's kept-node order so data rows and
        # graph nodes align even for stores with reordered/compacted columns
        col_pos = {nm: i for i, nm in enumerate(col_names)}
        array = _take_columns(array, col_names, kept, order=[col_pos[nm] for nm in kept])
        assert array.shape[-1] == tpl.n_node, (
            f"snapshot width {array.shape[-1]} != template nodes {tpl.n_node}"
        )
        return _Member(template=tpl, array=np.asarray(array, np.float64), kept_names=kept, wn=wn)

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
        """Concatenate datasets (reference ``test_ds + train_ds + valid_ds``,
        DataLoader.py:505); their stats must already be aligned (the same
        train stats)."""
        out = WDNDataset.from_members(
            list(self.members) + list(other.members), self.stats, self.feature,
            f"{self.from_set}+{other.from_set}", self.norm_type)
        out.edge_attrs = self.edge_attrs
        return out


def stacked_dataset(
    zip_path: str,
    inp_path: str,
    stats: NormStats,
    feature: str = "pressure",
    removal: str = "keep_junction",
    edge_attrs: Optional[Sequence[str]] = None,
    norm_type: str = "znorm",
    sets: Sequence[str] = ("test", "train", "valid"),
    num_tests: Optional[int] = None,
) -> WDNDataset:
    """Concatenate splits into one evaluation dataset (reference
    ``get_stacked_set``/``get_stacked_set2``, DataLoader.py:426-604 — incl.
    the capped variant: stop adding splits once ``num_tests`` records are
    reached)."""
    out: Optional[WDNDataset] = None
    remaining = num_tests
    for fs in sets:
        if remaining is not None and remaining <= 0:
            break
        ds = WDNDataset(
            [zip_path], [inp_path], feature=feature, from_set=fs,
            num_records=remaining, removal=removal, stats=stats,
            edge_attrs=edge_attrs, norm_type=norm_type,
        )
        if remaining is not None:
            remaining -= len(ds)
        out = ds if out is None else out + ds
    assert out is not None
    return out


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
