"""Template building from an INP topology (numpy only).

The counterparts of ``get_keep_list`` and ``build_template`` in
``gnn_pressure_estimation_tpu/data/dataset.py``. The snapshot dataset
(``WDNDataset``, zarr zips) is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from gnn_pressure_estimation_tpu_torch.core.graph import GraphTemplate
from gnn_pressure_estimation_tpu_torch.data.inp import WaterNetwork

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
