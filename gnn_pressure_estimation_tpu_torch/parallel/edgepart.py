"""Edge-partitioned graphs: the disjoint-union batch cut into node blocks.

The counterpart of ``gnn_pressure_estimation_tpu/parallel/edgepart.py``,
whose host-side arrays this module builds the same way (numpy):

- the batch's nodes are padded to ``n_parts`` equal blocks (padding nodes
  are isolated: no edges, zero inverse degree);
- each rank of the graph group owns the edges whose *receiver* lies in its
  block; the edge lists are padded to the largest rank's count and
  ``edge_mask`` flags the real ones; receivers are local ids, senders
  global ids.

:meth:`GraphPartition.local_graph` gives one rank's block as a
``BatchedGraph`` on which the layers take the edge-list path, every
aggregation all-gathering the graph group's node blocks
(``ops.segment.spmm`` with ``axis``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gnn_pressure_estimation_tpu_torch.core.graph import BatchedGraph, GraphTemplate


@dataclasses.dataclass(frozen=True)
class GraphPartition:
    """Host-side [P, ...] stacks; row ``p`` is rank ``p``'s block of the
    graph group."""

    n_parts: int
    n_node_global: int      # padded total nodes (n_parts * block)
    block: int              # nodes a rank
    n_graph: int
    nodes_per_graph: int
    senders: np.ndarray         # [P, E_max] global ids
    receivers: np.ndarray       # [P, E_max] local ids
    edge_mask: np.ndarray       # [P, E_max]
    senders_sl: np.ndarray
    receivers_sl: np.ndarray
    edge_mask_sl: np.ndarray
    inv_degree: np.ndarray      # [P, block]
    gcn_norm: np.ndarray        # [P, E_max_sl]
    cheb_norm: np.ndarray       # [P, E_max]
    edge_attr: np.ndarray | None  # [P, E_max, D]
    node_graph_id: np.ndarray   # [P, block]

    def local_graph(self, p: int, mesh) -> BatchedGraph:
        """Rank ``p``'s block as an edge-list ``BatchedGraph`` on the mesh's
        device, ``axis_name`` the mesh: its edge lists with slot tables that
        leave the padding edges out, their weights and masks (each table
        built on its first read), the inverse degrees."""
        dev = mesh.device
        from gnn_pressure_estimation_tpu_torch.ops.segment import EdgeSlots

        def t(a):
            return torch.as_tensor(np.asarray(a), device=dev)

        def table(name: str):
            n, n_src = self.block, self.n_node_global
            if name == "edges":
                return EdgeSlots.of(self.senders[p], self.receivers[p], n, dev, n_src,
                                    self.edge_mask[p])
            if name == "edges_sl":
                return EdgeSlots.of(self.senders_sl[p], self.receivers_sl[p], n, dev, n_src,
                                    self.edge_mask_sl[p])
            a = getattr(self, name)
            return None if a is None else t(a[p])
        return BatchedGraph(n_graph=1, nodes_per_graph=self.block, device=dev,
                            inv_degree=t(self.inv_degree[p]), axis_name=mesh,
                            edge_mask=t(self.edge_mask[p]), edge_mask_sl=t(self.edge_mask_sl[p]),
                            edge_source=table)


def _partition_edges(senders, receivers, weights, n_parts, block, pad_to):
    """Assign each edge to the rank owning its receiver; pad to ``pad_to``."""
    P = n_parts
    out_s = np.zeros((P, pad_to), np.int32)
    out_r = np.zeros((P, pad_to), np.int32)
    out_m = np.zeros((P, pad_to), bool)
    out_w = [np.zeros((P, pad_to), np.float32) for _ in weights]
    part = receivers // block
    for p in range(P):
        sel = part == p
        e = int(sel.sum())
        out_s[p, :e] = senders[sel]
        out_r[p, :e] = receivers[sel] - p * block
        out_m[p, :e] = True
        for wi, w in enumerate(weights):
            out_w[wi][p, :e] = w[sel]
    return out_s, out_r, out_m, out_w


def partition_graph(template: GraphTemplate, batch_size: int, n_parts: int) -> GraphPartition:
    """Partition the ``batch_size`` disjoint union of ``template`` into
    ``n_parts`` contiguous node blocks (padding the tail block)."""
    B, n = batch_size, template.n_node
    n_total = B * n
    block = -(-n_total // n_parts)
    n_pad = block * n_parts

    offs = (np.arange(B, dtype=np.int32) * n)[:, None]
    senders = (template.senders[None, :] + offs).reshape(-1)
    receivers = (template.receivers[None, :] + offs).reshape(-1)
    sg = template.segment_lists
    senders_sl = (sg["senders_sl"][None, :] + offs).reshape(-1)
    receivers_sl = (sg["receivers_sl"][None, :] + offs).reshape(-1)
    cheb = np.tile(sg["cheb_norm"], B)
    gcn = np.tile(sg["gcn_norm"], B)
    inv_deg = np.tile(template.inv_degree, B)
    node_gid = np.repeat(np.arange(B, dtype=np.int32), n)

    # per-rank edge counts → common padded width
    part = receivers // block
    counts = np.bincount(part, minlength=n_parts)
    e_max = max(int(counts.max()), 1)
    part_sl = receivers_sl // block
    counts_sl = np.bincount(part_sl, minlength=n_parts)
    e_max_sl = max(int(counts_sl.max()), 1)

    weights = [cheb]
    if template.edge_attr is not None:
        ea = np.tile(template.edge_attr, (B, 1))
        weights += [ea[:, d] for d in range(ea.shape[1])]
    s, r, m, w = _partition_edges(senders, receivers, weights, n_parts, block, e_max)
    cheb_p = w[0]
    edge_attr_p = np.stack(w[1:], axis=-1).astype(np.float32) if len(w) > 1 else None
    s_sl, r_sl, m_sl, (gcn_p,) = _partition_edges(
        senders_sl, receivers_sl, [gcn], n_parts, block, e_max_sl)

    inv_deg_p = np.zeros((n_parts, block), np.float32)
    gid_p = np.zeros((n_parts, block), np.int32)
    flat_inv = np.concatenate([inv_deg, np.zeros(n_pad - n_total, np.float32)])
    flat_gid = np.concatenate([node_gid, np.full(n_pad - n_total, B - 1, np.int32)])
    for p in range(n_parts):
        inv_deg_p[p] = flat_inv[p * block: (p + 1) * block]
        gid_p[p] = flat_gid[p * block: (p + 1) * block]

    return GraphPartition(
        n_parts=n_parts, n_node_global=n_pad, block=block, n_graph=B, nodes_per_graph=n,
        senders=s, receivers=r, edge_mask=m, senders_sl=s_sl, receivers_sl=r_sl,
        edge_mask_sl=m_sl, inv_degree=inv_deg_p, gcn_norm=gcn_p, cheb_norm=cheb_p,
        edge_attr=edge_attr_p, node_graph_id=gid_p,
    )
