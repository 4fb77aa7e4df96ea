"""Graph containers: a host-side topology template and its torch batch.

The counterpart of ``gnn_pressure_estimation_tpu/core/graph.py``.
:class:`GraphTemplate` is the host (numpy) description of one network
topology, copied from the JAX package as far as the ported modes need it:
the receiver-sorted edge list, in-degrees, the dense ``[n, n]`` operators
and the RCM band layout with its default-block tracking. :class:`BatchedGraph`
holds what the ported layers read for ``B`` copies of one template, as
tensors on one device.

Two aggregation modes are ported: ``dense`` (templates of at most
:attr:`GraphTemplate.DENSE_THRESHOLD` nodes) and ``banded`` (larger ones).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gnn_pressure_estimation_tpu_torch.device import resolve_device


def _sort_by_receiver(senders: np.ndarray, receivers: np.ndarray):
    order = np.argsort(receivers, kind="stable")
    return senders[order], receivers[order], order


class GraphTemplate:
    """Host-side immutable topology of one water network graph.

    ``senders``/``receivers`` is the directed edge list; for an undirected
    WDN both directions of each link must be present. ``edge_attr`` is an
    optional ``[n_edge, d]`` per-directed-edge feature array.
    """

    # Node count up to which aggregation runs on dense [n, n] operators;
    # larger templates use the RCM band layout.
    DENSE_THRESHOLD = 1024

    def __init__(
        self,
        n_node: int,
        senders: np.ndarray,
        receivers: np.ndarray,
        edge_attr: Optional[np.ndarray] = None,
        node_names: Optional[list[str]] = None,
        name: str = "graph",
    ):
        senders = np.asarray(senders, dtype=np.int32)
        receivers = np.asarray(receivers, dtype=np.int32)
        if senders.shape != receivers.shape or senders.ndim != 1:
            raise ValueError("senders and receivers must be 1-D arrays of one length")
        if senders.size and (senders.max() >= n_node or receivers.max() >= n_node):
            raise ValueError("edge endpoint out of range")

        s, r, order = _sort_by_receiver(senders, receivers)
        self.name = name
        self.n_node = int(n_node)
        self.n_edge = int(senders.size)
        self.senders = s
        self.receivers = r
        self.edge_attr = None if edge_attr is None else np.asarray(edge_attr, np.float32)[order]
        self.node_names = node_names

        # In-degree without self-loops (SimpleConv mean aggregation).
        deg = np.bincount(self.receivers, minlength=n_node).astype(np.float32)
        self.in_degree = deg
        with np.errstate(divide="ignore"):
            inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1.0), 0.0)
        self.inv_degree = inv.astype(np.float32)

        self._batch_cache: dict = {}
        self._dense_cache: Optional[dict] = None
        self._band_cache: dict = {}
        self._band_default: Optional[tuple] = None
        self._band_index_cache: dict = {}
        self._dense_index = None

    def dense_operators(self) -> dict:
        """Template-level [n, n] operators shared by every graph in a batch:
        adjacency mask with self-loops (GAT attention mask), row-normalized
        mean (SimpleConv), GCN symmetric norm with self-loops, Chebyshev
        scaled Laplacian, raw adjacency (GIN)."""
        if self._dense_cache is not None:
            return self._dense_cache
        n = self.n_node
        A = np.zeros((n, n), np.float32)
        # accumulate (not assign): parallel links are legal in EPANET INPs
        np.add.at(A, (self.receivers, self.senders), 1.0)
        adj_sl = (A + np.eye(n, dtype=np.float32)) > 0
        mean_mat = A * self.inv_degree[:, None]
        deg_sl = self.in_degree + 1.0
        dinv = 1.0 / np.sqrt(deg_sl)
        gcn_mat = (A + np.eye(n, dtype=np.float32)) * dinv[:, None] * dinv[None, :]
        with np.errstate(divide="ignore"):
            dq = np.where(self.in_degree > 0, 1.0 / np.sqrt(np.maximum(self.in_degree, 1.0)), 0.0)
        cheb_mat = -(A * dq[:, None] * dq[None, :])
        self._dense_cache = {
            "adj_sl_mask": adj_sl,
            "mean_mat": mean_mat.astype(np.float32),
            "gcn_mat": gcn_mat.astype(np.float32),
            "cheb_mat": cheb_mat.astype(np.float32),
            "adj_mat": A,
        }
        return self._dense_cache

    def dense_index(self):
        """The compressed set cells (``ops.graph_attention.MaskIndex``) of
        ``adj_sl_mask``, by row and by column, which the dense-mode kernels
        walk. Host-built once and cached; raises if a self-loop is missing."""
        if self._dense_index is None:
            from gnn_pressure_estimation_tpu_torch.ops.graph_attention import build_mask_index

            self._dense_index = build_mask_index(self.dense_operators()["adj_sl_mask"])
        return self._dense_index

    def band_layout(self, block: Optional[int] = None, lane: Optional[int] = None):
        """RCM band layout, cached per (block, lane).

        ``block=None`` resolves to the template's *default layout*: the
        (block, lane) most recently requested **explicitly** through this
        method, falling back to (256, 128). An explicitly passed ``lane``
        always wins over the stored default's lane.
        """
        if block is None:
            d_block, d_lane = self._band_default or (256, 128)
            block, lane = d_block, (lane if lane is not None else d_lane)
        else:
            lane = 128 if lane is None else lane
            self._band_default = (block, lane)
        key = (block, lane)
        if key not in self._band_cache:
            from gnn_pressure_estimation_tpu_torch.ops.banded import build_band_layout

            self._band_cache[key] = build_band_layout(self, block=block, lane=lane)
        return self._band_cache[key]

    def band_index(self, kind: str, block: Optional[int] = None):
        """The compressed nonzeros (``ops.banded.BandIndex``) of one band of
        the layout, which the backward kernels walk: ``kind`` is ``adj_mask``
        (attention) or ``adj_cnt`` (mean conv). Host-built once and cached
        beside the layout."""
        bl = self.band_layout(block)
        key = (kind, bl.BLK, bl.W)
        if key not in self._band_index_cache:
            from gnn_pressure_estimation_tpu_torch.ops.banded import build_band_index

            self._band_index_cache[key] = build_band_index(getattr(bl, kind))
        return self._band_index_cache[key]

    def batch(
        self,
        batch_size: int,
        mode: Optional[str] = None,
        band_block: Optional[int] = None,
        device="cuda",
        band_attn: Optional[str] = None,
    ) -> "BatchedGraph":
        """``batch_size`` copies of this template as tensors on ``device``.

        ``mode``: ``dense`` ([n, n] operators) | ``banded`` (RCM band
        windows) | ``None`` (dense up to :attr:`DENSE_THRESHOLD` nodes,
        banded above). Raises if ``device`` is CUDA and no card is present.

        ``band_attn`` names the band-attention kernel of a banded graph:
        ``"dma"`` (whole-window softmax over the extended array) | ``"flash"``
        (streaming softmax) | ``"window"`` (materialised windows) | ``None``
        (``ops.banded.band_attention_route`` on the layout: ``"dma"`` up to
        the reference's tile limit, ``"flash"`` beyond). The JAX package
        chooses with ``GNN_TPU_BAND_FLASH=1`` and ``GNN_TPU_BAND_DMA=0``;
        here it is an argument.
        """
        dev = resolve_device(device)
        if mode is None:
            mode = "dense" if self.n_node <= self.DENSE_THRESHOLD else "banded"
        if mode not in ("dense", "banded"):
            raise NotImplementedError(f"aggregation mode {mode!r} is not yet ported")
        if mode == "banded":
            from gnn_pressure_estimation_tpu_torch.ops.banded import (
                BAND_ATTN_ROUTES, band_attention_route,
            )

            if band_attn == "acc":
                raise NotImplementedError(
                    'band_attn "acc" (the sliding-accumulator backward, make_band_attention_acc) '
                    "is not yet ported: ROADMAP.md, Queue 2, item 5")
            if band_attn is None:
                bl = self.band_layout(band_block)
                band_attn = band_attention_route(bl.BLK, bl.W)
            if band_attn not in BAND_ATTN_ROUTES:
                raise ValueError(f"band_attn {band_attn!r} is not one of {BAND_ATTN_ROUTES}")
        elif band_attn is not None:
            raise ValueError("band_attn applies to banded graphs only")
        key = (batch_size, mode, band_block, str(dev), band_attn)
        if key in self._batch_cache:
            return self._batch_cache[key]

        # the graph is cached and shared: built outside inference mode even when
        # a serving call asks first, so a later train step can save its tensors
        with torch.inference_mode(False):
            g = self._build_batch(batch_size, mode, band_block, dev, band_attn)
        self._batch_cache[key] = g
        return g

    def _build_batch(self, B: int, mode: str, band_block: Optional[int], dev,
                     band_attn: Optional[str]) -> "BatchedGraph":
        if mode == "dense":
            d = self.dense_operators()
            return BatchedGraph(
                n_graph=B, nodes_per_graph=self.n_node, device=dev,
                adj_sl_mask=torch.as_tensor(d["adj_sl_mask"], device=dev),
                adj_sl_index=self.dense_index().to(dev),
                mean_mat=torch.as_tensor(d["mean_mat"], device=dev),
            )
        from gnn_pressure_estimation_tpu_torch.ops.banded import halo_widths

        bl = self.band_layout(band_block)
        U, R = halo_widths(bl.win_start, bl.W, bl.n_pad)
        return BatchedGraph(
            n_graph=B, nodes_per_graph=bl.n_pad, device=dev,
            band_adj_mask=torch.as_tensor(bl.adj_mask.view(np.int8), device=dev),
            band_cnt=torch.as_tensor(bl.adj_cnt, device=dev),
            band_adj_index=self.band_index("adj_mask", band_block).to(dev),
            band_cnt_index=self.band_index("adj_cnt", band_block).to(dev),
            band_inv_deg=torch.as_tensor(bl.inv_deg_perm, device=dev),
            band_perm=torch.as_tensor(bl.perm, dtype=torch.long, device=dev),
            band_inv_perm=torch.as_tensor(bl.inv_perm, dtype=torch.long, device=dev),
            band_win_start=bl.win_start,
            band_W=bl.W,
            band_n_pad=bl.n_pad,
            band_U=U,
            band_R=R,
            band_attn=band_attn,
        )


@dataclasses.dataclass(frozen=True)
class BatchedGraph:
    """``n_graph`` same-topology graphs as tensors on ``device``.

    Dense mode carries the template-level ``[n, n]`` attention mask, the
    compressed index of its set cells that the dense-mode kernels walk, and
    the mean operator, shared by every graph. Banded mode works in RCM-permuted,
    padded node space (``nodes_per_graph == band_n_pad``): it carries the
    ``[nB, BLK, W]`` int8 adjacency mask (self-loops included) and int8
    edge-count band, each with the compressed index of its nonzeros that the
    kernels walk, the 1/deg row scale, the permutation, and the name of the
    band-attention kernel its GATConvs go through (``band_attn``).
    """

    n_graph: int
    nodes_per_graph: int
    device: torch.device
    adj_sl_mask: Optional[torch.Tensor] = None     # [n, n] bool
    adj_sl_index: Optional[object] = None          # MaskIndex of adj_sl_mask
    mean_mat: Optional[torch.Tensor] = None        # [n, n] f32
    band_adj_mask: Optional[torch.Tensor] = None   # [nB, BLK, W] int8 0/1
    band_cnt: Optional[torch.Tensor] = None        # [nB, BLK, W] int8 counts
    band_adj_index: Optional[object] = None        # BandIndex of band_adj_mask
    band_cnt_index: Optional[object] = None        # BandIndex of band_cnt
    band_inv_deg: Optional[torch.Tensor] = None    # [n_pad] f32
    band_perm: Optional[torch.Tensor] = None       # [n] long
    band_inv_perm: Optional[torch.Tensor] = None   # [n] long
    band_win_start: Optional[tuple] = None
    band_W: int = 0
    band_n_pad: int = 0
    band_U: int = 0
    band_R: int = 0
    band_attn: Optional[str] = None                # "dma" | "flash" | "window"

    @property
    def dense(self) -> bool:
        return self.mean_mat is not None

    @property
    def banded(self) -> bool:
        return self.band_adj_mask is not None

    # -- banded-space packing (caller-side, once per batch) ----------------
    def pack_nodes(self, x_flat: torch.Tensor, n_orig: int) -> torch.Tensor:
        """[B*n_orig, C] original order → [B*n_pad, C] perm+padded."""
        B = self.n_graph
        xb = x_flat.reshape(B, n_orig, -1)[:, self.band_perm]
        pad = xb.new_zeros((B, self.band_n_pad - n_orig, xb.shape[-1]))
        return torch.cat([xb, pad], dim=1).reshape(B * self.band_n_pad, -1)

    def unpack_nodes(self, x_flat: torch.Tensor, n_orig: int) -> torch.Tensor:
        """[B*n_pad, C] perm+padded → [B*n_orig, C] original order."""
        B = self.n_graph
        xb = x_flat.reshape(B, self.band_n_pad, -1)[:, :n_orig]
        return xb[:, self.band_inv_perm].reshape(B * n_orig, -1)
