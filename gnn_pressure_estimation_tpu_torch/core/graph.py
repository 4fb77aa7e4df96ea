"""Graph containers: a host-side topology template and its torch batch.

The counterpart of ``gnn_pressure_estimation_tpu/core/graph.py``.
:class:`GraphTemplate` is the host (numpy) description of one network
topology, copied from the JAX package as far as the ported modes need it:
the receiver-sorted edge list, in-degrees, the dense ``[n, n]`` operators
and the RCM band layout with its default-block tracking. :class:`BatchedGraph`
holds what the ported layers read for ``B`` copies of one template, as
tensors on one device: the operators of each mode (the attention mask, and
the mean, GCN, Chebyshev and adjacency aggregations the model zoo reads),
and in every mode the receiver-sorted edge list with its slot tables
(``ops.segment``) and the edge attributes, which only m_GCN reads and
which are therefore built on first use.

Three aggregation modes are ported: ``dense`` (templates of at most
:attr:`GraphTemplate.DENSE_THRESHOLD` nodes), ``banded`` (larger ones) and
``padded`` (degree-padded neighbour slots in original node order, chosen by
name). The edge-list ``segment`` mode is not.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

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
        self._degree_cache: Optional[dict] = None
        self._edge_cache: dict = {}

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

    @property
    def max_degree(self) -> int:
        return int(self.in_degree.max()) if self.n_node else 0

    def degree_tables(self) -> dict:
        """Degree-padded edge layout: every node's incoming edges padded to
        the max in-degree, so aggregation is gather + masked reduce over a
        fixed axis, with no scatter at any graph size. The self-loop variant
        appends one slot holding the node itself (always valid). Each comes
        with its transpose tables (``ops.padded.build_transpose_tables``),
        which the gather's backward walks, and with its slot weights: the
        Chebyshev weight −1/√(d_i d_j) of each in-edge slot (``cheb_dp``)
        and the GCN weight 1/√((d_i+1)(d_j+1)) of each slot, the self-loop's
        included (``gcn_dp_sl``); zero on empty slots. Host-built once and
        cached."""
        if self._degree_cache is not None:
            return self._degree_cache
        from gnn_pressure_estimation_tpu_torch.ops.padded import build_transpose_tables

        n = self.n_node
        D = max(self.max_degree, 1)
        senders_dp = np.zeros((n, D), np.int32)
        mask_dp = np.zeros((n, D), bool)
        cheb_dp = np.zeros((n, D), np.float32)
        with np.errstate(divide="ignore"):
            dq = np.where(self.in_degree > 0, 1.0 / np.sqrt(np.maximum(self.in_degree, 1.0)), 0.0)
        cheb_norm = (-(dq[self.senders] * dq[self.receivers])).astype(np.float32)
        slot = np.zeros(n, np.int32)
        for s, r, cw in zip(self.senders, self.receivers, cheb_norm):
            j = slot[r]
            senders_dp[r, j] = s
            mask_dp[r, j] = True
            cheb_dp[r, j] = cw
            slot[r] += 1
        # self-loop slot appended last
        senders_sl = np.concatenate([senders_dp, np.arange(n, dtype=np.int32)[:, None]], axis=1)
        mask_sl = np.concatenate([mask_dp, np.ones((n, 1), bool)], axis=1)
        dinv = (1.0 / np.sqrt(self.in_degree + 1.0)).astype(np.float32)
        gcn_dp = np.where(mask_dp, dinv[:, None] * dinv[senders_dp], 0.0)
        gcn_sl = np.concatenate([gcn_dp, (dinv * dinv)[:, None]], axis=1).astype(np.float32)
        out_flat, out_mask = build_transpose_tables(senders_dp, mask_dp, n)
        out_flat_sl, out_mask_sl = build_transpose_tables(senders_sl, mask_sl, n)
        self._degree_cache = {
            "senders_dp": senders_dp,
            "mask_dp": mask_dp,
            "senders_dp_sl": senders_sl,
            "mask_dp_sl": mask_sl,
            "gcn_dp_sl": gcn_sl,
            "cheb_dp": cheb_dp,
            "out_flat": out_flat,
            "out_mask": out_mask,
            "out_flat_sl": out_flat_sl,
            "out_mask_sl": out_mask_sl,
        }
        return self._degree_cache

    def edge_list(self, band_block: Optional[int] = None, banded: bool = False) -> dict:
        """The receiver-sorted edge list with its slot tables
        (``ops.segment.build_edge_slots``), host-built once and cached:
        ``senders``, ``receivers``, ``order`` (each edge's index in the
        template's own list, which orders the edge attributes) and the
        tables. In original node order, or with ``banded`` in the band
        layout's perm + pad space, re-sorted by receiver as the JAX
        package's banded batch sorts it."""
        from gnn_pressure_estimation_tpu_torch.ops.segment import build_edge_slots

        bl = self.band_layout(band_block) if banded else None
        key = (bl.BLK, bl.W) if banded else None
        if key not in self._edge_cache:
            if banded:
                inv = bl.inv_perm.astype(np.int32)
                s, r, order = _sort_by_receiver(inv[self.senders], inv[self.receivers])
            else:
                s, r, order = self.senders, self.receivers, np.arange(self.n_edge)
            self._edge_cache[key] = {"senders": s, "receivers": r, "order": order,
                                     **build_edge_slots(s, r, bl.n_pad if banded else self.n_node)}
        return self._edge_cache[key]

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
        (attention), ``adj_cnt`` (mean conv, GIN's sum, Chebyshev) or
        ``adj_cnt_sl`` (the GCN aggregation, self-loops counted). Host-built
        once and cached beside the layout."""
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
        windows) | ``padded`` (degree-padded neighbour slots, original node
        order) | ``None`` (dense up to :attr:`DENSE_THRESHOLD` nodes, banded
        above). Raises if ``device`` is CUDA and no card is present, and
        ``NotImplementedError`` for a mode the port does not have.

        ``band_attn`` names the band-attention kernel of a banded graph:
        ``"dma"`` (whole-window softmax over the extended array) | ``"flash"``
        (streaming softmax) | ``"window"`` (materialised windows) | ``"acc"``
        (the ``"dma"`` forward with the owner-row backward of the reference's
        sliding-accumulator kernel) | ``None`` (``ops.banded.band_attention_route``
        on the layout: ``"dma"`` up to the reference's tile limit, ``"flash"``
        beyond). The JAX package chooses with ``GNN_TPU_BAND_FLASH=1``,
        ``GNN_TPU_BAND_DMA=0`` and ``GNN_TPU_BAND_ACC=1``; here it is an
        argument.
        """
        dev = resolve_device(device)
        if mode is None:
            mode = "dense" if self.n_node <= self.DENSE_THRESHOLD else "banded"
        if mode not in ("dense", "banded", "padded"):
            raise NotImplementedError(
                f"aggregation mode {mode!r} is not yet ported (the segment mode: ROADMAP.md, "
                "Queue 1, item 7)")
        if mode == "banded":
            from gnn_pressure_estimation_tpu_torch.ops.banded import (
                BAND_ATTN_ROUTES, band_attention_route,
            )

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

    def _edges(self, B: int, band_block: Optional[int], banded: bool, dev):
        """The builder of a batch's edge list (``BatchedGraph.edges``) and
        edge attributes (the template's ``edge_attr``, the dataset's scaled
        values, in the list's order, tiled over the batch), which the batch
        calls on first use."""
        def build() -> dict:
            from gnn_pressure_estimation_tpu_torch.ops.segment import EdgeSlots

            el = self.edge_list(band_block, banded)
            n = self.band_layout(band_block).n_pad if banded else self.n_node
            ea = None if self.edge_attr is None else torch.as_tensor(
                np.tile(np.asarray(self.edge_attr, np.float32)[el["order"]], (B, 1)), device=dev)
            return {"edges": EdgeSlots.tiled(el["senders"], el["receivers"], el, B, n, dev),
                    "edge_attr": ea}
        return build

    def _build_batch(self, B: int, mode: str, band_block: Optional[int], dev,
                     band_attn: Optional[str]) -> "BatchedGraph":
        if mode == "dense":
            d = self.dense_operators()

            def op(k):
                return torch.as_tensor(d[k], device=dev)
            return BatchedGraph(
                n_graph=B, nodes_per_graph=self.n_node, device=dev,
                adj_sl_mask=op("adj_sl_mask"), adj_sl_index=self.dense_index().to(dev),
                mean_mat=op("mean_mat"), gcn_mat=op("gcn_mat"), cheb_mat=op("cheb_mat"),
                adj_mat=op("adj_mat"), edge_source=self._edges(B, None, False, dev),
            )
        if mode == "padded":
            return self._build_padded(B, dev)
        from gnn_pressure_estimation_tpu_torch.ops.banded import halo_widths

        bl = self.band_layout(band_block)
        U, R = halo_widths(bl.win_start, bl.W, bl.n_pad)
        return BatchedGraph(
            n_graph=B, nodes_per_graph=bl.n_pad, device=dev,
            band_adj_mask=torch.as_tensor(bl.adj_mask.view(np.int8), device=dev),
            band_cnt=torch.as_tensor(bl.adj_cnt, device=dev),
            band_cnt_sl=torch.as_tensor(bl.adj_cnt_sl, device=dev),
            band_adj_index=self.band_index("adj_mask", band_block).to(dev),
            band_cnt_index=self.band_index("adj_cnt", band_block).to(dev),
            band_cnt_sl_index=self.band_index("adj_cnt_sl", band_block).to(dev),
            band_inv_deg=torch.as_tensor(bl.inv_deg_perm, device=dev),
            band_dinv_sl=torch.as_tensor(bl.dinv_sl_perm, device=dev),
            band_dinv=torch.as_tensor(bl.dinv_perm, device=dev),
            band_perm=torch.as_tensor(bl.perm, dtype=torch.long, device=dev),
            band_inv_perm=torch.as_tensor(bl.inv_perm, dtype=torch.long, device=dev),
            band_win_start=bl.win_start,
            band_W=bl.W,
            band_n_pad=bl.n_pad,
            band_U=U,
            band_R=R,
            band_attn=band_attn,
            edge_source=self._edges(B, band_block, True, dev),
        )

    def _build_padded(self, B: int, dev) -> "BatchedGraph":
        """The template's degree tables for ``B`` copies: graph ``b``'s node
        ids shift by ``b·n`` and its flattened slot positions by ``b·n·D``
        (``b·n·(D+1)`` with the self-loop slot), so the transpose tables are
        built once per template, not per batch."""
        dt = self.degree_tables()
        n = self.n_node

        def shifted(table, stride):
            offs = (np.arange(B, dtype=np.int64) * stride)[:, None, None]
            return torch.as_tensor((table[None].astype(np.int64) + offs).reshape(-1, table.shape[1]),
                                   device=dev)

        def tiled(mask):
            return torch.as_tensor(np.tile(mask, (B, 1)), device=dev)

        D = dt["senders_dp"].shape[1]
        return BatchedGraph(
            n_graph=B, nodes_per_graph=n, device=dev,
            senders_dp=shifted(dt["senders_dp"], n), mask_dp=tiled(dt["mask_dp"]),
            senders_dp_sl=shifted(dt["senders_dp_sl"], n), mask_dp_sl=tiled(dt["mask_dp_sl"]),
            out_flat=shifted(dt["out_flat"], n * D), out_mask=tiled(dt["out_mask"]),
            out_flat_sl=shifted(dt["out_flat_sl"], n * (D + 1)), out_mask_sl=tiled(dt["out_mask_sl"]),
            inv_degree=torch.as_tensor(np.tile(self.inv_degree, B), device=dev),
            gcn_dp_sl=tiled(dt["gcn_dp_sl"]), cheb_dp=tiled(dt["cheb_dp"]),
            edge_source=self._edges(B, None, False, dev),
        )


@dataclasses.dataclass(frozen=True)
class BatchedGraph:
    """``n_graph`` same-topology graphs as tensors on ``device``.

    Dense mode carries the template-level ``[n, n]`` attention mask, the
    compressed index of its set cells that the dense-mode kernels walk, and
    the mean, GCN, Chebyshev and adjacency operators, shared by every graph.
    Banded mode works in RCM-permuted, padded node space (``nodes_per_graph
    == band_n_pad``): it carries the ``[nB, BLK, W]`` int8 adjacency mask
    (self-loops included) and the int8 edge-count bands without and with
    self-loops, each with the compressed index of its nonzeros that the
    kernels walk, the scale vectors that factor every parameter-free band
    (mean = 1/deg ⊙ counts; GCN = dinv_sl ⊙ counts_sl ⊙ dinv_sl; Chebyshev =
    −dinv ⊙ counts ⊙ dinv), the permutation, and the name of the
    band-attention kernel its GATConvs go through (``band_attn``). Padded mode
    works in original node order (``nodes_per_graph == n``): it carries each
    node's in-edge slots ``[B·n, D]`` (and ``[B·n, D+1]`` with the self-loop
    slot) with their masks, the transpose tables of each, 1/deg and the GCN
    and Chebyshev slot weights. Every mode gives the receiver-sorted edge list of
    the batch in its node space (``edges``) and the edge attributes in that
    list's order (``edge_attr``, or None), both built on the first read.
    """

    n_graph: int
    nodes_per_graph: int
    device: torch.device
    adj_sl_mask: Optional[torch.Tensor] = None     # [n, n] bool
    adj_sl_index: Optional[object] = None          # MaskIndex of adj_sl_mask
    mean_mat: Optional[torch.Tensor] = None        # [n, n] f32
    gcn_mat: Optional[torch.Tensor] = None         # [n, n] f32 D^-1/2 (A+I) D^-1/2
    cheb_mat: Optional[torch.Tensor] = None        # [n, n] f32 −D^-1/2 A D^-1/2
    adj_mat: Optional[torch.Tensor] = None         # [n, n] f32 edge counts
    band_adj_mask: Optional[torch.Tensor] = None   # [nB, BLK, W] int8 0/1
    band_cnt: Optional[torch.Tensor] = None        # [nB, BLK, W] int8 counts
    band_cnt_sl: Optional[torch.Tensor] = None     # [nB, BLK, W] int8 counts + self-loops
    band_adj_index: Optional[object] = None        # BandIndex of band_adj_mask
    band_cnt_index: Optional[object] = None        # BandIndex of band_cnt
    band_cnt_sl_index: Optional[object] = None     # BandIndex of band_cnt_sl
    band_inv_deg: Optional[torch.Tensor] = None    # [n_pad] f32
    band_dinv_sl: Optional[torch.Tensor] = None    # [n_pad] f32 1/sqrt(deg+1)
    band_dinv: Optional[torch.Tensor] = None       # [n_pad] f32 1/sqrt(deg), 0 at deg 0
    band_perm: Optional[torch.Tensor] = None       # [n] long
    band_inv_perm: Optional[torch.Tensor] = None   # [n] long
    band_win_start: Optional[tuple] = None
    band_W: int = 0
    band_n_pad: int = 0
    band_U: int = 0
    band_R: int = 0
    band_attn: Optional[str] = None                # "dma" | "flash" | "window" | "acc"
    senders_dp: Optional[torch.Tensor] = None      # [B·n, D] long, graph offsets applied
    mask_dp: Optional[torch.Tensor] = None         # [B·n, D] bool
    senders_dp_sl: Optional[torch.Tensor] = None   # [B·n, D+1] long, self-loop slot last
    mask_dp_sl: Optional[torch.Tensor] = None      # [B·n, D+1] bool
    out_flat: Optional[torch.Tensor] = None        # [B·n, D_out] long: transpose of senders_dp
    out_mask: Optional[torch.Tensor] = None        # [B·n, D_out] bool
    out_flat_sl: Optional[torch.Tensor] = None     # transpose of senders_dp_sl
    out_mask_sl: Optional[torch.Tensor] = None
    inv_degree: Optional[torch.Tensor] = None      # [B·n] f32 1/deg (0 at deg 0)
    gcn_dp_sl: Optional[torch.Tensor] = None       # [B·n, D+1] f32 GCN slot weights
    cheb_dp: Optional[torch.Tensor] = None         # [B·n, D] f32 Chebyshev slot weights
    # builds {"edges": ops.segment.EdgeSlots, "edge_attr": [B·E, d] f32 or None}
    edge_source: Optional[Callable[[], dict]] = dataclasses.field(
        default=None, repr=False, compare=False)
    _edge_cache: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @property
    def n_node(self) -> int:
        return self.n_graph * self.nodes_per_graph

    @property
    def dense(self) -> bool:
        return self.mean_mat is not None

    def _edge_tables(self) -> dict:
        if not self._edge_cache and self.edge_source is not None:
            # cached and shared like the batch: built outside inference mode
            with torch.inference_mode(False):
                self._edge_cache.update(self.edge_source())
        return self._edge_cache

    @property
    def edges(self):
        """The batch's receiver-sorted edge list (``ops.segment.EdgeSlots``)."""
        return self._edge_tables().get("edges")

    @property
    def edge_attr(self) -> Optional[torch.Tensor]:
        """[B·E, d] f32 edge attributes in ``edges``' order, or None."""
        return self._edge_tables().get("edge_attr")

    @property
    def banded(self) -> bool:
        return self.band_adj_mask is not None

    @property
    def padded(self) -> bool:
        return self.senders_dp is not None

    # -- degree-padded neighbour slots ------------------------------------
    def gather_dp(self, x: torch.Tensor) -> torch.Tensor:
        """[B·n, ...] → [B·n, D, ...] in-edge slots (``ops.padded``)."""
        from gnn_pressure_estimation_tpu_torch.ops.padded import padded_gather

        return padded_gather(x, self.senders_dp, self.out_flat, self.out_mask)

    def gather_dp_sl(self, x: torch.Tensor) -> torch.Tensor:
        """[B·n, ...] → [B·n, D+1, ...] in-edge slots plus the self-loop slot."""
        from gnn_pressure_estimation_tpu_torch.ops.padded import padded_gather

        return padded_gather(x, self.senders_dp_sl, self.out_flat_sl, self.out_mask_sl)

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
