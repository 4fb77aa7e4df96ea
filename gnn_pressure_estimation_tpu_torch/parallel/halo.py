"""Halo-exchange node partitioning: banded message passing across ranks.

The counterpart of ``gnn_pressure_estimation_tpu/parallel/halo.py``. The RCM
band layout (``ops/banded.py``) has uniform window offsets: every BLK-row
block attends to the rows ``[b·BLK − U, b·BLK − U + W)``. The halo strategy
cuts the block rows into ``gp`` contiguous chunks of ``nbL`` blocks
(``chunk = nbL·BLK`` rows, the last chunk padded with empty blocks), one per
rank of the graph group, with the matching slice of every band. Each layer
hands the U last rows of a chunk to the next rank and the R first rows to
the previous one (:func:`halo_exchange`), puts them around the chunk, and
runs the band kernels that one card runs, on the chunk: the extended array
a rank builds is the single-card extended array's rows of that chunk. The
edge ranks receive zeros, the single card's zero padding.

The exchange is a ``torch.autograd.Function``; its backward is the
transpose: the cotangent of the left context goes back to the previous rank,
which adds it into its last U rows, that of the right context to the next
rank, into its first R rows. The edge ranks received zeros and send nothing
back. No wrap-around rows are sent (the JAX ring sends them and zeroes them).

Each rank builds the ``BandIndex`` of its own slice of each band once per
partition (:meth:`HaloPartition.local_graph`). The band-attention route
(``"dma"``, ``"flash"``, ``"acc"``, ``"window"``) is an argument, by default
``ops.banded.band_attention_route`` on the chunk layout (BLK and W are the
template's); the JAX package reads ``GNN_TPU_BAND_*`` here, the port no
environment variable.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from gnn_pressure_estimation_tpu_torch.core.graph import BatchedGraph, GraphTemplate
from gnn_pressure_estimation_tpu_torch.ops import banded as bops


def _swap_rows(mesh, send_left, send_right, shape_left, shape_right, dtype):
    """Send ``send_left`` to graph position g−1 and ``send_right`` to g+1
    (None: nothing); receive the rows of the given shapes from g−1 / g+1
    where those exist. Returns (from_left, from_right), None where no rank."""
    g, gp = mesh.g, mesh.gp
    sends, recvs = {}, {}
    if send_left is not None and g > 0:
        sends[g - 1] = send_left
    if send_right is not None and g < gp - 1:
        sends[g + 1] = send_right
    if shape_left is not None and g > 0:
        recvs[g - 1] = (shape_left, dtype)
    if shape_right is not None and g < gp - 1:
        recvs[g + 1] = (shape_right, dtype)
    if not sends and not recvs:
        return None, None
    stats = mesh.exchanges
    timing = stats["timing"] and mesh.device.type == "cuda"
    if timing:
        torch.cuda.synchronize(mesh.device)
    t0 = time.perf_counter()
    got = mesh.swap(sends, recvs)
    if timing:
        torch.cuda.synchronize(mesh.device)
    stats["calls"] += 1
    stats["bytes"] += sum(t.numel() * t.element_size() for t in sends.values())
    stats["seconds"] += time.perf_counter() - t0
    return got.get(g - 1), got.get(g + 1)


class HaloExchange(torch.autograd.Function):
    """[B, chunk, ...] → [B, U + chunk + R, ...] with the neighbours' rows."""

    @staticmethod
    def forward(ctx, xb, U, R, mesh):
        ctx.U, ctx.R, ctx.mesh = U, R, mesh
        B, rest = xb.shape[0], tuple(xb.shape[2:])
        left, right = _swap_rows(
            mesh, xb[:, :R] if R else None, xb[:, xb.shape[1] - U:] if U else None,
            (B, U) + rest if U else None, (B, R) + rest if R else None, xb.dtype)
        parts = []
        if U:
            parts.append(left if left is not None else xb.new_zeros((B, U) + rest))
        parts.append(xb)
        if R:
            parts.append(right if right is not None else xb.new_zeros((B, R) + rest))
        return torch.cat(parts, dim=1) if len(parts) > 1 else xb.clone()

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_ext):
        U, R, mesh = ctx.U, ctx.R, ctx.mesh
        chunk = d_ext.shape[1] - U - R
        d_x = d_ext[:, U:U + chunk].clone()
        B, rest = d_ext.shape[0], tuple(d_ext.shape[2:])
        # the left context came from g−1's last U rows: its cotangent goes back
        # there, the right context's to g+1; g−1 sends the cotangent of this
        # chunk's first R rows (its right context), g+1 that of the last U
        from_prev, from_next = _swap_rows(
            mesh, d_ext[:, :U] if U else None, d_ext[:, U + chunk:] if R else None,
            (B, R) + rest if R else None, (B, U) + rest if U else None, d_ext.dtype)
        if from_prev is not None:
            d_x[:, :R] += from_prev
        if from_next is not None:
            d_x[:, chunk - U:] += from_next
        return d_x, None, None, None


def halo_exchange(xb: torch.Tensor, U: int, R: int, mesh) -> torch.Tensor:
    """[B, chunk, ...] → [B, U + chunk + R, ...]: the previous rank's last
    ``U`` rows before the chunk, the next rank's first ``R`` rows after it
    (zeros at the edges of the graph group), differentiable."""
    return HaloExchange.apply(xb, U, R, mesh)


@dataclasses.dataclass(frozen=True)
class HaloPartition:
    """Host-side band partition over ``gp`` ranks."""

    gp: int
    nbL: int            # block rows a rank
    BLK: int
    W: int
    U: int              # left halo rows
    R: int              # right halo rows
    chunk: int          # nbL * BLK rows a rank
    n_pad_dist: int     # gp * chunk (≥ the template band's n_pad)
    n_orig: int
    perm: np.ndarray    # original → band order
    band_arrays: dict   # {name: [gp, nbL, BLK, W] or [gp, chunk]} slices by rank
    band_attn: str      # the band-attention route of the chunks' GATConvs
    _graphs: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    def local_graph(self, g: int, n_graph: int, mesh) -> BatchedGraph:
        """Graph position ``g``'s chunk of ``n_graph`` graphs as a halo-mode
        ``BatchedGraph`` on the mesh's device: the slices of the bands, their
        ``BandIndex`` (built once per rank), the scale vectors' rows,
        ``axis_name`` the mesh. Cached."""
        dev = mesh.device
        key = (g, n_graph, str(dev))
        if key not in self._graphs:
            a = {k: v[g] for k, v in self.band_arrays.items()}
            ix = {k: bops.build_band_index(a[k]).to(dev)
                  for k in ("adj_mask", "adj_cnt", "adj_cnt_sl")}

            def t(k):
                return torch.as_tensor(a[k], device=dev)
            with torch.inference_mode(False):
                self._graphs[key] = BatchedGraph(
                    n_graph=n_graph, nodes_per_graph=self.chunk, device=dev,
                    band_adj_mask=torch.as_tensor(a["adj_mask"].view(np.int8), device=dev),
                    band_cnt=t("adj_cnt"), band_cnt_sl=t("adj_cnt_sl"),
                    band_adj_index=ix["adj_mask"], band_cnt_index=ix["adj_cnt"],
                    band_cnt_sl_index=ix["adj_cnt_sl"],
                    band_inv_deg=t("inv_degp"), band_dinv_sl=t("dinv_slp"), band_dinv=t("dinvp"),
                    band_win_start=tuple(b * self.BLK - self.U for b in range(self.nbL)),
                    band_W=self.W, band_n_pad=self.chunk, band_U=self.U, band_R=self.R,
                    band_attn=self.band_attn, axis_name=mesh,
                )
        return self._graphs[key]


def build_halo_partition(template: GraphTemplate, gp: int, band_attn: Optional[str] = None,
                         band_block: Optional[int] = None) -> HaloPartition:
    """Slice the template's uniform band layout (``band_block`` as
    ``GraphTemplate.band_layout`` takes it) into ``gp`` contiguous block-row
    chunks, the trailing ones padded with empty blocks. ``band_attn`` names
    the route, None for ``ops.banded.band_attention_route``."""
    bl = template.band_layout(band_block)
    nB = len(bl.win_start)
    BLK, W = bl.BLK, bl.W
    U, R = bops.halo_widths(bl.win_start, W, bl.n_pad)
    nbL = -(-nB // gp)
    chunk = nbL * BLK
    if U > chunk or R > chunk:
        raise ValueError(f"halo ({U}/{R} rows) exceeds the per-rank chunk ({chunk} rows); "
                         f"use fewer graph-axis shards than gp={gp} for this template")
    if band_attn is None:
        band_attn = bops.band_attention_route(BLK, W)
    if band_attn not in bops.BAND_ATTN_ROUTES:
        raise ValueError(f"band_attn {band_attn!r} is not one of {bops.BAND_ATTN_ROUTES}")
    nB_pad = gp * nbL

    def pad_stack(a: np.ndarray) -> np.ndarray:
        out = np.zeros((nB_pad,) + a.shape[1:], a.dtype)
        out[:nB] = a
        return out.reshape(gp, nbL, *a.shape[1:])

    def pad_rows(v: np.ndarray) -> np.ndarray:
        out = np.zeros(gp * chunk, np.float32)
        out[: len(v)] = v
        return out.reshape(gp, chunk)

    band_arrays = {"adj_mask": pad_stack(bl.adj_mask), "adj_cnt": pad_stack(bl.adj_cnt),
                   "adj_cnt_sl": pad_stack(bl.adj_cnt_sl), "inv_degp": pad_rows(bl.inv_deg_perm),
                   "dinv_slp": pad_rows(bl.dinv_sl_perm), "dinvp": pad_rows(bl.dinv_perm)}
    return HaloPartition(gp=gp, nbL=nbL, BLK=BLK, W=W, U=U, R=R, chunk=chunk,
                         n_pad_dist=gp * chunk, n_orig=template.n_node, perm=bl.perm,
                         band_arrays=band_arrays, band_attn=band_attn)
