"""Edge-list gathers and the receiver segment sum, without atomics.

The counterpart of the part of ``gnn_pressure_estimation_tpu/ops/segment.py``
that m_GCN's GENConv calls in every aggregation mode: ``gather`` (``x[idx]``
over the edges), ``gather_src`` and ``segment_sum`` over receiver-sorted
edges. The JAX functions are plain XLA; these are plain PyTorch.

A scatter-add (``index_add_``, or autograd of ``x[idx]``) on CUDA floats
adds in whatever order the atomics land, so a run would not repeat to the
bit. Here every sum is a gather into a fixed slot table and a sum over the
slot axis, as ``ops.padded`` does: the in-edge table lists each node's
incoming edges (``segment_sum``, and the backward of ``gather`` over the
receivers), the out-edge table its outgoing edges (the backward of
``gather_src``). Both are built on the host once per template
(:func:`build_edge_slots`) and held by the batched graph as an
:class:`EdgeSlots`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _slot_table(groups: np.ndarray, n: int):
    """Edge ids grouped by ``groups[e]`` (ascending edge id within a group)
    → ``[n, D]`` slot table and its mask; empty slots hold edge 0."""
    order = np.concatenate([np.argsort(groups, kind="stable"), [0]])   # [E + 1]: 0 pads
    cnt = np.bincount(groups, minlength=n)
    D = max(int(cnt.max(initial=0)), 1)
    start = np.cumsum(cnt) - cnt
    k = np.arange(D)[None, :]
    mask = k < cnt[:, None]
    slots = order[np.where(mask, start[:, None] + k, len(order) - 1)]
    return slots.astype(np.int64), mask


def build_edge_slots(senders: np.ndarray, receivers: np.ndarray, n: int) -> dict:
    """Host tables of one graph's edge list (``n`` nodes): the in-edge slots
    (edges by receiver) and the out-edge slots (edges by sender), each
    ``[n, D]`` with its mask."""
    in_slots, in_mask = _slot_table(np.asarray(receivers), n)
    out_slots, out_mask = _slot_table(np.asarray(senders), n)
    return {"in_slots": in_slots, "in_mask": in_mask, "out_slots": out_slots,
            "out_mask": out_mask}


@dataclasses.dataclass(frozen=True)
class EdgeSlots:
    """A batch's edge list (graph offsets applied, receiver-sorted) with its
    slot tables, as tensors on one device."""

    senders: torch.Tensor      # [E] long
    receivers: torch.Tensor    # [E] long, sorted
    in_slots: torch.Tensor     # [N, D_in] long: the edges into each node
    in_mask: torch.Tensor      # [N, D_in] bool
    out_slots: torch.Tensor    # [N, D_out] long: the edges out of each node
    out_mask: torch.Tensor     # [N, D_out] bool

    @classmethod
    def tiled(cls, senders, receivers, tables: dict, B: int, n: int, dev) -> "EdgeSlots":
        """``B`` copies of one graph's edge list and tables: graph ``b``'s
        node ids shift by ``b·n`` and its edge ids by ``b·E``."""
        E = len(senders)
        node_offs = np.arange(B, dtype=np.int64)[:, None] * n
        edge_offs = np.arange(B, dtype=np.int64)[:, None, None] * E

        def edges(a):
            return torch.as_tensor((np.asarray(a, np.int64)[None] + node_offs).reshape(-1),
                                   device=dev)

        def slots(t):
            return torch.as_tensor((t[None] + edge_offs).reshape(-1, t.shape[1]), device=dev)

        def mask(m):
            return torch.as_tensor(np.tile(m, (B, 1)), device=dev)

        return cls(edges(senders), edges(receivers), slots(tables["in_slots"]),
                   mask(tables["in_mask"]), slots(tables["out_slots"]), mask(tables["out_mask"]))


def slot_sum(data: torch.Tensor, slots: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``out[i] = Σ_d data[slots[i, d]]`` over the valid slots, in slot
    order: [E, ...] → [N, ...]."""
    got = data[slots]                                            # [N, D, ...]
    m = mask.reshape(mask.shape + (1,) * (data.dim() - 1))
    return torch.where(m, got, 0.0).sum(dim=1)


class _Gather(torch.autograd.Function):
    """``x[idx]`` whose backward sums each node's edge cotangents over the
    slot table of ``idx`` (the edges that read the node)."""

    @staticmethod
    def forward(ctx, x, idx, slots, mask):
        ctx.save_for_backward(slots, mask)
        return x[idx]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        slots, mask = ctx.saved_tensors
        return slot_sum(g, slots, mask), None, None, None


class _SegmentSum(torch.autograd.Function):
    """The slot sum whose backward gathers the node cotangent back to each
    edge: the transpose of :class:`_Gather`."""

    @staticmethod
    def forward(ctx, data, idx, slots, mask):
        ctx.save_for_backward(idx)
        return slot_sum(data, slots, mask)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return g[idx], None, None, None


def gather(x: torch.Tensor, edges: EdgeSlots) -> torch.Tensor:
    """``x[receivers]``: each edge's receiver row, [N, ...] → [E, ...]."""
    return _Gather.apply(x, edges.receivers, edges.in_slots, edges.in_mask)


def gather_src(x: torch.Tensor, edges: EdgeSlots) -> torch.Tensor:
    """``x[senders]``: each edge's sender row, [N, ...] → [E, ...]."""
    return _Gather.apply(x, edges.senders, edges.out_slots, edges.out_mask)


def segment_sum(data: torch.Tensor, edges: EdgeSlots) -> torch.Tensor:
    """Σ over each node's incoming edges, [E, ...] → [N, ...]; a node with
    none gets zeros."""
    return _SegmentSum.apply(data, edges.receivers, edges.in_slots, edges.in_mask)
