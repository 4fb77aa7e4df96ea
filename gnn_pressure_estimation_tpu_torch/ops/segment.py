"""Message-passing primitives over a receiver-sorted edge list, without atomics.

The counterpart of ``gnn_pressure_estimation_tpu/ops/segment.py``:
``gather`` (``x[idx]`` over the edges), ``gather_src``, ``segment_sum``,
``segment_mean``, ``segment_max``, ``segment_softmax``, ``spmm`` (with edge
weights and an edge mask) and ``sddmm_dot``. The JAX functions are plain
XLA; these are plain PyTorch.

A scatter-add (``index_add_``, or autograd of ``x[idx]``) on CUDA floats
adds in whatever order the atomics land, so a run would not repeat to the
bit. Here every sum is a gather into a fixed slot table and a sum over the
slot axis, as ``ops.padded`` does: the in-edge table lists each node's
incoming edges (``segment_sum``, and the backward of ``gather`` over the
receivers), the out-edge table its outgoing edges (the backward of
``gather_src``). Both are built on the host once per template
(:func:`build_edge_slots`) and held by the batched graph as an
:class:`EdgeSlots`.

Edge-partitioned mode (``axis`` given: the ``parallel.mesh.Mesh`` of the
run, whose graph group holds the node blocks): the senders are global ids
into the blocks of every rank of the graph group, gathered by a
differentiable all-gather (:func:`all_gather_blocks`), and the receivers are
local ids. The all-gather's backward sums each block's cotangent over the
group and hands every rank its own block: a reduce-scatter under NCCL, and
under gloo, which has none, an all-reduce of the whole cotangent of which
each rank keeps its block (the same sums). Padding edges (``edge_mask``
False) are left out of the slot tables, so they add nothing anywhere.

``segment_softmax`` takes each receiver's maximum as a constant shift: the
softmax is invariant to it, so its gradient through the maximum is zero in
exact arithmetic (the JAX function differentiates through it and gets
rounding noise there).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def _slot_table(groups: np.ndarray, n: int, valid: Optional[np.ndarray] = None):
    """Edge ids grouped by ``groups[e]`` (ascending edge id within a group;
    edges with ``valid`` False left out) → ``[n, D]`` slot table and its
    mask; empty slots hold edge 0."""
    groups = np.asarray(groups)
    ids = np.arange(len(groups)) if valid is None else np.nonzero(np.asarray(valid))[0]
    g = groups[ids]
    order = np.concatenate([ids[np.argsort(g, kind="stable")], [0]])   # [E + 1]: 0 pads
    cnt = np.bincount(g, minlength=n)
    D = max(int(cnt.max(initial=0)), 1)
    start = np.cumsum(cnt) - cnt
    k = np.arange(D)[None, :]
    mask = k < cnt[:, None]
    slots = order[np.where(mask, start[:, None] + k, len(order) - 1)]
    return slots.astype(np.int64), mask


def build_edge_slots(senders: np.ndarray, receivers: np.ndarray, n: int,
                     n_src: Optional[int] = None, valid: Optional[np.ndarray] = None) -> dict:
    """Host tables of one graph's edge list (``n`` receiving nodes, ``n_src``
    sending ones, ``n`` by default): the in-edge slots (edges by receiver)
    and the out-edge slots (edges by sender), each ``[·, D]`` with its mask;
    edges with ``valid`` False are in neither."""
    in_slots, in_mask = _slot_table(np.asarray(receivers), n, valid)
    out_slots, out_mask = _slot_table(np.asarray(senders), n if n_src is None else n_src, valid)
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
    out_slots: torch.Tensor    # [N_src, D_out] long: the edges out of each node
    out_mask: torch.Tensor     # [N_src, D_out] bool

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

    @classmethod
    def of(cls, senders, receivers, n: int, dev, n_src: Optional[int] = None,
           valid=None) -> "EdgeSlots":
        """One edge list as it is (no tiling): ``n`` receiving nodes,
        ``n_src`` sending ones (the edge partition's global ids)."""
        t = build_edge_slots(senders, receivers, n, n_src, valid)

        def move(a):
            return torch.as_tensor(np.asarray(a), device=dev)
        return cls(move(np.asarray(senders, np.int64)), move(np.asarray(receivers, np.int64)),
                   move(t["in_slots"]), move(t["in_mask"]), move(t["out_slots"]),
                   move(t["out_mask"]))


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


class _SegmentMax(torch.autograd.Function):
    """Each node's maximum over its incoming edges (a node with none gets
    −inf). Backward: the node cotangent goes to the edges that hold the
    maximum, shared equally among ties, as ``torch.amax`` shares it."""

    @staticmethod
    def forward(ctx, data, idx, slots, mask):
        m = mask.reshape(mask.shape + (1,) * (data.dim() - 1))
        out = torch.where(m, data[slots], float("-inf")).amax(dim=1)
        ctx.save_for_backward(data, out, idx, slots, mask)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        data, out, idx, slots, mask = ctx.saved_tensors
        hit = (data == out[idx]).to(g.dtype)
        ties = slot_sum(hit, slots, mask).clamp(min=1.0)
        return hit * (g / ties)[idx], None, None, None


def _masked(t: torch.Tensor, edge_mask: Optional[torch.Tensor], fill=0.0) -> torch.Tensor:
    if edge_mask is None:
        return t
    return torch.where(edge_mask.reshape(edge_mask.shape + (1,) * (t.dim() - 1)), t, fill)


class _AllGather(torch.autograd.Function):
    """The graph group's node blocks, rank order, tiled on the first axis;
    backward: each block's cotangent summed over the group (``Mesh``'s
    ``sum_blocks``)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.gather_blocks(x)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return ctx.axis.sum_blocks(g.contiguous()), None


def all_gather_blocks(x: torch.Tensor, axis) -> torch.Tensor:
    """[block, ...] on each rank of ``axis``'s graph group → [gp·block, ...],
    differentiable."""
    return _AllGather.apply(x, axis)


def gather(x: torch.Tensor, edges: EdgeSlots) -> torch.Tensor:
    """``x[receivers]``: each edge's receiver row, [N, ...] → [E, ...]."""
    return _Gather.apply(x, edges.receivers, edges.in_slots, edges.in_mask)


def gather_src(x: torch.Tensor, edges: EdgeSlots, axis=None) -> torch.Tensor:
    """``x[senders]``: each edge's sender row, [N, ...] → [E, ...]; with
    ``axis`` the senders index the all-gathered blocks."""
    if axis is not None:
        x = all_gather_blocks(x, axis)
    return _Gather.apply(x, edges.senders, edges.out_slots, edges.out_mask)


def segment_sum(data: torch.Tensor, edges: EdgeSlots) -> torch.Tensor:
    """Σ over each node's incoming edges, [E, ...] → [N, ...]; a node with
    none gets zeros."""
    return _SegmentSum.apply(data, edges.receivers, edges.in_slots, edges.in_mask)


def segment_mean(data: torch.Tensor, edges: EdgeSlots) -> torch.Tensor:
    """Mean over each node's incoming edges (zeros where there are none)."""
    cnt = edges.in_mask.sum(dim=1).clamp(min=1).to(data.dtype)
    return segment_sum(data, edges) / cnt.reshape((-1,) + (1,) * (data.dim() - 1))


def segment_max(data: torch.Tensor, edges: EdgeSlots) -> torch.Tensor:
    """Max over each node's incoming edges, [E, ...] → [N, ...] (−inf where
    there are none)."""
    return _SegmentMax.apply(data, edges.receivers, edges.in_slots, edges.in_mask)


def segment_softmax(logits: torch.Tensor, edges: EdgeSlots,
                    edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax over the edges of each receiver (PyG ``softmax(src, index)``):
    the receiver's maximum subtracted, exp, normalised; the denominator
    clamped at 1e-16. ``edge_mask`` False excludes an edge from both."""
    logits = _masked(logits, edge_mask, float("-inf"))
    with torch.no_grad():
        seg_max = segment_max(logits, edges)
        seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    ex = torch.exp(logits - seg_max[edges.receivers])
    denom = gather(segment_sum(ex, edges), edges)
    return ex / denom.clamp(min=1e-16)


def spmm(x: torch.Tensor, edges: EdgeSlots, edge_weight: Optional[torch.Tensor] = None,
         axis=None, edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[i] = Σ_{(j→i)} w_e · x[j]``: [N, ...] → [N, ...]. ``edge_weight``
    [E] or [E, H] broadcasts over the trailing axes of x (``[N, H, F]`` with
    per-head weights). ``axis``: edge-partitioned mode (x is the local
    block, the senders global ids). ``edge_mask`` zeroes padding edges."""
    msgs = gather_src(x, edges, axis)
    if edge_weight is not None:
        msgs = msgs * edge_weight.reshape(edge_weight.shape + (1,) * (msgs.dim() - edge_weight.dim()))
    return segment_sum(_masked(msgs, edge_mask), edges)


def sddmm_dot(a: torch.Tensor, b: torch.Tensor, edges: EdgeSlots) -> torch.Tensor:
    """Sampled dense-dense product: per-edge ``<a[src], b[dst]>``."""
    return (gather_src(a, edges) * gather(b, edges)).sum(dim=-1)
