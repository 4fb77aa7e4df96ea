"""Degree-padded gather with a gather-based backward.

The counterpart of ``gnn_pressure_estimation_tpu/ops/padded.py``. In the
degree-padded aggregation mode every node's incoming edges are padded to the
largest in-degree, so aggregation is a gather into a fixed slot axis and a
masked reduction over it:

    forward : y[i, d] = x[idx_in[i, d]]                     (in-edge slots)
    backward: x̄[j]    = Σ_e ḡ.flat[out_flat[j, e]]           (out-edge slots)

``out_flat[j]`` lists the flattened ``(i, d)`` positions where node ``j``
appears as a sender, so both directions are gathers plus a masked sum and
neither scatters. The JAX package computes this in plain XLA, outside any
Pallas kernel; here it is plain PyTorch. The backward is written out rather
than left to autograd of indexing, whose CUDA backward scatter-adds with
atomics: with the transpose tables the sums run in a fixed order and a
training run repeats to the bit.
"""

from __future__ import annotations

import numpy as np
import torch


def build_transpose_tables(idx_in: np.ndarray, mask_in: np.ndarray, n_node: int):
    """From in-edge tables [N, D] build out-edge tables (out_flat, out_mask)
    of shape [N, D_out]: flattened positions of each node's appearances."""
    N, D = idx_in.shape
    appearances: list[list[int]] = [[] for _ in range(n_node)]
    flat_idx = idx_in.reshape(-1)
    flat_mask = mask_in.reshape(-1)
    for pos in range(N * D):
        if flat_mask[pos]:
            appearances[int(flat_idx[pos])].append(pos)
    d_out = max((len(a) for a in appearances), default=1) or 1
    out_flat = np.zeros((n_node, d_out), np.int32)
    out_mask = np.zeros((n_node, d_out), bool)
    for j, a in enumerate(appearances):
        out_flat[j, : len(a)] = a
        out_mask[j, : len(a)] = True
    return out_flat, out_mask


class PaddedGather(torch.autograd.Function):
    """``x[idx_in]`` whose backward gathers the slot cotangents over the
    transpose tables and sums the valid out-slots."""

    @staticmethod
    def forward(ctx, x, idx_in, out_flat, out_mask):
        ctx.save_for_backward(out_flat, out_mask)
        return x[idx_in]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        out_flat, out_mask = ctx.saved_tensors
        trailing = g.shape[2:]
        got = g.reshape((-1,) + trailing)[out_flat]                  # [N, D_out, ...]
        m = out_mask.reshape(out_mask.shape + (1,) * len(trailing))
        return torch.where(m, got, 0.0).sum(dim=1), None, None, None


def padded_gather(x: torch.Tensor, idx_in: torch.Tensor, out_flat: torch.Tensor,
                  out_mask: torch.Tensor) -> torch.Tensor:
    """``x`` [N, ...] → [N, D, ...] neighbour slots ``x[idx_in]``; the
    gradient reaches ``x`` through ``out_flat`` / ``out_mask`` (the
    :func:`build_transpose_tables` of ``idx_in`` and its slot mask), never
    through a scatter. Slots outside the mask gather row ``idx_in`` holds
    (a valid row) and are the caller's to mask."""
    return PaddedGather.apply(x, idx_in, out_flat, out_mask)
