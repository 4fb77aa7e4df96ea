"""Random node masking.

The counterpart of ``gnn_pressure_estimation_tpu/utils/masking.py``: per
graph exactly ``k = int(n * mask_rate)`` nodes are masked, with an optional
set of always-masked sensor indices that count towards ``k``. The uniform
draws come from an explicit ``torch.Generator`` (the JAX PRNG stream cannot
be reproduced, so parity tests hand one explicit mask to both packages).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def masked_count(num_nodes: int, mask_rate: float) -> int:
    """Number of masked nodes per graph: ``int(num_nodes * mask_rate)``,
    required indices included in the count."""
    k = int(num_nodes * mask_rate)
    if k <= 0:
        raise ValueError(f"mask_rate {mask_rate} masks 0 of {num_nodes} nodes")
    return k


def mask_from_uniform(u: torch.Tensor, k: int,
                      required_idx: Optional[Sequence[int]] = None) -> torch.Tensor:
    """``u`` [rows, n] f32 draws in [0, 1) → [rows, n] bool with exactly
    ``k`` True per row: the ``k`` smallest draws, required indices first.

    Exactly ``k`` holds even for duplicated draws (the loss divides by a
    fixed count): the high bits of each draw's bit pattern, which is monotone
    for a non-negative float, are kept and the column index is packed into
    the low bits, a strict total order. The JAX package breaks ties the
    same way."""
    rows, n = u.shape
    nbits = max(int(n - 1).bit_length(), 1)
    if nbits > 23:
        raise ValueError(f"{n} nodes exceed the tie-break packing range")
    bits = u.contiguous().view(torch.int32)
    iota = torch.arange(n, dtype=torch.int32, device=u.device)
    keys = ((bits >> nbits) << nbits) | iota[None, :]
    if required_idx is not None and len(required_idx):
        req = torch.as_tensor(list(required_idx), dtype=torch.long, device=u.device)
        # required entries take the smallest (distinct) keys of all
        keys[:, req] = torch.arange(len(req), dtype=torch.int32, device=u.device) - (1 << 30)
    kth = torch.kthvalue(keys, k, dim=1, keepdim=True).values
    return keys <= kth


def batch_node_mask(
    generator: torch.Generator,
    n_graph: int,
    nodes_per_graph: int,
    mask_rate: float,
    required_idx: Optional[Sequence[int]] = None,
    shared: bool = False,
    device="cpu",
) -> torch.Tensor:
    """Draw a ``[n_graph * nodes_per_graph]`` boolean mask on ``device``,
    True = masked. The draws are made on the generator's own device, so a CPU
    generator gives the card the mask it gives the CPU.

    ``shared=True`` draws one mask and repeats it for every graph of the
    batch; ``required_idx`` nodes are always masked."""
    n, k = nodes_per_graph, masked_count(nodes_per_graph, mask_rate)
    rows = 1 if shared else n_graph
    u = torch.rand((rows, n), generator=generator, device=generator.device, dtype=torch.float32)
    mask = mask_from_uniform(u, k, required_idx)
    if shared:
        mask = mask.expand(n_graph, n)
    return mask.reshape(-1).to(device)
