"""The work a GATRes batch or training step needs, from the model's shapes and
the network's edges alone.

Every count here is a function of the configuration (blocks, channels,
heads) and of the graph (nodes ``n``, directed edges ``E``, batch ``B``): it
does not see how the program lays the graph out. Band blocks, halo rows,
padded rows, re-read rows and the softmax statistics one implementation
keeps are not counted, so a change of layout leaves the yardstick where it
was. Each input byte is counted as read once and each output byte as
written once; an edge is its (sender, receiver) pair of int32.

Peaks are NVIDIA's data-sheet figures for one H100 SXM: 3.35 TB/s of HBM
and 67 TFLOP/s of float32 outside the tensor cores (the configurations run
float32 with TF32 off).
"""

from __future__ import annotations

from dataclasses import dataclass

PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
F32 = 4
EDGE_BYTES = 8          # sender and receiver, int32 each


@dataclass(frozen=True)
class Shapes:
    """One batch of ``B`` copies of a network of ``n`` nodes and ``E``
    directed edges (self-loops not included), through a GATRes of
    ``blocks`` blocks of ``channels`` channels whose conv1 has ``heads1``
    concatenated heads and conv2 ``heads2`` averaged ones."""

    B: int
    n: int
    E: int
    blocks: int
    channels: int
    heads1: int
    heads2: int

    @property
    def N(self) -> int:
        return self.B * self.n

    @property
    def edges(self) -> int:
        """Directed edges of the batch, as the mean conv aggregates them."""
        return self.B * self.E

    @property
    def edges_sl(self) -> int:
        """Edges the attention aggregates: the graph's plus one self-loop a node."""
        return self.B * (self.E + self.n)


@dataclass(frozen=True)
class Work:
    flops: float
    bytes: float

    def __add__(self, other: "Work") -> "Work":
        return Work(self.flops + other.flops, self.bytes + other.bytes)

    def __mul__(self, k: float) -> "Work":
        return Work(self.flops * k, self.bytes * k)

    def bound_s(self) -> float:
        """The least time the card could take: bytes or operations at peak."""
        return max(self.bytes / PEAK_BYTES_S, self.flops / PEAK_F32_FLOP_S)

    def bound_by(self) -> str:
        return "bytes" if self.bytes / PEAK_BYTES_S >= self.flops / PEAK_F32_FLOP_S else "operations"


def attention_fwd(s: Shapes, heads: int) -> Work:
    """One GATConv's aggregation: read the projected rows [N, H·C] and both
    logit halves [N, H] and the edges, write [N, H·C]; 2·C operations an edge
    and head for the weighted sum."""
    C, N = s.channels, s.N
    return Work(flops=2.0 * C * heads * s.edges_sl,
                bytes=F32 * (2 * N * heads * C + 2 * N * heads) + EDGE_BYTES * s.edges_sl)


def attention_bwd(s: Shapes, heads: int) -> Work:
    """Its backward: read d out and the projected rows [N, H·C], the logit
    halves and the edges; write d x [N, H·C] and both halves' cotangents
    [N, H]; 4·C operations an edge and head (d α and d x)."""
    C, N = s.channels, s.N
    return Work(flops=4.0 * C * heads * s.edges_sl,
                bytes=F32 * (3 * N * heads * C + 4 * N * heads) + EDGE_BYTES * s.edges_sl)


def spmm(s: Shapes) -> Work:
    """The mean conv's neighbour sum, forward or backward alike: read
    [N, C] and the edges, write [N, C]; 2·C operations an edge."""
    C, N = s.channels, s.N
    return Work(flops=2.0 * C * s.edges, bytes=F32 * 2 * N * C + EDGE_BYTES * s.edges)


def attention_work(s: Shapes, train: bool) -> Work:
    """Every band-attention call of one forward (serving) or step (training)."""
    w = attention_fwd(s, s.heads1) + attention_fwd(s, s.heads2)
    if train:
        w = w + attention_bwd(s, s.heads1) + attention_bwd(s, s.heads2)
    return w * s.blocks


def spmm_work(s: Shapes, train: bool) -> Work:
    """Every band SpMM call of one forward or step (the backward is one more)."""
    return spmm(s) * (s.blocks * (2 if train else 1))


def model_flops(s: Shapes, train: bool) -> float:
    """Operations the model needs for one forward: a block's two projections
    2·N·(C·H1·C + H1·C·H2·C), 2·C a head and edge for the two attentions,
    2·C an edge for the mean conv; plus lin0 and lin1. A step counts its
    backward as twice its forward."""
    C, N = s.channels, s.N
    gemm = 2.0 * N * (C * s.heads1 * C + s.heads1 * C * s.heads2 * C)
    attn = 2.0 * C * (s.heads1 + s.heads2) * s.edges_sl
    mean = 2.0 * C * s.edges
    fwd = s.blocks * (gemm + attn + mean) + 2.0 * N * C * 2
    return 3.0 * fwd if train else fwd


def roofline_pct(bound_s: float, device_s: float):
    """Share of the roofline, in %, or None when no device time was read."""
    if device_s <= 0:
        return None
    return 100.0 * bound_s / device_s


def mfu_pct(flops: float, window_s: float):
    if window_s <= 0:
        return None
    return 100.0 * flops / (window_s * PEAK_F32_FLOP_S)


def idle_pct(busy_s: float, window_s: float):
    """Share of the window in which no operation ran on the device, in %."""
    if window_s <= 0:
        return None
    return 100.0 * (1.0 - busy_s / window_s)
