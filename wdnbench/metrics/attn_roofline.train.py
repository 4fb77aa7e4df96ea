"""The band-attention kernels' share of their roofline, in a train cell
(``readers.attn_roofline``)."""

from wdnbench import readers

UNIT = "%"
MOVES = "train_snapshots_per_s"
read = readers.for_kind("train", readers.attn_roofline)
