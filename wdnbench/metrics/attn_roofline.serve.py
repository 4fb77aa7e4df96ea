"""The band-attention kernels' share of their roofline, in a serve cell
(``readers.attn_roofline``)."""

from wdnbench import readers

UNIT = "%"
MOVES = "serve_snapshots_per_s"
read = readers.for_kind("serve", readers.attn_roofline)
