"""The whole batch's share of the card's float32 peak, in a serve cell (``readers.mfu``)."""

from wdnbench import readers

UNIT = "%"
MOVES = "serve_snapshots_per_s"
read = readers.for_kind("serve", readers.mfu)
