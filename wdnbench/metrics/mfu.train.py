"""The whole step's share of the card's float32 peak, in a train cell (``readers.mfu``)."""

from wdnbench import readers

UNIT = "%"
MOVES = "train_snapshots_per_s"
read = readers.for_kind("train", readers.mfu)
