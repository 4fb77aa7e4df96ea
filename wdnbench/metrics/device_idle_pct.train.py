"""The share of the traced device timeline with nothing running, in a train cell
(``readers.device_idle_pct``)."""

from wdnbench import readers

UNIT = "%"
MOVES = "train_snapshots_per_s"
read = readers.for_kind("train", readers.device_idle_pct)
