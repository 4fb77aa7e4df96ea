"""Device milliseconds a step in the glue, in a train cell (``readers.glue_device_ms``)."""

from wdnbench import readers

UNIT = "ms"
MOVES = "train_snapshots_per_s"
read = readers.for_kind("train", readers.glue_device_ms)
