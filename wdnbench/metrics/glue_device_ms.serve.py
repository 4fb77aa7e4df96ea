"""Device milliseconds a batch in the glue, in a serve cell (``readers.glue_device_ms``)."""

from wdnbench import readers

UNIT = "ms"
MOVES = "serve_snapshots_per_s"
read = readers.for_kind("serve", readers.glue_device_ms)
