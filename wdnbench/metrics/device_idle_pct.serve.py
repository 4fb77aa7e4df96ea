"""The share of the traced device timeline with nothing running, in a serve cell
(``readers.device_idle_pct``)."""

from wdnbench import readers

UNIT = "%"
MOVES = "serve_snapshots_per_s"
read = readers.for_kind("serve", readers.device_idle_pct)
