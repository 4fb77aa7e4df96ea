"""The band SpMM kernels' share of their roofline, in a serve cell (``readers.spmm_roofline``)."""

from wdnbench import readers

UNIT = "%"
MOVES = "serve_snapshots_per_s"
read = readers.for_kind("serve", readers.spmm_roofline)
