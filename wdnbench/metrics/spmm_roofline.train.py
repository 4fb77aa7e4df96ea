"""The band SpMM kernels' share of their roofline, in a train cell (``readers.spmm_roofline``)."""

from wdnbench import readers

UNIT = "%"
MOVES = "train_snapshots_per_s"
read = readers.for_kind("train", readers.spmm_roofline)
