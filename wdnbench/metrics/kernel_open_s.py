"""Host seconds the program spent opening its CUDA kernel libraries, built
first where a checkout has none (its spans ``kernels.open``,
``spans.outermost_s``): ``kernel_load_s`` without the lookups of libraries
already open."""

from wdnbench import spans

UNIT = "s"
MOVES = "setup_s"


def read(ctx):
    return spans.outermost_s(("kernels.open",))
