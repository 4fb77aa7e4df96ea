"""Host seconds the program spent in set-up loading its CUDA kernels from its
build directory (``ops._build.load``): the kernels the cell's own warm-up
uses, built first in a checkout's first run."""

UNIT = "s"
MOVES = "setup_s"


def read(ctx):
    return ctx["setup"].get("kernel_load_s")
