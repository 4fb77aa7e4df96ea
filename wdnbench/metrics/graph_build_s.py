"""Host seconds of the graph layout in set-up: the network parsed, the
``GraphTemplate`` built and batched (``.batch``: band layout, indexes, the
tensors on the device)."""

UNIT = "s"
MOVES = "setup_s"


def read(ctx):
    return ctx["setup"].get("graph_build_s")
