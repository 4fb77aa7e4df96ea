"""Host milliseconds a step spends preparing its batch (graph lookup, node
packing): the median over the traced window's steps of the program's span
``train.prepare`` less its child ``train.upload`` (``spans.window_median_ms``).
The uploads are left out: from pageable memory they wait for the stream to
drain, so their time is the card's pace, not the host's work."""

from wdnbench import spans

UNIT = "ms"
MOVES = "train_snapshots_per_s"


def read(ctx):
    if ctx["kind"] != "train":
        return None
    return spans.window_median_ms(ctx, "train_step", ("train.prepare",))
