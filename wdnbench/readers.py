"""The bodies of the per-layer metrics that every kind of cell reads alike.

A metric's own file (``metrics/<name>.py``) names its unit and the
end-to-end metric it moves, and takes one of these for the kind of cell it
is read in (``for_kind``): in a cell of another kind it reads nothing. Each
body takes the context the harness hands a reader, ``ctx``: the cell's
``kind``, its set-up times (``setup``), its ``shapes`` and the traced window's
``trace`` (``harness.profile_window``).
"""

from wdnbench import counts


def for_kind(kind: str, body):
    """A reader that applies ``body`` in cells of ``kind`` and reads nothing
    in others."""
    def read(ctx):
        return body(ctx) if ctx["kind"] == kind else None
    return read


def _train(ctx) -> bool:
    return ctx["kind"] == "train"


def attn_roofline(ctx):
    """The band-attention kernels' share of their roofline: the least time
    the card needs for every band-attention call of the traced window
    (``counts.attention_work``: forward, and backward in a step) over the
    device time the trace gives those kernels."""
    tr = ctx["trace"]
    bound = counts.attention_work(ctx["shapes"], train=_train(ctx)).bound_s() * tr["iters"]
    return counts.roofline_pct(bound, tr["groups"].get("attn", 0.0))


def spmm_roofline(ctx):
    """The band SpMM kernels' (the mean conv's) share of their roofline: the
    least time for every SpMM call of the traced window
    (``counts.spmm_work``) over the device time the trace gives them."""
    tr = ctx["trace"]
    bound = counts.spmm_work(ctx["shapes"], train=_train(ctx)).bound_s() * tr["iters"]
    return counts.roofline_pct(bound, tr["groups"].get("spmm", 0.0))


def glue_device_ms(ctx):
    """Device milliseconds an iteration in kernels that are neither the
    program's own (its CUDA sources' entries) nor launched by a matrix
    product: the elementwise ops, reductions and concatenations around
    the kernels."""
    tr = ctx["trace"]
    if not tr["kernels"]:
        return None
    return 1e3 * tr["groups"].get("glue", 0.0) / tr["iters"]


def mfu(ctx):
    """The whole iteration's share of the card's float32 peak: the
    operations the model needs an iteration (``counts.model_flops``) times
    the iterations of the untraced window, over that window's host-clock
    length times 67 TFLOP/s."""
    tr = ctx["trace"]
    return counts.mfu_pct(counts.model_flops(ctx["shapes"], train=_train(ctx)) * tr["iters"],
                          tr["untraced_s"])


def device_idle_pct(ctx):
    """The share of the traced window's device timeline, from its first
    device operation's start to its last one's end, in which nothing ran on
    the device: one less the union of every device interval over that
    span."""
    tr = ctx["trace"]
    if not tr["kernels"]:
        return None
    return counts.idle_pct(tr["busy_s"], tr["span_s"])
