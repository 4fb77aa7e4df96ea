"""Host milliseconds of a served request outside its forward and read-back:
the median over the traced window's requests of the program's spans
``infer.scale`` + ``infer.upload`` + ``infer.serve`` (``spans.window_median_ms``).
In a closed loop the device has nothing of the request to do meanwhile."""

from wdnbench import spans

UNIT = "ms"
MOVES = "serve_batch_p95_ms"


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    return spans.window_median_ms(ctx, "infer", ("infer.scale", "infer.upload", "infer.serve"))
