"""Host seconds of the graph layout, from the program's own set-up spans: the
network parsed (``inp.parse``), the template built (``template.build``), the
batches built (``graph.batch``) with the band layout and its indexes
(``graph.band_layout``, ``graph.band_index``), each counted in the outermost
of them (``spans.outermost_s``). The in-program counterpart of
``graph_build_s``, which also counts batches the entry points build."""

from wdnbench import spans

UNIT = "s"
MOVES = "setup_s"


def read(ctx):
    return spans.outermost_s(spans.GRAPH_LAYOUT)
