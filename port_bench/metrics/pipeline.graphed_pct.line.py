"""Restores served by replaying CUDA graphs (``MARCONet.graph_replays``)
over the restores made (``MARCONet.restores``), in %."""

from port_bench import span_readers


def read(rec):
    return span_readers.ratio_pct(rec, "MARCONet.graph_replays",
                                  "MARCONet.restores")
