"""Self time of the page server's ``serve/prep`` spans (checks, host prep,
stacking, pinning, the upload), in ms, over its ``restore_lines`` calls."""

from port_bench import span_readers


def read(rec):
    return span_readers.self_ms_per(rec, "serve/prep", span_readers.CALLS)
