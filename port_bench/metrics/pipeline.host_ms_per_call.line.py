"""Host ms of the ``pipeline/restore`` spans (the host enqueuing a restore),
over ``MARCONet.restores``."""

from port_bench import span_readers


def read(rec):
    return span_readers.host_ms_per(rec, "pipeline/restore",
                                    "MARCONet.restores")
