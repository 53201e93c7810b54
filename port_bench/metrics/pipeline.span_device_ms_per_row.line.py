"""Device ms of the ``pipeline/restore`` spans (CUDA events the program
records), over ``MARCONet.rows``."""

from port_bench import span_readers


def read(rec):
    return span_readers.span_device_ms_per(rec, "pipeline/restore",
                                           "MARCONet.rows")
