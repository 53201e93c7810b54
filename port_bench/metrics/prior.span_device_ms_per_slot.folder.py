"""Device ms of the ``pipeline/prior`` spans (CUDA events the program
records), over ``MARCONet.slots``."""

from port_bench import span_readers


def read(rec):
    return span_readers.span_device_ms_per(rec, "pipeline/prior",
                                           "MARCONet.slots")
