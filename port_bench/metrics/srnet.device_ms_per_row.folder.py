"""Device ms of the SR net's forwards (CUDA events in forward hooks), over
their rows."""

from port_bench import readers


def read(rec):
    return readers.net_ms_per_row(rec, "srnet")
