"""Device ms of the prior generator's forwards (CUDA events in forward
hooks), over their character slots."""

from port_bench import readers


def read(rec):
    return readers.net_ms_per_row(rec, "prior")
