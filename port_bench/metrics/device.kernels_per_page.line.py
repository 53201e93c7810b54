"""Kernel launches in the trace over the pages restored."""

from port_bench import readers


def read(rec):
    return readers.kernels_per_page(rec)
