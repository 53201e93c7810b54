"""Share of rank 0's traced window in which no kernel or copy ran on its
card, in %."""

from port_bench import readers


def read(rec):
    return readers.idle_pct(rec)
