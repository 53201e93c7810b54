"""Share of the traced window in which no kernel or copy ran on the device,
in %."""

from port_bench import readers


def read(rec):
    return readers.idle_pct(rec)
