"""Useful operations of the lines restored (each segment at its own
character count, from the reference's shapes) over the window, as a
share of the bf16 peak, in %."""

from port_bench import readers


def read(rec):
    return readers.restore_mfu_pct(rec)
