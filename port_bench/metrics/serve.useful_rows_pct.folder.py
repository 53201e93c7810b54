"""Rows that hold a real segment, over the rows restored (the page server's
padding of chunks to their bucket), in %."""

from port_bench import readers


def read(rec):
    return readers.useful_rows_pct(rec)
