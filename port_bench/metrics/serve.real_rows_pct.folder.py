"""Rows that hold a request, over the rows restored (the page server's
padding of chunks to their bucket; its counts ``rows_real`` and ``rows``),
in %."""

from port_bench import span_readers


def read(rec):
    return span_readers.ratio_pct(rec, "TextPageRestorer.rows_real",
                                  "TextPageRestorer.rows")
