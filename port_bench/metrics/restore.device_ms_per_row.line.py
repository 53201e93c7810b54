"""Device ms of the net's restore calls (CUDA events around each call the
page server makes), over the rows they restored."""

from port_bench import readers


def read(rec):
    return readers.restore_ms_per_row(rec)
