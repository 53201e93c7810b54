"""K2 (csrc/sft_writeback.cu forward): the least time its calls' bytes need
at the memory's rate, over its device time in the trace, in %."""

from port_bench import readers


def read(rec):
    return readers.k2_roofline_pct(rec)
