"""K1b (csrc/fused_act.cu backward): the least time its calls' bytes need
at the memory's rate, over its device time in the trace, in %."""

from port_bench import readers


def read(rec):
    return readers.k1b_roofline_pct(rec)
