"""The window's idle device time that falls in the self time of the front
end's ``frontend/*`` spans, over the window, in %."""

from port_bench import span_readers


def read(rec):
    return span_readers.idle_in_pct(rec, "frontend/")
