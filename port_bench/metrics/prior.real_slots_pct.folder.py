"""Character slots that hold a character, over the slots restored (the page
server's counts ``slots_real`` and ``slots``: rows times the chunk's slot
bucket), in %."""

from port_bench import span_readers


def read(rec):
    return span_readers.ratio_pct(rec, "TextPageRestorer.slots_real",
                                  "TextPageRestorer.slots")
