"""Device ms of phase G (the trainer's marks 0 to 1), median over the
window's steps."""

from port_bench import readers


def read(rec):
    return readers.phase_ms(rec, 0, 1)
