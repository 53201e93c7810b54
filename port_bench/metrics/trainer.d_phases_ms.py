"""Device ms of phases D and SRD (the trainer's marks 1 to 3), median over
the window's steps."""

from port_bench import readers


def read(rec):
    return readers.phase_ms(rec, 1, 3)
