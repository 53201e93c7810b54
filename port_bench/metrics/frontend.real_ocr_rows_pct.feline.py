"""Masked windows recognized (``CharacterFrontend.segments``) over the
recognizer rows run, padding to a power of two included
(``CharacterFrontend.ocr_rows``), in %."""

from port_bench import span_readers


def read(rec):
    return span_readers.ratio_pct(rec, "CharacterFrontend.segments",
                                  "CharacterFrontend.ocr_rows")
