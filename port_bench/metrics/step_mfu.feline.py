"""Useful operations of the calls over the window as a share of the
card's peaks, in %: YOLO11-m at each call's letterboxed shape and the
recognizer at the windows it read (``CharacterFrontend.segments``), at the
f32 peak; the restore of the lines and characters restored
(``TextPageRestorer.rows_real``, ``.slots_real``), at the bf16 peak. Each
part's operations over its own peak is the least time it could take; the
sum over the window is the share."""

from port_bench.counts import frontend, roofline


def read(rec):
    counts = rec.get("counters", {})
    segments = counts.get("CharacterFrontend.segments")
    lines = counts.get("TextPageRestorer.rows_real")
    if not segments or not lines or rec["window_s"] <= 0:
        return None
    cfg = rec["config"]
    ocr = cfg["frontend"]["ocr"]
    front = sum(frontend.yolo(h, w) for h, w in rec["letterboxed"])
    front += segments * frontend.ocr(4 * ocr["seq_len"], ocr)
    restore = frontend.restore_lines(lines,
                                     counts["TextPageRestorer.slots_real"],
                                     cfg["width"])
    least = (front / roofline.PEAK_OPS[cfg["frontend"]["dtype"]]
             + restore / roofline.PEAK_OPS[cfg["compute_dtype"]])
    return 100.0 * least / rec["window_s"]
