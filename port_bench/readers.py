"""What the per-layer metrics read, shared by their modules in
``port_bench/metrics/``.

Each reader takes the traced run's records (the driver's own, with the
profile's summary under ``trace``: device activity, busy time, idle gaps
and every host span, the program's own ``record_function`` ranges with
them under ``host_spans``; the window's change in every count the program
keeps under ``counters``, see ``harness.program_counters``; and the
configuration under ``config``) and returns a number, or None when the
run gave it nothing to read.
"""

from __future__ import annotations

from port_bench import trace as tr
from port_bench.counts import bytes as by
from port_bench.counts import flops, roofline

DTYPE_BYTES = {"float32": 4, "bfloat16": 2}


def _width(rec):
    return rec["config"]["width"]


def _dtype_bytes(rec):
    return DTYPE_BYTES[rec["config"]["compute_dtype"]]


def idle_pct(rec):
    s = rec["trace"]
    if s["window_s"] <= 0 or s["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def useful_rows_pct(rec):
    rows = sum(b for b, _, _ in rec["restore_calls"])
    if not rows:
        return None
    return 100.0 * len(rec["segment_centers"]) / rows


def restore_ms_per_row(rec):
    calls = rec["restore_calls"]
    rows = sum(b for b, _, _ in calls)
    return sum(ms for _, _, ms in calls) / rows if rows else None


def net_ms_per_row(rec, net: str):
    """Device ms of ``net``'s forwards over the rows (slots, for the
    prior) they ran on."""
    calls = rec["nets"].get(net, [])
    rows = sum(r for r, _ in calls)
    return sum(ms for _, ms in calls) / rows if rows else None


def restore_mfu_pct(rec):
    lines = rec["segment_centers"]
    if not lines:
        return None
    ops = sum(flops.restore_line(len(c), _width(rec)) for c in lines)
    return roofline.mfu_pct(ops, rec["window_s"],
                            roofline.PEAK_OPS[rec["config"]["compute_dtype"]])


def k1_roofline_pct(rec):
    nbytes = sum(by.k1_bytes(b * n, _dtype_bytes(rec), _width(rec))
                 for b, n, _ in rec["restore_calls"])
    t = tr.kernel_seconds(rec["trace"], "fused_lrelu_fwd_kernel")
    if not nbytes or not t:
        return None
    return roofline.share_pct(roofline.least_seconds(nbytes), t)


def k2_roofline_pct(rec):
    size, width = _dtype_bytes(rec), _width(rec)
    calls = rec["restore_calls"]
    if not calls:
        return None
    nbytes = sum(by.k2_bytes(b, n, [], size, width) for b, n, _ in calls)
    d = by.prior_channels(width)[64]
    for h, w, half in ((32, 512, 16), (64, 1024, 32)):
        nbytes += sum(by.covered_columns(c, half, w)
                      for c in rec["segment_centers"]) * h * d * size
    t = tr.kernel_seconds(rec["trace"], "sft_writeback_kernel")
    return roofline.share_pct(roofline.least_seconds(nbytes), t) if t \
        else None


def kernels_per_page(rec):
    if not rec["pages"]:
        return None
    return tr.kernel_count(rec["trace"]) / rec["pages"]


def phase_ms(rec, first: int, last: int):
    """Median over the steps of the device ms from mark ``first`` to mark
    ``last`` (0: before G, 1: after G, 2: after D, 3: after SRD)."""
    import numpy as np
    spans = [sum(p[first:last]) for p in rec["phases_ms"] if len(p) == 3]
    return float(np.median(spans)) if spans else None


def train_mfu_pct(rec):
    ops = rec.get("step_ops")
    if not ops or not rec["steps"]:
        return None
    return roofline.mfu_pct(ops * rec["steps"], rec["window_s"],
                            roofline.PEAK_OPS[rec["config"]["compute_dtype"]])


def k1b_roofline_pct(rec):
    slots = rec["batch"] * rec["slots"]
    nbytes = rec["steps"] * by.k1b_bytes(slots, _dtype_bytes(rec),
                                         _width(rec))
    t = tr.kernel_seconds(rec["trace"], "fused_lrelu_bwd_kernel")
    if not t:
        return None
    return roofline.share_pct(roofline.least_seconds(nbytes), t)
