"""What the per-layer metrics of the program's own spans and counts read,
shared by their modules in ``port_bench/metrics/``.

The program marks its work with ``record_function`` spans (``serve/*`` in
the page server, ``pipeline/*`` in the restore), which the traced run's
records carry under ``trace.host_spans`` as (start s, end s, name), on the
clock of the idle gaps under ``trace.gaps``; it keeps counts as attributes
(``TextPageRestorer.*``, ``MARCONet.*``) and the device ms of its device
spans in ``settle.device_ms`` of ``marconet_tpu_torch.utils.tracing``,
whose window's change the records carry under ``counters``. Each reader
returns None when the run gave it nothing to read (a program without the
spans or counts, or a count of 0).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

DEVICE_MS = "marconet_tpu_torch.utils.tracing.settle.device_ms."
CALLS = "TextPageRestorer.calls"


def _count(rec, key: str) -> Optional[float]:
    v = rec.get("counters", {}).get(key)
    return v if v else None


def per(rec, key: str, over: str) -> Optional[float]:
    """Counter ``key`` over counter ``over``."""
    a, b = _count(rec, key), _count(rec, over)
    return a / b if a is not None and b is not None else None


def ratio_pct(rec, part: str, whole: str) -> Optional[float]:
    """100 x counter ``part`` over counter ``whole``."""
    v = per(rec, part, whole)
    return None if v is None else 100.0 * v


def self_pieces(spans) -> List[Tuple[float, float, str]]:
    """The stretches of time in which each span is the innermost one open:
    (start, end, name), in order. Spans nest; one that outlasts the span
    around it is cut at that span's end."""
    out: List[Tuple[float, float, str]] = []
    stack: List[Tuple[float, str]] = []      # (end, name), innermost last
    t = 0.0
    for lo, hi, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][0] <= lo:
            end, outer = stack.pop()
            out.append((t, end, outer))
            t = end
        if stack:
            out.append((t, lo, stack[-1][1]))
            hi = min(hi, stack[-1][0])
        stack.append((hi, name))
        t = lo
    while stack:
        end, outer = stack.pop()
        out.append((t, end, outer))
        t = end
    return [p for p in out if p[1] > p[0]]


def self_s(rec, name: str) -> Optional[float]:
    """Seconds of self time of the spans called ``name`` (their duration
    less what their child spans cover); None when there is none."""
    t = sum(hi - lo for lo, hi, n in self_pieces(rec["trace"]["host_spans"])
            if n == name)
    return t or None


def self_ms_per(rec, name: str, over: str) -> Optional[float]:
    """Self ms of span ``name`` over counter ``over``."""
    t, n = self_s(rec, name), _count(rec, over)
    return 1e3 * t / n if t is not None and n is not None else None


def host_ms_per(rec, name: str, over: str) -> Optional[float]:
    """Wall ms of the spans called ``name`` over counter ``over``."""
    t = sum(hi - lo for lo, hi, n in rec["trace"]["host_spans"]
            if n == name)
    n = _count(rec, over)
    return 1e3 * t / n if t and n is not None else None


def _overlap(a, b) -> float:
    """Total length of the intersection of two sorted lists of disjoint
    (start, end, ...) intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in_pct(rec, layer: str) -> Optional[float]:
    """100 x the window's idle time that falls in the self time of the
    spans whose names start with ``layer`` (``serve/``, ``pipeline/``),
    over the window; None when the trace has no such span."""
    s = rec["trace"]
    pieces = [p for p in self_pieces(s["host_spans"])
              if p[2].startswith(layer)]
    if not pieces or s["window_s"] <= 0:
        return None
    gaps = sorted(s["gaps"])
    return 100.0 * _overlap(gaps, pieces) / s["window_s"]


def span_device_ms_per(rec, name: str, over: str) -> Optional[float]:
    """Device ms of the device span ``name`` over counter ``over``."""
    return per(rec, DEVICE_MS + name, over)

