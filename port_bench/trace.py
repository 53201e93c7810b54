"""Reading a ``torch.profiler`` run of the window.

:func:`summarize` reduces the profile to what the per-layer readers and
the ``breakdown`` need: every device activity (kernels and copies) with
its name and interval, the device's busy time (the union of those
intervals), the traced window, every host span (each ``record_function``
range, the program's own as well as the benchmark's, with its name and
interval: a reader finds the program's spans by name) and the idle gaps,
each labelled by the innermost benchmark span (``bench/...``) the host
was in when the gap began.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

# CUPTI's marker for a full command buffer is not device work
_NOT_WORK = ("Command Buffer Full",)
SPAN_PREFIX = "bench/"


def _is_span(e) -> bool:
    """A host ``record_function`` range (a user annotation)."""
    f = getattr(e, "is_user_annotation", None)
    if f is not None:
        return bool(f())
    return "::" not in e.name() and not e.name().startswith("cu")


def summarize(prof) -> Dict:
    """The profile's raw events (``kineto_results``; building the
    profiler's event tree takes minutes over a window of a few hundred
    thousand launches) reduced as the module says; times in seconds
    (``host_spans``) and microseconds (``device``, ``spans``)."""
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    host = [(e.start_ns() * 1e-3, e.end_ns() * 1e-3, e.name())
            for e in events if e.device_type() != cuda and _is_span(e)]
    # a span also shows on the device's timeline, under its own name
    not_work = set(_NOT_WORK) | {name for _, _, name in host}
    device = [(e.start_ns() * 1e-3, e.end_ns() * 1e-3, e.name())
              for e in events if e.device_type() == cuda
              and e.name() not in not_work
              and not e.name().startswith(SPAN_PREFIX)]
    host.sort()
    spans = [(lo, hi, name[len(SPAN_PREFIX):]) for lo, hi, name in host
             if name.startswith(SPAN_PREFIX)]
    host_spans = [(lo * 1e-6, hi * 1e-6, name) for lo, hi, name in host]
    device.sort()
    spans.sort()
    if not device:
        return {"device": [], "spans": spans, "host_spans": host_spans,
                "busy_s": 0.0, "window_s": 0.0, "gaps": [], "by_name": {}}
    busy, end, gaps = 0.0, device[0][0], []
    for lo, hi, _ in device:
        if lo > end:
            gaps.append((end, lo))
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    # the window: from the first benchmark span (or device activity) to
    # the last end
    t0 = min([device[0][0]] + [s[0] for s in spans])
    t1 = max([end] + [s[1] for s in spans])
    if spans:
        first = spans[0][0]
        if first < device[0][0]:
            gaps.insert(0, (first, device[0][0]))
        last = max(s[1] for s in spans)
        if last > end:
            gaps.append((end, last))
    by_name: Dict[str, float] = defaultdict(float)
    for lo, hi, name in device:
        by_name[name] += (hi - lo) * 1e-6
    labelled = [(lo * 1e-6, hi * 1e-6, _label(spans, lo))
                for lo, hi in gaps]
    return {"device": device, "spans": spans, "host_spans": host_spans,
            "busy_s": busy * 1e-6,
            "window_s": (t1 - t0) * 1e-6, "gaps": labelled,
            "by_name": dict(by_name)}


def _label(spans, t: float) -> str:
    """The innermost benchmark span that holds time ``t`` ('harness' when
    none does)."""
    i = bisect.bisect_right(spans, (t, float("inf"), ""))
    # spans nest, so the latest-starting one that holds t is the innermost
    for lo, hi, name in reversed(spans[max(0, i - 8):i]):
        if lo <= t < hi:
            return name
    return "harness"


def kernel_seconds(summary: Dict, *needles: str) -> float:
    """Device seconds of the activities whose name holds every needle."""
    return sum(s for name, s in summary["by_name"].items()
               if all(n in name for n in needles))


def kernel_count(summary: Dict) -> int:
    """Kernel launches in the trace (copies and memsets excluded)."""
    return sum(1 for _, _, name in summary["device"]
               if not name.startswith(("Memcpy", "Memset")))


def breakdown(summary: Dict, top: int = 10) -> Dict:
    """The device operations that took most time, and the idle time by
    what the host was doing, each at most ``top`` entries."""
    ops = sorted(summary["by_name"].items(), key=lambda kv: -kv[1])[:top]
    idle: Dict[str, float] = defaultdict(float)
    for lo, hi, label in summary["gaps"]:
        idle[label] += hi - lo
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
