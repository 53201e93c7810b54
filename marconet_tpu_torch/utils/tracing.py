"""Named spans of the port's work, for ``torch.profiler`` traces.

``with span("serve/prep"):`` marks a stretch of host work as a
``record_function`` range while a profiler is recording, so the trace
shows it beside the device's kernels, on the same clock; spans nest, and
a span's parent is the span open around it. With the profiler off a span
costs one check and records nothing.

``span(name, device=True)`` (for work on a CUDA device) also records a
CUDA event pair around the stretch while profiling; :func:`settle` adds
the milliseconds of every finished pair to ``settle.device_ms[name]``
without waiting for the device.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch

_OFF = contextlib.nullcontext()
# event pairs recorded and not yet settled: (span name, start, end)
_pending: List[Tuple[str, torch.cuda.Event, torch.cuda.Event]] = []


def profiling() -> bool:
    """Whether a ``torch.profiler`` is recording on this thread."""
    return torch.autograd._profiler_enabled()


class _Span:
    def __init__(self, name: str, device: bool):
        self.name, self.device = name, device
        self.range = torch.profiler.record_function(name)

    def __enter__(self):
        self.range.__enter__()
        if self.device:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        return self

    def __exit__(self, *exc):
        if self.device:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            _pending.append((self.name, self.start, end))
        return self.range.__exit__(*exc)


def span(name: str, device: bool = False):
    """A context manager marking ``name`` in a profiler's trace (and, with
    ``device``, timing it on the current CUDA stream); a no-op while no
    profiler records."""
    if not profiling():
        return _OFF
    return _Span(name, device)


def settle() -> Dict[str, float]:
    """Add the device ms of every finished event pair to
    ``settle.device_ms`` (by span name) and return it; pairs the device
    has not reached yet stay for a later call."""
    if not _pending:
        return settle.device_ms
    waiting = []
    for name, start, end in _pending:
        if end.query():
            settle.device_ms[name] = (settle.device_ms.get(name, 0.0)
                                      + start.elapsed_time(end))
        else:
            waiting.append((name, start, end))
    _pending[:] = waiting
    return settle.device_ms


settle.device_ms = {}
