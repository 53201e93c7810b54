"""The port's spans and counts (``marconet_tpu_torch/utils/tracing.py``,
``serve.py``, ``models/pipeline.py``) on the CPU at ``width=0.0625``, and
the per-layer readers that turn them into metrics
(``port_bench/span_readers.py``, ``port_bench/metrics/``).

Under ``torch.profiler`` a page of five lines at ``buckets=(4,)`` (two
chunks) gives every span with its nesting; the counts equal hand counts;
with the profiler off no span and no CUDA event is recorded; the
benchmark's ``harness.program_counters`` finds the counts and the device
ms under the keys the metric files read; each reader gives the right
number on a synthetic record, and nothing on a record without the
program's spans and counts.
"""

import numpy as np
import pytest
import torch

from marconet_tpu_torch import serve
from marconet_tpu_torch.models.pipeline import MARCONet
from marconet_tpu_torch.utils import tracing
from port_bench import harness, span_readers
from port_bench import trace as bench_trace

WIDTH = 0.0625
TEXTS = ["ABC", "ABCDE", "ABCDEFGHI", "AB", "ABCD"]
SERVE = ["serve/page", "serve/lines", "serve/prep", "serve/launch",
         "serve/wait", "serve/drain"]
PIPELINE = ["pipeline/restore", "pipeline/encoder", "pipeline/prior",
            "pipeline/srnet"]


def _page(seed: int = 0):
    """Five one-segment lines of ``TEXTS`` stacked down a noise page."""
    rng = np.random.default_rng(seed)
    page = rng.integers(0, 255, (32 * len(TEXTS), 32 * 9, 3)).astype(
        np.uint8)
    boxes = [(0, 32 * i, 32 * len(t), 32 * i + 32)
             for i, t in enumerate(TEXTS)]
    return page, boxes, TEXTS


@pytest.fixture(scope="module")
def net():
    torch.set_num_threads(1)
    return MARCONet(width=WIDTH, device="cpu", seed=0)


@pytest.fixture(scope="module")
def traced(net):
    """One page restored under ``torch.profiler``: (restorer, the profile's
    host spans, the results)."""
    restorer = serve.TextPageRestorer(net, buckets=(4,))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        page, boxes, texts = _page()
        out = restorer.restore_page(page, boxes, texts=texts)
    spans = [s for s in bench_trace.summarize(prof)["host_spans"]
             if s[2] in SERVE + PIPELINE]
    return restorer, spans, out


def _parent(spans, child):
    """The innermost span that holds ``child`` (None at the top)."""
    around = [s for s in spans if s is not child and s[0] <= child[0]
              and child[1] <= s[1]]
    return min(around, key=lambda s: s[1] - s[0])[2] if around else None


def test_spans_and_their_nesting(traced):
    _, spans, out = traced
    assert [r.text for r in out] == TEXTS
    names = [s[2] for s in spans]
    counts = {n: names.count(n) for n in SERVE + PIPELINE}
    assert counts == {"serve/page": 1, "serve/lines": 1, "serve/prep": 2,
                      "serve/launch": 2, "serve/wait": 2, "serve/drain": 2,
                      "pipeline/restore": 2, "pipeline/encoder": 2,
                      "pipeline/prior": 2, "pipeline/srnet": 2}
    parents = {s[2]: set() for s in spans}
    for s in spans:
        parents[s[2]].add(_parent(spans, s))
    assert parents == {
        "serve/page": {None}, "serve/lines": {"serve/page"},
        **{n: {"serve/lines"} for n in SERVE[2:]},
        "pipeline/restore": {"serve/launch"},
        **{n: {"pipeline/restore"} for n in PIPELINE[1:]}}
    # the chunk loop: chunk 2 is prepared and launched before chunk 1 drains
    lines = [s[2] for s in sorted(spans)
             if _parent(spans, s) == "serve/lines"]
    assert lines == ["serve/prep", "serve/launch", "serve/prep",
                     "serve/launch", "serve/wait", "serve/drain",
                     "serve/wait", "serve/drain"]
    encoder, prior, srnet = (sorted(s for s in spans if s[2] == n)
                             for n in PIPELINE[1:])
    assert all(e[1] <= p[0] and p[1] <= r[0]
               for e, p, r in zip(encoder, prior, srnet))


def test_counts_equal_hand_counts(traced, net):
    restorer, _, _ = traced
    # chunk 1: 4 lines up to 9 characters, slot bucket 16; chunk 2: one
    # line of 4 characters, slot bucket 4, restored at its 1 row (no
    # chunk is padded to its bucket)
    want = {"calls": 1, "chunks": 2, "rows": 5, "rows_real": 5,
            "slots": 4 * 16 + 1 * 4, "slots_real": sum(map(len, TEXTS))}
    assert {k: getattr(restorer, k) for k in want} == want
    before = (net.restores, net.rows, net.slots)
    restorer.restore_lines([serve.LineRequest(
        image=np.zeros((32, 96, 3), np.uint8), text="ABC")])
    assert restorer.calls == 2 and restorer.chunks == 3
    assert (restorer.rows, restorer.rows_real) == (6, 6)
    assert (restorer.slots, restorer.slots_real) == (72, 26)
    assert (net.restores, net.rows, net.slots) == (
        before[0] + 1, before[1] + 1, before[2] + 4)
    restorer.restore_lines([])
    assert restorer.calls == 3 and restorer.chunks == 3


def test_profiler_off_records_nothing(net, monkeypatch):
    """Without a profiler no ``record_function`` range opens and no CUDA
    event is made, even for a span that asks for device time."""
    def refuse(*args, **kwargs):
        raise AssertionError("recorded while the profiler is off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(tracing, "_pending", [])
    monkeypatch.setattr(tracing.settle, "device_ms", {})
    assert not tracing.profiling()
    with tracing.span("pipeline/restore", device=True):
        pass
    page, boxes, texts = _page(1)
    out = serve.TextPageRestorer(net, buckets=(4,)).restore_page(
        page, boxes, texts=texts)
    assert len(out) == len(TEXTS)
    assert tracing._pending == [] and tracing.settle.device_ms == {}


class _Event:
    """A CUDA event's stand-in on the CPU: a recorded time in ms."""

    clock = 0.0
    reached = True

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        _Event.clock += 1.5
        self.t = _Event.clock

    def query(self):
        return _Event.reached

    def elapsed_time(self, end):
        return end.t - self.t


def test_device_spans_settle_into_counters(net, monkeypatch):
    """A device span records an event pair while profiling; ``settle``
    adds finished pairs by name and keeps unfinished ones; the benchmark's
    ``program_counters`` finds the totals and the counts under the keys
    that the metric files read."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(tracing, "_pending", [])
    monkeypatch.setattr(tracing.settle, "device_ms", {})
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.span("pipeline/restore", device=True):
            with tracing.span("pipeline/encoder", device=True):
                pass
        monkeypatch.setattr(_Event, "reached", False)
        with tracing.span("pipeline/prior", device=True):
            pass
    assert len(tracing._pending) == 3
    assert tracing.settle() == {}
    monkeypatch.setattr(_Event, "reached", True)
    # each record() advances the clock by 1.5 ms
    assert tracing.settle() == {"pipeline/restore": 4.5,
                                "pipeline/encoder": 1.5,
                                "pipeline/prior": 1.5}
    assert tracing._pending == []

    restorer = serve.TextPageRestorer(net, buckets=(4,))
    counts = harness.program_counters([restorer, net])
    for name in ("restore", "encoder", "prior"):
        key = span_readers.DEVICE_MS + f"pipeline/{name}"
        assert counts[key] == tracing.settle.device_ms[f"pipeline/{name}"]
    for key in ("calls", "chunks", "rows", "rows_real", "slots",
                "slots_real"):
        assert counts[f"TextPageRestorer.{key}"] == 0
    for key in ("restores", "rows", "slots"):
        assert counts[f"MARCONet.{key}"] == getattr(net, key)


def _call(t0):
    """The host spans of one page call starting at ``t0`` s: the page
    server's, the benchmark's proxy around the restore, and the
    pipeline's."""
    spans = [(0.0, 10.0, "serve/page"), (0.5, 9.5, "serve/lines"),
             (0.5, 2.5, "serve/prep"), (2.5, 6.0, "serve/launch"),
             (2.8, 5.8, "bench/restore"), (3.0, 5.5, "pipeline/restore"),
             (3.0, 3.5, "pipeline/encoder"), (3.5, 4.0, "pipeline/prior"),
             (4.0, 5.0, "pipeline/srnet"), (6.0, 8.0, "serve/wait"),
             (8.0, 9.5, "serve/drain")]
    gaps = [(0.2, 3.2), (5.2, 6.5), (9.8, 10.0)]
    return ([(lo + t0, hi + t0, n) for lo, hi, n in spans],
            [(lo + t0, hi + t0, "page") for lo, hi in gaps])


def _record():
    """Two calls' spans and idle gaps in a 21 s window (the last second
    idle outside every span), and the window's counts."""
    (s1, g1), (s2, g2) = _call(0.0), _call(10.0)
    dev = span_readers.DEVICE_MS
    return {
        "trace": {"host_spans": sorted(s1 + s2),
                  "gaps": g1 + g2 + [(20.0, 21.0, "harness")],
                  "window_s": 21.0},
        "counters": {
            "TextPageRestorer.calls": 2, "TextPageRestorer.chunks": 2,
            "TextPageRestorer.rows": 128, "TextPageRestorer.rows_real": 34,
            "TextPageRestorer.slots": 2048,
            "TextPageRestorer.slots_real": 340,
            "MARCONet.restores": 2, "MARCONet.rows": 128,
            "MARCONet.slots": 2048,
            dev + "pipeline/restore": 1600.0, dev + "pipeline/encoder": 64.0,
            dev + "pipeline/prior": 409.6, dev + "pipeline/srnet": 1152.0}}


def test_self_time_leaves_out_child_spans():
    rec = _record()
    got = {}
    for lo, hi, name in span_readers.self_pieces(rec["trace"]["host_spans"]):
        got[name] = got.get(name, 0.0) + hi - lo
    # per call: the page's split and stitch 0.5 + 0.5, nothing of the
    # lines' own, the proxy's 0.2 + 0.3 around the pipeline's 2.5
    want = {"serve/page": 1.0, "serve/prep": 2.0, "serve/launch": 0.5,
            "bench/restore": 0.5, "pipeline/restore": 0.5,
            "pipeline/encoder": 0.5, "pipeline/prior": 0.5,
            "pipeline/srnet": 1.0, "serve/wait": 2.0, "serve/drain": 1.5}
    assert got == pytest.approx({k: 2 * v for k, v in want.items()})
    assert span_readers.self_s(rec, "serve/lines") is None
    pieces = span_readers.self_pieces(rec["trace"]["host_spans"])
    assert all(a[1] <= b[0] for a, b in zip(pieces, pieces[1:]))


def test_idle_in_spans_cuts_gaps_at_span_edges():
    """Gap 0.2-3.2 s straddles the page's self time, prep, launch, the
    proxy and the encoder; gap 5.2-6.5 the pipeline's self time, the
    proxy, launch and wait; gap 9.8-10 the page's stitch."""
    rec = _record()
    serve_s = 2 * ((0.3 + 2.0 + 0.3) + (0.2 + 0.5) + 0.2)
    pipeline_s = 2 * (0.2 + 0.3)
    assert span_readers.idle_in_pct(rec, "serve/") == pytest.approx(
        100 * serve_s / 21.0)
    assert span_readers.idle_in_pct(rec, "pipeline/") == pytest.approx(
        100 * pipeline_s / 21.0)
    assert span_readers.idle_in_pct(rec, "bench/") == pytest.approx(
        100 * 2 * (0.2 + 0.3) / 21.0)
    assert span_readers.idle_in_pct(rec, "train/") is None


# every new metric, the cell it is read in, and its value on _record()
METRICS = {
    "serve.real_rows_pct.folder": 100 * 34 / 128,
    "prior.real_slots_pct.folder": 100 * 340 / 2048,
    "serve.prep_ms_per_call.folder": 2000.0,
    "device.idle_in_serve_pct.folder": 100 * 7.0 / 21.0,
    "pipeline.span_device_ms_per_row.folder": 12.5,
    "encoder.span_device_ms_per_row.folder": 0.5,
    "prior.span_device_ms_per_slot.folder": 0.2,
    "srnet.span_device_ms_per_row.folder": 9.0,
    "serve.prep_ms_per_call.line": 2000.0,
    "device.idle_in_serve_pct.line": 100 * 7.0 / 21.0,
    "device.idle_in_pipeline_pct.line": 100 * 1.0 / 21.0,
    "pipeline.span_device_ms_per_row.line": 12.5,
    "pipeline.host_ms_per_call.line": 2500.0,
}


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_reader(metric):
    cell = "folder-17l" if metric.endswith(".folder") else "line-4to16c"
    entry = [m for m in harness.Cell(cell).per_layer
             if m["name"] == metric]
    assert len(entry) == 1 and entry[0]["workloads"] == [cell]
    read = harness.Cell(cell).reader(metric)
    rec = _record()
    assert read(rec) == pytest.approx(METRICS[metric])
    # a program without the spans and counts gives nothing to read, nor
    # does a count of 0 (the idle shares read no count)
    assert read({"trace": {"host_spans": [], "gaps": rec["trace"]["gaps"],
                           "window_s": 21.0}, "counters": {}}) is None
    zero = dict(rec, counters={k: 0 for k in rec["counters"]})
    if ".idle_in_" not in metric:
        assert read(zero) is None
