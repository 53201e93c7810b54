"""The harness's own rules: seeded generators, the cells' shapes, the
contract's names and keys, and cells found by name from new files."""

import hashlib
import json
import os
import re
import shutil

import numpy as np
import pytest

from port_bench import harness
from port_bench.reference import page as ref_page
from port_bench.traffic import pages, train_steps

BENCH = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _params(cell):
    return harness.Cell(cell).workload["params"]


@pytest.mark.parametrize("cell", ["folder-17l", "line-4to16c"])
def test_page_pools_are_seeded(cell):
    a, b = pages.make_pool(_params(cell), 2**31 + 5), \
        pages.make_pool(_params(cell), 2**31 + 5)
    c = pages.make_pool(_params(cell), 2**31 + 6)
    for x, y in zip(a, b):
        assert np.array_equal(x[0], y[0]) and x[1:] == y[1:]
    assert any(not np.array_equal(x[0], z[0]) for x, z in zip(a, c))
    # every seed offers the same sizes, in another order
    sizes = lambda pool: sorted(tuple((b[2] - b[0], b[3] - b[1])  # noqa
                                      for b in p[1]) for p in pool)
    assert sizes(a) == sizes(c)


def test_train_pools_are_seeded():
    p = _params("train-step-f32-b2-s16")
    a, b = train_steps.make_pool(p, 7), train_steps.make_pool(p, 7)
    c = train_steps.make_pool(p, 8)
    assert all(np.array_equal(u, v) for x, y in zip(a, b)
               for u, v in zip(x, y))
    assert not np.array_equal(a[0][0], c[0][0])
    valid = lambda pool: [(x[2] != 6735).sum(1).tolist() for x in pool]  # noqa
    assert valid(a) == valid(c)


@pytest.mark.parametrize("cell", ["folder-17l", "line-4to16c"])
def test_lines_are_the_sources_sizes(cell):
    """Every line has 4-16 characters (train.yml) at the LQ height 32, so it
    stays one segment (test_sr.py's 512 px); a call holds 17 lines in the
    folder cell (Testsets/LQs) and one in the line cell."""
    lines = 17 if cell == "folder-17l" else 1
    seen = set()
    for page in pages.make_pool(_params(cell), 11):
        segs = ref_page.segment_geometry(*page)
        assert len(page[1]) == lines and len(segs) == lines
        assert all(4 <= len(t) <= 16 for t in page[2])
        assert all(b[3] - b[1] == 32 for b in page[1])
        seen |= {len(t) for t in page[2]}
    assert seen == set(range(4, 17))


def test_names_and_units():
    named = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
             + BENCH["per_layer"])
    for entry in named:
        assert NAME.match(entry["name"]), entry["name"]
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names))
    # each entry has just the contract's keys
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    for kind, want in keys.items():
        for e in BENCH[kind]:
            assert set(e) - {"workloads"} == want, e["name"]
            assert kind in ("end_to_end", "per_layer") \
                or "workloads" not in e


def test_every_cell_reports_its_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        cell = harness.Cell(w["name"])
        names = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names
            assert os.path.exists(os.path.join(
                harness.BENCH_DIR, "metrics", m["name"] + ".py"))
        assert os.path.exists(os.path.join(harness.ROOT,
                                           cell.config_entry["file"]))
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())


def test_result_line_has_the_contract_keys():
    line = harness.result_line(True, 3, 0, {"setup_s": {"value": 1.5,
                                                        "unit": "s"}},
                               {"platform": "gpu", "kind": "x", "count": 1,
                                "memory_peak_bytes": 7},
                               checks=[("bad_lines", 0, 0)])
    out = json.loads(line)
    assert list(out) == [*harness.KEYS, "checks"]
    traced = json.loads(harness.result_line(
        True, 3, 0, {}, {}, breakdown={"device_ops": [], "idle_gaps": []}))
    assert set(traced) == {*harness.KEYS, "breakdown"}


def _digest(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_new_cell_config_and_metric_need_only_new_files(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH_DIR, root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    before = _digest(root / "port_bench")
    # a configuration, a traffic mix and a per-layer metric, as new files
    cfg = harness.load_json(os.path.join(
        harness.BENCH_DIR, "configs", "marconet-x4-serve-bf16.json"))
    cfg["buckets"] = [1, 8, 32]
    (root / "port_bench/configs/new-config.json").write_text(json.dumps(cfg))
    (root / "port_bench/workloads/page-new.json").write_text(json.dumps({
        "driver": "pages", "params": {"pages": 2, "lines": [3, 3],
                                      "chars": [4, 4], "height": [32, 32],
                                      "size_seed": 1, "check_pages": 1}}))
    (root / "port_bench/metrics/rows.new.py").write_text(
        "def read(rec):\n    return len(rec['segment_centers'])\n")
    bench["configs"].append({"name": "new-config", "source": "x",
                             "file": "port_bench/configs/new-config.json",
                             "reduced": []})
    bench["workloads"].append({"name": "page-new", "config": "new-config",
                               "traffic": "page-new", "chips": 1,
                               "why": "a new cell"})
    bench["per_layer"].append({"name": "rows.new", "unit": "rows",
                               "better": "higher", "source": "program_counter",
                               "layer": "page server (serve.py)",
                               "moves": "lines_per_s",
                               "workloads": ["page-new"]})
    for m in bench["end_to_end"]:
        if m["name"] in ("setup_s", "lines_per_s"):
            m.setdefault("workloads", []).append("page-new")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digest(root / "port_bench")
    assert all(after[k] == v for k, v in before.items())

    cell = harness.Cell("page-new", root=str(root))
    assert cell.config["buckets"] == [1, 8, 32]
    drv = cell.driver(3, False, device="cpu")
    assert len(drv.pool) == 2 and drv.seg_chars == [[4, 4, 4]] * 2
    assert [m["name"] for m in cell.per_layer] == ["rows.new"]
    assert cell.reader("rows.new")({"segment_centers": [1, 2]}) == 2
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "lines_per_s"}


def test_new_metric_reads_the_programs_spans_and_counts(tmp_path,
                                                        monkeypatch):
    """A per-layer metric added as a new file reads a span and a count that
    the program keeps, as a tracing change to the program would add them,
    with no existing file of the benchmark edited."""
    import torch
    from marconet_tpu_torch.serve import TextPageRestorer

    from port_bench import trace
    from port_bench.tests.test_bench_reference import SEED, small_config

    orig = TextPageRestorer.restore_lines

    def restore_lines(self, requests):
        with torch.profiler.record_function("serve/restore_lines"):
            self.lines_in = getattr(self, "lines_in", 0) + len(requests)
            return orig(self, requests)

    monkeypatch.setattr(TextPageRestorer, "restore_lines", restore_lines)
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH_DIR, root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(root / "port_bench")
    (root / "port_bench/metrics/serve.lines_ms.new.py").write_text(
        "def read(rec):\n"
        "    t = [hi - lo for lo, hi, name in rec['trace']['host_spans']\n"
        "         if name == 'serve/restore_lines']\n"
        "    return 1e3 * sum(t) / len(t) if t else None\n")
    (root / "port_bench/metrics/serve.lines_in.new.py").write_text(
        "def read(rec):\n"
        "    return rec['counters'].get('TextPageRestorer.lines_in')\n")
    bench = json.loads(json.dumps(BENCH))
    for name, unit in (("serve.lines_ms.new", "ms"),
                       ("serve.lines_in.new", "lines")):
        bench["per_layer"].append({
            "name": name, "unit": unit, "better": "lower",
            "source": "program_span", "layer": "page server (serve.py)",
            "moves": "page_p95_ms", "workloads": ["line-4to16c"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digest(root / "port_bench")
    assert all(after[k] == v for k, v in before.items())

    cell = harness.Cell("line-4to16c", root=str(root))
    drv = cell.driver(SEED, False, device="cpu", config=small_config(cell),
                      params=dict(cell.workload["params"], pages=2))
    drv.setup()
    counts = harness.program_counters(drv.program())
    assert counts[
        "marconet_tpu_torch.ops.fused_act.fused_leaky_relu.launches"] >= 0
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        drv.run(0.0)
    rec = {"trace": trace.summarize(prof),
           "counters": harness.counter_deltas(
               counts, harness.program_counters(drv.program()))}
    names = [m["name"] for m in cell.per_layer]
    assert names[-2:] == ["serve.lines_ms.new", "serve.lines_in.new"]
    assert cell.reader("serve.lines_ms.new")(rec) > 0
    # run(0.0) restores one page of one line
    assert cell.reader("serve.lines_in.new")(rec) == 1
    # idle gaps are labelled by the benchmark's own spans alone
    assert [s[2] for s in rec["trace"]["spans"]] == ["page"]
