"""The benchmark's harness: one process, one cell.

``python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` loads ``BENCHMARK.json``, finds the cell's files by name
(``port_bench/workloads/<cell>.json`` names its configuration's
``port_bench/configs/<config>.json`` through ``BENCHMARK.json``, and its
traffic driver ``port_bench/traffic/<driver>.py`` with that driver's
parameters), builds the program, warms it, measures for the window's
seconds, checks what the window produced against the plain reference and
prints one JSON line. With ``--trace 1`` the window runs under
``torch.profiler`` and the line carries the cell's per-layer metrics, each
read by its own module ``port_bench/metrics/<metric>.py``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "marconet_tpu")
KEYS = ("correct", "attempted", "failed", "metrics", "device")


def load_json(path: str):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A module of the benchmark loaded from its file (names may hold
    dots and dashes)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """Everything that belongs to one cell, found by name."""

    def __init__(self, name: str, bench: Optional[Dict] = None,
                 root: str = ROOT):
        self.root = root
        bench = bench or load_json(os.path.join(root, "BENCHMARK.json"))
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = by_name[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = load_json(os.path.join(root,
                                             self.config_entry["file"]))
        traffic = self.entry["traffic"]
        self.workload = load_json(os.path.join(
            root, "port_bench", "workloads", f"{traffic}.json"))
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]

    def driver(self, seed: int, trace: bool, device="cuda", config=None,
               params=None):
        """The cell's traffic driver (``config`` and ``params`` replace the
        cell's own, for tests at small sizes)."""
        mod = load_module(os.path.join(
            self.root, "port_bench", "traffic",
            f"{self.workload['driver']}.py"),
            f"port_bench_traffic_{self.workload['driver']}")
        return mod.Driver(config or self.config,
                          params or self.workload["params"], seed, trace,
                          device=device)

    def reader(self, metric: str):
        return load_module(os.path.join(self.root, "port_bench", "metrics",
                                        f"{metric}.py"),
                           f"port_bench_metric_{metric}").read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is a forbidden one."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


PROGRAM = "marconet_tpu_torch"


def _numbers(prefix: str, attrs: Dict, out: Dict[str, float]) -> None:
    for k, v in attrs.items():
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            out[f"{prefix}.{k}"] = v
        elif isinstance(v, dict) and v and all(
                isinstance(x, (int, float)) and not isinstance(x, bool)
                for x in v.values()):
            for kk, x in v.items():
                out[f"{prefix}.{k}.{kk}"] = x


def program_counters(objects=()) -> Dict[str, float]:
    """Every count the program keeps: numbers (and dicts of numbers) held
    as attributes of the program's functions, as the kernel wrappers keep
    ``fused_leaky_relu.launches`` (key ``<module>.<function>.<name>``), and
    as attributes of the program objects given (``<Class>.<name>``)."""
    out: Dict[str, float] = {}
    for modname, mod in list(sys.modules.items()):
        if modname.split(".")[0] != PROGRAM or mod is None:
            continue
        for fname, fn in list(vars(mod).items()):
            if callable(fn) and getattr(fn, "__module__", None) == modname \
                    and getattr(fn, "__dict__", None):
                _numbers(f"{modname}.{fname}", fn.__dict__, out)
    for obj in objects:
        _numbers(type(obj).__name__, vars(obj), out)
    return out


def counter_deltas(before: Dict[str, float], after: Dict[str, float]
                   ) -> Dict[str, float]:
    return {k: v - before.get(k, 0) for k, v in after.items()}


def set_precision(config: Dict) -> None:
    """The configuration's float32 rule, set through PyTorch's public
    flags before anything is built."""
    import torch
    tf32 = bool(config.get("allow_tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def set_threads(config: Dict) -> None:
    """The configuration's CPU threads (``cpu_threads``; PyTorch's default
    where it states none), set before torch is imported."""
    n = config.get("cpu_threads")
    if n:
        os.environ["OMP_NUM_THREADS"] = str(n)
        import torch
        torch.set_num_threads(int(n))


def result_line(correct: bool, attempted: int, failed: int, metrics: Dict,
                device: Dict, breakdown: Optional[Dict] = None,
                checks: Optional[List] = None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    if checks is not None:
        out["checks"] = {n: {"value": v, "limit": lim}
                         for n, v, lim in checks}
    return json.dumps(out)


def judge(checks: List[tuple]) -> bool:
    return all(v <= lim for _, v, lim in checks)


def measure(cell: Cell, seed: int, seconds: float, trace: bool, device,
            start: float, config: Optional[Dict] = None,
            params: Optional[Dict] = None) -> tuple:
    """Set up, measure and check one run: (result fields, checks)."""
    import torch

    cuda = torch.device(device).type == "cuda"
    driver = cell.driver(seed, trace, device=device, config=config,
                         params=params)
    driver.setup()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - start

    prof = None
    counted = program_counters(driver.program()) if trace else None
    if trace:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    driver.run(seconds)
    if cuda:
        torch.cuda.synchronize()
    if prof is not None:
        prof.__exit__(None, None, None)
        counted = counter_deltas(counted, program_counters(driver.program()))

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": int(cell.entry["chips"]),
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))
           if cuda else 0}
    breakdown = records = None
    if trace:
        from port_bench import trace as tr
        summary = tr.summarize(prof)
        del prof
        records = driver.records()
        records["trace"] = summary
        records["config"] = config or cell.config
        records["counters"] = counted
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        breakdown = tr.breakdown(summary)
    else:
        e2e = driver.end_to_end()
        e2e["setup_s"] = setup_s
        metrics = {m["name"]: {"value": float(e2e[m["name"]]),
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    driver.free()
    checks = driver.check()
    if records is not None:
        # the check may add what it counted (a reference step's operations)
        records.update(driver.check_records)
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"])(records)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    fields = {"correct": judge(checks) and driver.failed == 0,
              "attempted": driver.attempted, "failed": driver.failed,
              "metrics": metrics, "device": dev, "breakdown": breakdown}
    return fields, checks


def main(argv=None, start: Optional[float] = None) -> int:
    start = time.perf_counter() if start is None else start
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = Cell(args.workload)
    set_threads(cell.config)

    import torch

    need = int(cell.entry["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        print(f"needs {need} CUDA device(s), found {have}", file=sys.stderr)
        return 2
    set_precision(cell.config)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    fields, checks = measure(cell, args.seed, args.seconds,
                             bool(args.trace), dev, start)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(result_line(checks=checks, **fields), flush=True)
    return 0
