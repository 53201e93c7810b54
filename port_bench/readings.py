"""Readings of the correctness check over many seeds, for setting its
limits: ``python3 port_bench/readings.py --workload <cell> --seeds 1,2,3
--control-seeds 1,2 --seconds 5``.

For each seed, in one process: the cell's set-up, a short window at the
cell's own load, then the numbers the benchmark compares for the
program's outputs and, on the control seeds, for the control (the
reference one precision below the configuration's, in the program's
place). One JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from port_bench import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--fault", choices=("half_batch",),
                   help="plant a fault in the program: the training step "
                   "on the first half of each batch's rows")
    args = p.parse_args(argv)
    cell = harness.Cell(args.workload)
    harness.set_threads(cell.config)

    import torch

    harness.set_precision(cell.config)
    dev = torch.device("cuda", 0)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    if args.fault == "half_batch":
        from marconet_tpu_torch.train.train_step import (
            MARCONetTrainer,
            TrainBatch,
        )
        step = MARCONetTrainer.train_step
        MARCONetTrainer.train_step = lambda self, batch, marks=None: step(
            self, TrainBatch(*(t[:t.shape[0] // 2] for t in batch)), marks)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        driver = cell.driver(seed, False, device=dev)
        driver.setup()
        driver.run(args.seconds)
        torch.cuda.synchronize()
        driver.free()
        out = {"seed": seed, "attempted": driver.attempted,
               "failed": driver.failed,
               "program": {n: v for n, v, _ in driver.check()}}
        if getattr(driver, "detail", None):
            out["program_lines"] = driver.detail
        if seed in controls:
            out["control"] = {n: v for n, v, _ in
                              driver.check(rounding=cell.config["control"])}
            if getattr(driver, "detail", None):
                out["control_lines"] = driver.detail
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        del driver
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
