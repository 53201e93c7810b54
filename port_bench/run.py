"""Entry point of the benchmark: ``python3 port_bench/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>`` from the repository's root
(see ``port_bench/harness.py``)."""

import time

START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from port_bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(start=START))
