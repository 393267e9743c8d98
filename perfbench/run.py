"""The benchmark's command: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the run's result as one JSON object on the last line of standard
output, and the numbers its comparison read, each beside its limit, as
the last lines of standard error.  Exits 2 without a result where the
cell's CUDA devices are missing, and 3 where the run loaded JAX or the
JAX package.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from pb import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
