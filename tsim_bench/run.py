#!/usr/bin/env python3
"""Entry of the port's benchmark: one run of one cell.

    python3 tsim_bench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

from the repository's root.  Prints the result's JSON object as the last
line of standard output, the compared numbers beside their limits as the
last lines of standard error; exits 3 without a result where the cell's
CUDA devices are missing.  See `harness.py`."""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, for the program and the `tsim_bench` package; not
# this folder, whose module names would shadow others
sys.path[0] = ROOT

from tsim_bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
