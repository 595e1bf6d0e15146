"""Run one cell of the benchmark: ``python3 benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout."""

import os
import sys
import time

T_START = time.monotonic()
# the checkout's root replaces this script's folder on the path, so that the
# benchmark's modules are imported as ``benchmark.*`` and shadow nothing
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
