"""Benchmark entry point: one run of one cell of BENCHMARK.json.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout on a machine with the cards the cell
asks for. The last line of standard output is the run's JSON result;
the numbers the correctness check compared, each beside its limit, are
the last lines of standard error.
"""

import os
import sys
import time

PROCESS_START = time.monotonic()

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from portbench.cellrun import main
    sys.exit(main(sys.argv[1:], PROCESS_START))
