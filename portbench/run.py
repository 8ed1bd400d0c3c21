"""Benchmark entry point: one run of one cell of BENCHMARK.json.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout on a machine with the cards the cell
asks for. The last line of standard output is the run's JSON result;
the numbers the correctness check compared, each beside its limit, are
the last lines of standard error.

Exit codes: 0, a result line printed; 2, the program is not in the
checkout; 3, fewer CUDA devices than the cell asks for; 4, JAX or the
JAX package was loaded; 5, the run cannot be measured (guard.py): the
program put no work on the card in the warm-up query or in the window,
the traced window reads no device time or a busy time outside it, or
no query completed in the window. Where it is not 0, standard output
holds no result and the last line of standard error names the cause.
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
