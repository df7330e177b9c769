"""Run one cell of BENCHMARK.json once, from the root of a checkout:

    python3 mpcbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result as the last line of standard output, and each number the
comparison with the plain reference made, beside its limit, as the last
lines of standard error. Exits non-zero, printing no result, without the
CUDA devices the cell asks for, or where modules of JAX or the JAX package
are loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mpcbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
