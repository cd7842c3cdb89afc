"""Run one cell of the port's benchmark once:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA cards. The
last line of standard output is the result (JSON); the compared numbers and
their limits are the last lines of standard error. See ``harness.py``.
"""

import time

STARTED = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# The checkout's root in place of this script's directory, whose module
# names (``spans``, ``frames``) would shadow others.
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(started=STARTED))
