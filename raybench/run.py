"""Run one cell of BENCHMARK.json and print its result line.

    python3 raybench/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

(also `python3 -m raybench.run ...`), from the root of a checkout.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# run as a script, the interpreter puts raybench/ first on the path;
# the checkout's root goes there instead
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from raybench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t0=T0))
