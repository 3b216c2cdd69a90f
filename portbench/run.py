"""Entry point of the port's benchmark: one run of one cell.

    python3 portbench/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout. Prints the run's result as the last line of
standard output (harness.py says what a run does) and exits 0, or exits
with another code and prints no result: without as many CUDA devices as
the cell asks for, when the run loaded JAX or the JAX package, or when
the program or its inputs fail.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# run as a script, the folder itself would come first on sys.path and
# its module names would shadow top-level ones: put the checkout there
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
