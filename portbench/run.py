"""Run one cell of the port's benchmark once, from the root of a checkout:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints the result as one JSON line, last on standard output, and each
number compared beside its limit, last on standard error. Exits 2 without
the CUDA devices the cell asks for, and 1 when JAX or the JAX package was
loaded.
"""

import time

T0 = time.perf_counter()  # set-up is counted from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench.env import configure  # noqa: E402

configure(ROOT)

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
