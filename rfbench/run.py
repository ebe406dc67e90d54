"""Run one benchmark cell once and print its result as the last line:

    python3 rfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. See rfbench/README.md.
"""

import time

T0 = time.perf_counter()  # the process's start, for setup_s

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from rfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
