"""One run of one benchmark cell; see benchmark/harness/main.py.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>
"""

import os
import sys
import time

START = time.perf_counter()  # set-up is timed from here, before any heavy import

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=START))
