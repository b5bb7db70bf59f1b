"""The benchmark's one command, from the root of a checkout:

  python3 zkbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or `python3 -m zkbench.run ...`).  See harness.py for what a run does and
README.md for the files it reads.
"""

import time

T_START = time.time()  # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402

if __name__ == "__main__":
    # the checkout's root in place of this script's folder, whose module
    # names (trace, stats) would hide the standard library's
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    from zkbench.harness import main

    sys.exit(main(t_start=T_START))
