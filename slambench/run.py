"""Run one cell of the benchmark of orb_line_slam_tpu_torch once.

    python3 slambench/run.py --workload kitti_stereo.seq --seed 7 --seconds 30 --trace 0

From the root of a checkout.  Prints progress and counts on earlier lines,
the numbers ``correct`` was decided by on the last lines of standard
error, and one JSON object as the last line of standard output.  Exits
non-zero, printing no result, without a CUDA card.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# The checkout's root, not this folder, leads the search path.
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from slambench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
