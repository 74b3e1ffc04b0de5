"""Readings the limits of ``correct`` are set from, in one process on the card.

    python3 slambench/calibrate.py --workload kitti_stereo.seq --seeds 11,12,13 \\
        --control-seeds 11,12,13

For each seed: the cell's sequence rendered with that seed's sensor noise,
one closed-loop pass through the cell's driver as a run's window starts
(after one warm-up pass on the first seed), and the checks' numbers of the
program against the reference on the samples a run compares (the lower
readings).  For each
control seed besides: the same numbers of the control, the reference
computed in the nearest lower precision in the program's place (the upper
readings), and the ATE of a pass of the program itself with TF32 switched
on.  One JSON line a seed (``harness.pass_numbers``).
"""

import argparse
import json
import os
import sys

# The checkout's root, not this folder, leads the search path.
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from slambench import harness  # noqa: E402


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control-seeds", default="", help="comma-separated")
    args = ap.parse_args(argv)
    harness.set_environment()
    cell = harness.load_cell(args.workload)
    config, traffic = cell["config"], cell["traffic"]
    n = int(cell["n_frames"])
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    # Rendered first: the renderer forks, before torch has started threads.
    rendered = {s: harness.render_sequence(config, traffic, n, s) for s in sorted(set(seeds) | controls)}

    prog = harness.load_program("cuda")
    cfg = harness.slam_config(prog.config, config)
    print(f"card: {harness.card_line()}", flush=True)
    driver = harness.load_driver(traffic)
    with driver.Probes() as warm:
        warm.sample_pass = -1
        driver.replay(prog, cfg, cell, rendered[seeds[0]][1], warm, 0.0, "cuda", whole_passes=True)
    for seed in sorted(set(seeds) | controls):
        row = harness.pass_numbers(prog, cfg, cell, seed, rendered[seed], "cuda", control=seed in controls)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
