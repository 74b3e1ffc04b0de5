"""Shared driver plumbing for the example mains: the per-frame timing
loop and the median/mean report every Examples/*.cc main() prints.

Port of ``examples/_common.py`` without its JAX compilation-cache and
``JAX_PLATFORMS`` set-up (there is nothing to compile ahead of time);
``add_common_args`` holds the arguments every driver takes, with
``--device`` (the CUDA card unless ``--device cpu``).
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def add_common_args(ap: argparse.ArgumentParser, out: str) -> None:
    ap.add_argument("--out", default=out)
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--vocab", default=None)
    ap.add_argument("--device", default="cuda")


def n_frames(seq, max_frames: int) -> int:
    return len(seq) if not max_frames else min(len(seq), max_frames)


def run_sequence(slam, n, step, label="frame"):
    """Drive `step(i)` over n frames, print the timing report."""
    times = []
    for i in range(n):
        t0 = time.perf_counter()
        step(i)
        times.append(time.perf_counter() - t0)
        if i % 50 == 0:
            st = slam.tracker.stats[-1] if slam.tracker.stats else {}
            print(
                f"{label} {i}: state={slam.tracking_state()} "
                f"inliers={st.get('inliers', '-')} "
                f"kf={slam.map.n_keyframes()} {1e3 * times[-1]:.0f} ms"
            )
    slam.shutdown()
    t = np.array(times[2:]) if len(times) > 4 else np.array(times)
    if len(t):
        print(
            f"tracking time: median {1e3 * np.median(t):.1f} ms, "
            f"mean {1e3 * t.mean():.1f} ms"
        )
    print(f"loops closed: {slam.n_loops_closed}")
