"""Monocular TUM driver, the Examples/Monocular/mono_tum.cc analog
(port of ``examples/mono_tum.py``).

Usage:
  python -m orb_line_slam_tpu_torch.examples.mono_tum SETTINGS_YAML SEQUENCE_DIR \\
      [--out KeyFrameTrajectory.txt] [--max-frames N] [--vocab ORBvoc.txt] [--device cuda]
"""

import argparse

from ._common import add_common_args, n_frames, run_sequence


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("settings")
    ap.add_argument("sequence")
    add_common_args(ap, "KeyFrameTrajectory.txt")
    args = ap.parse_args(argv)

    from ..config import load_settings
    from ..data.tum import TumMonoSequence
    from ..pipeline.system import System

    cfg = load_settings(args.settings)
    seq = TumMonoSequence(args.sequence)
    n = n_frames(seq, args.max_frames)
    print(f"TUM mono sequence: {n} frames")

    slam = System(cfg, vocabulary=args.vocab, device=args.device)

    def step(i):
        img, ts = seq[i]
        slam.track_monocular(img, ts)

    run_sequence(slam, n, step)
    # Mono saves the keyframe trajectory (scale-free), as the reference.
    slam.save_keyframe_trajectory_tum(args.out)
    print(f"keyframe trajectory written to {args.out}")


if __name__ == "__main__":
    main()
