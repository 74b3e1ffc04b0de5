"""Monocular EuRoC driver, the Examples/Monocular/mono_euroc.cc analog
(port of ``examples/mono_euroc.py``).

Usage:
  python -m orb_line_slam_tpu_torch.examples.mono_euroc SETTINGS_YAML MAV0_DIR \\
      [--out KeyFrameTrajectory.txt] [--max-frames N] [--vocab ORBvoc.txt] [--device cuda]

When the settings carry LEFT.* rectification blocks (the reference's
EuRoC.yaml), cam0 frames are rectified with the left map before
tracking, as mono_euroc.cc does.
"""

import argparse

from ._common import add_common_args, n_frames, run_sequence


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("settings")
    ap.add_argument("mav0")
    add_common_args(ap, "KeyFrameTrajectory.txt")
    args = ap.parse_args(argv)

    from ..config import load_settings
    from ..data.euroc import EurocStereoSequence
    from ..pipeline.system import System

    cfg = load_settings(args.settings)
    seq = EurocStereoSequence(args.mav0, rectify=cfg.rectify)
    n = n_frames(seq, args.max_frames)
    print(f"EuRoC mono sequence: {n} frames (cam0)")

    slam = System(cfg, vocabulary=args.vocab, device=args.device)

    def step(i):
        img, _, ts = seq[i]
        slam.track_monocular(img, ts)

    run_sequence(slam, n, step)
    slam.save_keyframe_trajectory_tum(args.out)
    print(f"keyframe trajectory written to {args.out}")


if __name__ == "__main__":
    main()
