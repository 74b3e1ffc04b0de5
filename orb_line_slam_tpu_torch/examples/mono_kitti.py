"""Monocular KITTI driver, the Examples/Monocular/mono_kitti.cc analog
(port of ``examples/mono_kitti.py``).

Usage:
  python -m orb_line_slam_tpu_torch.examples.mono_kitti SETTINGS_YAML SEQUENCE_DIR \\
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
    from ..data.kitti import KittiStereoSequence
    from ..pipeline.system import System

    cfg = load_settings(args.settings)
    seq = KittiStereoSequence(args.sequence)  # left camera only is used
    n = n_frames(seq, args.max_frames)
    print(f"KITTI mono sequence: {n} frames")

    slam = System(cfg, vocabulary=args.vocab, device=args.device)

    def step(i):
        img, _, ts = seq[i]
        slam.track_monocular(img, ts)

    run_sequence(slam, n, step)
    slam.save_keyframe_trajectory_tum(args.out)
    print(f"keyframe trajectory written to {args.out}")


if __name__ == "__main__":
    main()
