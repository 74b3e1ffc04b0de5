"""Stereo KITTI driver, the Examples/Stereo/stereo_kitti.cc analog
(port of ``examples/stereo_kitti.py``).

Usage:
  python -m orb_line_slam_tpu_torch.examples.stereo_kitti SETTINGS_YAML SEQUENCE_DIR \\
      [--out CameraTrajectory.txt] [--max-frames N] [--vocab ORBvoc.txt] [--no-loop] [--device cuda]

Loads the image list, tracks every stereo pair, reports per-frame timing
(median/mean as the reference's main() does) and writes the trajectory
in KITTI format.
"""

import argparse

from ._common import add_common_args, n_frames, run_sequence


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("settings")
    ap.add_argument("sequence")
    add_common_args(ap, "CameraTrajectory.txt")
    ap.add_argument("--no-loop", action="store_true")
    args = ap.parse_args(argv)

    from ..data.kitti import KittiStereoSequence
    from ..pipeline.system import System

    seq = KittiStereoSequence(args.sequence)
    n = n_frames(seq, args.max_frames)
    print(f"KITTI sequence: {n} stereo pairs")

    slam = System(args.settings, vocabulary=args.vocab,
                  use_loop_closing=not args.no_loop, device=args.device)

    def step(i):
        img_l, img_r, ts = seq[i]
        slam.track_stereo(img_l, img_r, ts)

    run_sequence(slam, n, step)
    slam.save_trajectory_kitti(args.out)
    print(f"trajectory written to {args.out}")


if __name__ == "__main__":
    main()
