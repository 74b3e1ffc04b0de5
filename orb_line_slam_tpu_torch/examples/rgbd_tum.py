"""TUM RGB-D driver, the Examples/RGB-D/rgbd_tum.cc analog (port of
``examples/rgbd_tum.py``).

Usage:
  python -m orb_line_slam_tpu_torch.examples.rgbd_tum SETTINGS_YAML SEQUENCE_DIR \\
      [--out CameraTrajectory.txt] [--max-frames N] [--vocab ORBvoc.txt] [--device cuda]

SETTINGS_YAML may be the reference's TUM1/2/3.yaml verbatim
(DepthMapFactor is honored).  rgb/depth pairs are associated by nearest
timestamp as upstream's associate.py does.
"""

import argparse

from ._common import add_common_args, n_frames, run_sequence


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("settings")
    ap.add_argument("sequence")
    add_common_args(ap, "CameraTrajectory.txt")
    args = ap.parse_args(argv)

    from ..config import load_settings
    from ..data.tum import TumRgbdSequence
    from ..pipeline.system import System

    cfg = load_settings(args.settings)
    seq = TumRgbdSequence(args.sequence, depth_map_factor=cfg.depth_map_factor)
    n = n_frames(seq, args.max_frames)
    print(f"TUM RGB-D sequence: {n} associated rgb/depth pairs")

    slam = System(cfg, vocabulary=args.vocab, device=args.device)

    def step(i):
        img, depth, ts = seq[i]
        slam.track_rgbd(img, depth, ts)

    run_sequence(slam, n, step)
    slam.save_trajectory_tum(args.out)
    print(f"trajectory written to {args.out}")


if __name__ == "__main__":
    main()
