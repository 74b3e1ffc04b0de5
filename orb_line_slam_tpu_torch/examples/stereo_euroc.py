"""Stereo EuRoC driver, the Examples/Stereo/stereo_euroc.cc analog
(port of ``examples/stereo_euroc.py``).

Usage:
  python -m orb_line_slam_tpu_torch.examples.stereo_euroc SETTINGS_YAML MAV0_DIR \\
      [--out CameraTrajectory.txt] [--max-frames N] [--vocab ORBvoc.txt] [--device cuda]

The settings YAML may be the reference's EuRoC.yaml verbatim (the
LEFT.*/RIGHT.* rectification blocks are honored).
"""

import argparse

from ._common import add_common_args, n_frames, run_sequence


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("settings")
    ap.add_argument("mav0")
    add_common_args(ap, "CameraTrajectory.txt")
    args = ap.parse_args(argv)

    from ..config import load_settings
    from ..data.euroc import EurocStereoSequence
    from ..pipeline.system import System

    cfg = load_settings(args.settings)
    seq = EurocStereoSequence(args.mav0, rectify=cfg.rectify)
    n = n_frames(seq, args.max_frames)
    print(f"EuRoC sequence: {n} stereo pairs")

    slam = System(cfg, vocabulary=args.vocab, device=args.device)

    def step(i):
        img_l, img_r, ts = seq[i]
        slam.track_stereo(img_l, img_r, ts)

    run_sequence(slam, n, step)
    slam.save_trajectory_tum(args.out)
    print(f"trajectory written to {args.out}")


if __name__ == "__main__":
    main()
