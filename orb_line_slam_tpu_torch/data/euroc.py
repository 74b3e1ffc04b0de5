"""EuRoC MAV dataset loader with stereo rectification.

A copy of ``orb_line_slam_tpu/data/euroc.py`` (the port imports nothing
of the JAX package): numpy, and cv2 only when a sequence is rectified or
an image read.  Rebuilds Examples/Stereo/stereo_euroc.cc's LoadImages
and the cv::initUndistortRectifyMap rectification driven by the YAML
LEFT.*/RIGHT.* blocks (SURVEY.md §2.1 row 22, §5 config table).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


class EurocStereoSequence:
    def __init__(self, mav_dir: str | Path, rectify: dict | None = None):
        """mav_dir: .../mav0 containing cam0/data, cam1/data.
        rectify: the SlamConfig.rectify dict (LEFT/RIGHT K, D, R, P)."""
        p = Path(mav_dir)
        cam0 = p / "cam0" / "data"
        cam1 = p / "cam1" / "data"
        self.left = sorted(cam0.glob("*.png"))
        right_by_stamp = {f.stem: f for f in cam1.glob("*.png")}
        pairs = [(f, right_by_stamp.get(f.stem)) for f in self.left]
        self.pairs = [(l, r) for l, r in pairs if r is not None]
        self.timestamps = [int(l.stem) * 1e-9 for l, _ in self.pairs]
        self.maps = None
        if rectify is not None:
            import cv2

            self.maps = {}
            for side in ("LEFT", "RIGHT"):
                blk = rectify[side]
                m1, m2 = cv2.initUndistortRectifyMap(
                    blk["K"], blk["D"].reshape(-1), blk["R"],
                    blk["P"][:3, :3], (blk["width"], blk["height"]),
                    cv2.CV_32FC1,
                )
                self.maps[side] = (m1, m2)

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, i):
        import cv2

        l = cv2.imread(str(self.pairs[i][0]), cv2.IMREAD_GRAYSCALE)
        r = cv2.imread(str(self.pairs[i][1]), cv2.IMREAD_GRAYSCALE)
        if self.maps is not None:
            l = cv2.remap(l, *self.maps["LEFT"], cv2.INTER_LINEAR)
            r = cv2.remap(r, *self.maps["RIGHT"], cv2.INTER_LINEAR)
        return l, r, self.timestamps[i]


def load_euroc_gt(mav_dir: str | Path):
    """Ground truth state_groundtruth_estimate0/data.csv ->
    (timestamps [N], positions [N, 3])."""
    p = Path(mav_dir) / "state_groundtruth_estimate0" / "data.csv"
    rows = np.loadtxt(p, delimiter=",", skiprows=1, usecols=(0, 1, 2, 3))
    return rows[:, 0] * 1e-9, rows[:, 1:4]
