"""KITTI odometry dataset loader.

A copy of ``orb_line_slam_tpu/data/kitti.py`` (the port imports nothing
of the JAX package): numpy, and cv2 only when an image is read.
Rebuilds the LoadImages logic of Examples/Stereo/stereo_kitti.cc
(SURVEY.md §2.1 row 22): image_0/image_1 grayscale pairs + times.txt.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


class KittiStereoSequence:
    def __init__(self, sequence_path: str | Path):
        p = Path(sequence_path)
        self.left_dir = p / "image_0"
        self.right_dir = p / "image_1"
        times_file = p / "times.txt"
        self.timestamps = (
            np.loadtxt(times_file) if times_file.exists() else None
        )
        self.left = sorted(self.left_dir.glob("*.png"))
        self.right = sorted(self.right_dir.glob("*.png"))
        assert len(self.left) == len(self.right), "stereo pair count mismatch"
        if self.timestamps is None:
            self.timestamps = np.arange(len(self.left)) * 0.1

    def __len__(self):
        return len(self.left)

    def __getitem__(self, i):
        import cv2

        l = cv2.imread(str(self.left[i]), cv2.IMREAD_GRAYSCALE)
        r = cv2.imread(str(self.right[i]), cv2.IMREAD_GRAYSCALE)
        return l, r, float(self.timestamps[i])


def load_kitti_gt_poses(path: str | Path) -> np.ndarray:
    """Ground-truth poses file (poses/XX.txt): [N, 3, 4] cam-to-world."""
    data = np.loadtxt(path).reshape(-1, 3, 4)
    return data
