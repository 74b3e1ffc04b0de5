"""TUM RGB-D dataset loader.

A copy of ``orb_line_slam_tpu/data/tum.py`` (the port imports nothing of
the JAX package): numpy, and cv2 only when an image is read.  Rebuilds
the LoadImages + association logic of
Examples/RGB-D/rgbd_tum.cc and Examples/Monocular/mono_tum.cc
(SURVEY.md §2.1 row 22): ``rgb.txt``/``depth.txt`` index files with
``timestamp path`` rows, nearest-timestamp rgb↔depth association
(the upstream associate.py convention, max 0.02 s offset), and the
uint16-PNG depth scale (``DepthMapFactor``, 5000 = 1 m for freiburg).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _read_index(path: Path) -> tuple[np.ndarray, list[str]]:
    """Parse a TUM index file (``# comment`` lines, then ``ts path``)."""
    stamps, files = [], []
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        stamps.append(float(parts[0]))
        files.append(parts[1])
    return np.asarray(stamps), files


def associate(
    stamps_a: np.ndarray, stamps_b: np.ndarray, max_offset: float = 0.02
) -> list[tuple[int, int]]:
    """Greedy nearest-timestamp matching (upstream associate.py)."""
    pairs = []
    used_b: set[int] = set()
    for i, ta in enumerate(stamps_a):
        j = int(np.searchsorted(stamps_b, ta))
        best, best_dt = -1, max_offset
        for cand in (j - 1, j):
            if 0 <= cand < len(stamps_b) and cand not in used_b:
                dt = abs(stamps_b[cand] - ta)
                if dt <= best_dt:
                    best, best_dt = cand, dt
        if best >= 0:
            pairs.append((i, best))
            used_b.add(best)
    return pairs


class TumRgbdSequence:
    """Associated (rgb, depth) pairs from a TUM RGB-D sequence dir."""

    def __init__(self, seq_dir: str | Path, depth_map_factor: float = 5000.0):
        p = Path(seq_dir)
        self.root = p
        rgb_ts, rgb_files = _read_index(p / "rgb.txt")
        d_ts, d_files = _read_index(p / "depth.txt")
        pairs = associate(rgb_ts, d_ts)
        self.rgb = [p / rgb_files[i] for i, _ in pairs]
        self.depth = [p / d_files[j] for _, j in pairs]
        self.timestamps = [float(rgb_ts[i]) for i, _ in pairs]
        self.factor = float(depth_map_factor)

    def __len__(self):
        return len(self.rgb)

    def __getitem__(self, i):
        import cv2

        img = cv2.imread(str(self.rgb[i]), cv2.IMREAD_GRAYSCALE)
        raw = cv2.imread(str(self.depth[i]), cv2.IMREAD_UNCHANGED)
        depth = raw.astype(np.float32) / self.factor
        return img, depth, self.timestamps[i]


class TumMonoSequence:
    """rgb.txt frames only (mono_tum.cc's LoadImages)."""

    def __init__(self, seq_dir: str | Path):
        p = Path(seq_dir)
        ts, files = _read_index(p / "rgb.txt")
        self.rgb = [p / f for f in files]
        self.timestamps = [float(t) for t in ts]

    def __len__(self):
        return len(self.rgb)

    def __getitem__(self, i):
        import cv2

        img = cv2.imread(str(self.rgb[i]), cv2.IMREAD_GRAYSCALE)
        return img, self.timestamps[i]


def load_tum_gt(seq_dir: str | Path):
    """groundtruth.txt -> (timestamps [N], positions [N, 3])."""
    p = Path(seq_dir) / "groundtruth.txt"
    rows = []
    for line in p.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        vals = [float(x) for x in line.split()]
        rows.append(vals[:4])
    arr = np.asarray(rows)
    return arr[:, 0], arr[:, 1:4]
