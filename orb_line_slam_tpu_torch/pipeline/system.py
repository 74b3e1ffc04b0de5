"""System facade — the embedder-facing API of the stereo slice.

Port of ``orb_line_slam_tpu/pipeline/system.py`` (``track_stereo``
124-127, ``shutdown`` 239-249, ``save_trajectory_tum/kitti`` 252-258,
``tracking_state`` and ``map`` 275-279).  The device is an explicit,
required argument; nothing falls back to the CPU.  Stereo tracking runs
with points and, under the default ``LineConfig(enabled=True)``, lines.
Loop closing is not ported yet, so ``use_loop_closing`` must be False.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..config import SlamConfig, load_settings
from ..eval.trajectory import save_trajectory_kitti, save_trajectory_tum
from .tracking import Tracker


class System:
    def __init__(self, settings: SlamConfig | str | Path, use_loop_closing: bool = False, *,
                 device: str | torch.device):
        if use_loop_closing:
            raise NotImplementedError("loop closing is not ported to the torch package yet")
        self.cfg = settings if isinstance(settings, SlamConfig) else load_settings(settings)
        self.device = torch.device(device)
        self.tracker = Tracker(self.cfg, self.device)
        self.use_loop_closing = False

    def track_stereo(self, img_left, img_right, timestamp: float = 0.0) -> np.ndarray:
        """Feed a rectified stereo pair (uint8 [H, W]); returns the 4x4 Tcw."""
        return self.tracker.process_stereo(img_left, img_right, timestamp)

    def shutdown(self):
        """Apply every outstanding mapping job."""
        self.tracker.poll_map_jobs()

    def save_trajectory_kitti(self, path):
        self.shutdown()
        save_trajectory_kitti(path, self.tracker.final_trajectory())

    def save_trajectory_tum(self, path):
        self.shutdown()
        save_trajectory_tum(path, self.tracker.final_trajectory())

    @property
    def map(self):
        return self.tracker.map

    def tracking_state(self) -> str:
        return self.tracker.state
