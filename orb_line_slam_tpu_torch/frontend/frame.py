"""Frame construction: the per-frame front end of the stereo path.

Port of ``orb_line_slam_tpu/frontend/frame.py:27-74`` (``Frame`` and
``build_stereo_frame``): dual ORB extraction, stereo matching with SAD
sub-pixel depth, keypoint undistortion.  Everything stays on the device
of the input images.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SlamConfig
from ..geometry.camera import undistort_points
from .orb_extractor import extract_orb_stereo
from .stereo import stereo_match


class Frame(NamedTuple):
    """Per-frame SoA feature state (tensors on one device)."""

    xy: torch.Tensor        # float32 [N, 2] undistorted level-0 coords
    response: torch.Tensor  # float32 [N]
    angle: torch.Tensor     # float32 [N]
    octave: torch.Tensor    # int32 [N]
    desc: torch.Tensor      # uint8 [N, 32]
    valid: torch.Tensor     # bool [N]
    u_right: torch.Tensor   # float32 [N] (-1 = no stereo match)
    depth: torch.Tensor     # float32 [N] (-1 = no depth)

    @property
    def n(self) -> int:
        return self.xy.shape[0]

    def numpy(self) -> "Frame":
        """Host copy with numpy leaves (one transfer per leaf)."""
        return Frame(*(t.cpu().numpy() for t in self))


def build_stereo_frame(img_left: torch.Tensor, img_right: torch.Tensor, cfg: SlamConfig) -> Frame:
    """Features and stereo depths of a rectified [H, W] pair (uint8 or float32)."""
    featL, atlasL, axyL, deltaL, featR, atlasR, offsR = extract_orb_stereo(img_left, img_right, cfg.orb)
    sm = stereo_match(featL, featR, atlasL, axyL, deltaL, atlasR, offsR, cfg.camera, cfg.orb)
    return Frame(
        xy=undistort_points(cfg.camera, featL.xy),
        response=featL.response,
        angle=featL.angle,
        octave=featL.octave,
        desc=featL.desc,
        valid=featL.valid,
        u_right=sm.u_right,
        depth=sm.depth,
    )
