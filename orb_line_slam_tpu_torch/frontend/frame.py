"""Frame construction: the per-frame front end.

Port of ``orb_line_slam_tpu/frontend/frame.py`` — ``Frame`` and
``build_stereo_frame`` (27-74): dual ORB extraction, stereo matching with
SAD sub-pixel depth, keypoint undistortion, for one pair or, as
``build_stereo_frames``, for B pairs at once; ``build_rgbd_frame`` and
``build_mono_frame`` (77-116): single-image extraction
(``extract_orb``, one fused describe launch) with depths read from a
registered depth map, or none.  Everything stays on the device of the
input images.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SlamConfig
from ..geometry.camera import undistort_points
from ..utils.timing import span
from .orb_extractor import extract_orb, extract_orb_stereo
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
    """Features and stereo depths of a rectified [H, W] pair (uint8 or
    float32), or of B pairs [B, H, W] with a leading [B] on every leaf."""
    featL, atlasL, axyL, deltaL, featR, atlasR, offsR = extract_orb_stereo(img_left, img_right, cfg.orb)
    with span("stereo"):
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


def build_stereo_frames(imgs_left: torch.Tensor, imgs_right: torch.Tensor, cfg: SlamConfig) -> Frame:
    """The frames of B rectified pairs [B, H, W] on one device, with a
    leading [B] on every leaf: the counterpart of the JAX package's
    ``make_batched_frontend`` (``parallel/multi_sequence.py:25-42``), which
    puts one sequence on each device of a mesh.  Here all B pairs go
    through one pyramid, one detection pass, one ``orb_describe`` launch
    over the 2B images and one ``stereo_sad`` launch over the B pairs."""
    if imgs_left.dim() != 3 or imgs_left.shape != imgs_right.shape:
        raise ValueError(f"want two [B, H, W] stacks of one shape, got {tuple(imgs_left.shape)}, "
                         f"{tuple(imgs_right.shape)}")
    return build_stereo_frame(imgs_left, imgs_right, cfg)


def build_rgbd_frame(img: torch.Tensor, depth_map: torch.Tensor, cfg: SlamConfig) -> Frame:
    """RGB-D frame (``frame.py:77-99``, Frame::ComputeStereoFromRGBD):
    the depth of each keypoint read at its rounded (half to even), clipped
    pixel of the registered float32 depth map [H, W] (m), and a synthetic
    right coordinate u_right = u - bf / depth from the distorted x; both -1
    where the depth is not positive."""
    feat = extract_orb(img, cfg.orb)
    h, w = depth_map.shape
    xi = torch.clamp(torch.round(feat.xy[:, 0]).to(torch.int32), 0, w - 1).long()
    yi = torch.clamp(torch.round(feat.xy[:, 1]).to(torch.int32), 0, h - 1).long()
    d = depth_map[yi, xi].to(torch.float32)
    ok = feat.valid & (d > 0)
    none = torch.full_like(d, -1.0)
    return Frame(
        xy=undistort_points(cfg.camera, feat.xy),
        response=feat.response,
        angle=feat.angle,
        octave=feat.octave,
        desc=feat.desc,
        valid=feat.valid,
        u_right=torch.where(ok, feat.xy[:, 0] - cfg.camera.bf / torch.clamp(d, min=1e-6), none),
        depth=torch.where(ok, d, none),
    )


def build_mono_frame(img: torch.Tensor, cfg: SlamConfig) -> Frame:
    """Monocular frame (``frame.py:102-116``): no depth channel, u_right
    and depth -1 everywhere."""
    feat = extract_orb(img, cfg.orb)
    none = torch.full((feat.n,), -1.0, device=feat.xy.device)
    return Frame(
        xy=undistort_points(cfg.camera, feat.xy),
        response=feat.response,
        angle=feat.angle,
        octave=feat.octave,
        desc=feat.desc,
        valid=feat.valid,
        u_right=none,
        depth=none.clone(),
    )
