"""Batched multi-level ORB extraction (the front end's hot loop 1).

Port of ``orb_line_slam_tpu/frontend/orb_extractor.py`` —
``_detect_level`` (50-89), ``shift_tiles`` (92-113),
``extract_orb_with_tiles`` (214-261), ``extract_orb`` (264-276) and
``extract_orb_stereo`` (279-356); ``shift_blur_tiles`` (155-211) lives in
``ops/describe.py``.  Images are cast to float32 before any arithmetic
(uint8 wraps in torch, as ``orb_extractor.py:226,293`` cast for the same
reason).  A stereo pair runs as one [2, H, W] batch through pyramid
and detection, and one fused kernel launch (``ops/describe.py``) cuts
both images' tiles, shifts and blurs them and takes orientation and
BRIEF without writing a tile; B pairs (the batched multi-sequence front
end, ``orb_line_slam_tpu/parallel/multi_sequence.py:25-42``) run as one
[2B, H, W] batch with one launch; ``extract_orb`` (the mono and RGB-D
frames' extraction) launches the same kernel on a batch of one.
``extract_orb_with_tiles`` returns tiles, so it keeps the patch-tile
gather (``ops/patches.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import OrbConfig
from ..ops.brief import brief_descriptors_from_tiles, ic_angle_from_tiles
from ..ops.describe import describe_keypoints, shift_blur_tiles
from ..ops.fast import fast_score_map, nms3x3
from ..ops.image import build_pyramid, pyramid_atlas
from ..ops.patches import gather_patch_tiles
from ..ops.topk_grid import select_topk_grid
from ..utils.timing import span


class FrameFeatures(NamedTuple):
    """SoA keypoints + descriptors, padded to the static feature budget."""

    xy: torch.Tensor        # float32 [N, 2] level-0 pixel coords
    response: torch.Tensor  # float32 [N]
    angle: torch.Tensor     # float32 [N] radians
    octave: torch.Tensor    # int32 [N]
    desc: torch.Tensor      # uint8 [N, 32] packed BRIEF-256
    valid: torch.Tensor     # bool [N]

    @property
    def n(self) -> int:
        return self.xy.shape[0]


def _detect_level(img: torch.Tensor, quota: int, cfg: OrbConfig):
    """FAST + NMS + grid top-K on one level ([..., h, w]); returns (xy
    int32, delta float32 in [-0.5, 0.5] from a parabola over the raw
    score per axis, resp, valid)."""
    raw = fast_score_map(img)
    score = nms3x3(raw)
    h, w = img.shape[-2], img.shape[-1]
    m = cfg.edge_margin
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    interior = (ys >= m) & (ys < h - m) & (xs >= m) & (xs < w - m)
    score = torch.where(interior, score, torch.zeros((), device=img.device))

    n_cells = max(1, (h // cfg.cell_size) * (w // cfg.cell_size))
    k_per_cell = max(1, min(16, (3 * quota) // n_cells + 1))
    xy, resp, valid = select_topk_grid(score, cfg.cell_size, k_per_cell, quota, cfg.min_th_fast)
    x, y = xy[..., 0].long(), xy[..., 1].long()
    flat = raw.reshape(*raw.shape[:-2], h * w)

    def at(dy, dx):
        idx = torch.clamp(y + dy, 0, h - 1) * w + torch.clamp(x + dx, 0, w - 1)
        return torch.gather(flat, -1, idx)

    sc = at(0, 0)
    dl, dr = at(0, -1), at(0, 1)
    du, dd = at(-1, 0), at(1, 0)
    denx = 2.0 * sc - dl - dr
    deny = 2.0 * sc - du - dd
    zero = torch.zeros_like(sc)
    dx = torch.where(denx > 1e-6, 0.5 * (dr - dl) / denx, zero)
    dy = torch.where(deny > 1e-6, 0.5 * (dd - du) / deny, zero)
    delta = torch.clamp(torch.stack([dx, dy], dim=-1), -0.5, 0.5)
    return xy, delta, resp, valid


def shift_tiles(tiles: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Bilinear shift of [N, 32, 32] tiles by -delta (edge-padded), so the
    sub-pixel keypoint lands on tile index (15, 15)."""
    tp = torch.nn.functional.pad(tiles[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    dx = delta[:, 0][:, None, None]
    dy = delta[:, 1][:, None, None]
    wx = {-1: torch.clamp(-dx, min=0.0), 0: 1.0 - torch.abs(dx), 1: torch.clamp(dx, min=0.0)}
    wy = {-1: torch.clamp(-dy, min=0.0), 0: 1.0 - torch.abs(dy), 1: torch.clamp(dy, min=0.0)}
    out = torch.zeros_like(tiles)
    for oy, wyo in wy.items():
        for ox, wxo in wx.items():
            out = out + wyo * wxo * tp[:, 1 + oy : 33 + oy, 1 + ox : 33 + ox]
    return out


def _detect_all_levels(levels, offs, cfg: OrbConfig):
    """Per-level detection of (batched) pyramid levels, concatenated over
    levels: (xy float level-0 coords, atlas xy int32, resp, octave,
    valid, delta)."""
    all_xy, all_axy, all_d, all_resp, all_oct, all_valid = [], [], [], [], [], []
    for lvl, quota in enumerate(cfg.level_quotas):
        xy, delta, resp, valid = _detect_level(levels[lvl], quota, cfg)
        all_xy.append((xy.to(torch.float32) + delta) * cfg.level_scales[lvl])
        shift = torch.tensor([0, offs[lvl]], dtype=torch.int32, device=xy.device)
        all_axy.append(xy + shift)
        all_d.append(delta)
        all_resp.append(resp)
        all_oct.append(torch.full(xy.shape[:-1], lvl, dtype=torch.int32, device=xy.device))
        all_valid.append(valid)
    return (
        torch.cat(all_xy, dim=-2), torch.cat(all_axy, dim=-2), torch.cat(all_resp, dim=-1),
        torch.cat(all_oct, dim=-1), torch.cat(all_valid, dim=-1), torch.cat(all_d, dim=-2),
    )


def _level_offsets(levels) -> list[int]:
    offs, y = [], 0
    for l in levels:
        offs.append(y)
        y += l.shape[-2]
    return offs


def _detect_image(image: torch.Tensor, cfg: OrbConfig):
    """Pyramid atlas [H_atlas, W] and per-level detection of one [H, W]
    image: (atlas, xy, axy, resp, octave, valid, delta)."""
    with span("pyramid"):
        levels = build_pyramid(image.to(torch.float32), cfg.n_levels, cfg.scale_factor)
        atlas, _ = pyramid_atlas(levels)
    with span("detect"):
        return (atlas, *_detect_all_levels(levels, _level_offsets(levels), cfg))


def extract_orb_with_tiles(image: torch.Tensor, cfg: OrbConfig):
    """Multi-level ORB extraction of one [H, W] image; also returns the
    sub-pixel-shifted patch tiles [N, 32, 32] (keypoint at (15, 15) in
    its own level)."""
    atlas, xy, axy, resp, octv, valid, deltas = _detect_image(image, cfg)
    tiles_raw = gather_patch_tiles(atlas, axy.contiguous())
    tiles = shift_tiles(tiles_raw, deltas)
    tiles_blur = shift_blur_tiles(tiles_raw, deltas)
    angles = ic_angle_from_tiles(tiles_blur)
    desc = brief_descriptors_from_tiles(tiles_blur, angles)
    return FrameFeatures(xy=xy, response=resp, angle=angles, octave=octv, desc=desc, valid=valid), tiles


def extract_orb(image: torch.Tensor, cfg: OrbConfig) -> FrameFeatures:
    """Multi-level ORB extraction of a uint8 or float32 [H, W] image
    (``orb_extractor.py:265-276``): the keypoints of ``extract_orb_with_tiles``
    described by the fused kernel on a batch of one, so no tile tensor is
    made on the card.  On the CPU it equals ``extract_orb_with_tiles(...)[0]``
    bit for bit."""
    atlas, xy, axy, resp, octv, valid, deltas = _detect_image(image, cfg)
    with span("describe"):
        angles, desc = describe_keypoints(atlas[None], axy[None].contiguous(), deltas[None].contiguous())
    return FrameFeatures(xy=xy, response=resp, angle=angles, octave=octv, desc=desc, valid=valid)


def extract_orb_stereo(img_left: torch.Tensor, img_right: torch.Tensor, cfg: OrbConfig):
    """Joint extraction for a stereo pair [H, W], or for B pairs [B, H, W]
    with a leading [B] on every returned tensor but ``offs``.  Returns
    (featL, atlasL, axyL, deltaL, featR, atlasR, offs): the pyramid atlases
    with their level row offsets, and the left keypoints' integer atlas
    coordinates and sub-pixel detection offsets.  All 2B images go through
    one pyramid, one detection pass and one describe launch, lefts first
    (so that each side's atlases stay contiguous).  The stereo SAD cuts its
    raw integer-aligned patches from the atlases itself; no tile tensor is
    made here (the JAX package returns tilesL and tilesR instead)."""
    single = img_left.dim() == 2
    if single:
        img_left, img_right = img_left[None], img_right[None]
    b = img_left.shape[0]
    with span("pyramid"):
        img = torch.stack([img_left, img_right]).to(torch.float32).reshape(2 * b, *img_left.shape[1:])
        levels = build_pyramid(img, cfg.n_levels, cfg.scale_factor)
        atlas, offs = pyramid_atlas(levels)
    with span("detect"):
        xy, axy, resp, octv, valid, deltas = _detect_all_levels(levels, _level_offsets(levels), cfg)
    with span("describe"):
        axy = axy.contiguous()
        angles, desc = describe_keypoints(atlas, axy, deltas.contiguous())
    n = cfg.n_features
    angles, desc = angles.reshape(2 * b, n), desc.reshape(2 * b, n, 32)

    def side(i):
        rows = slice(i * b, (i + 1) * b)
        return FrameFeatures(xy=xy[rows], response=resp[rows], angle=angles[rows], octave=octv[rows],
                             desc=desc[rows], valid=valid[rows])

    out = (side(0), atlas[:b], axy[:b], deltas[:b], side(1), atlas[b:])
    if single:
        out = tuple(type(x)(*(t[0] for t in x)) if isinstance(x, FrameFeatures) else x[0] for x in out)
    return (*out, offs)
