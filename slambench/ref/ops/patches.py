# Frozen copy of orb_line_slam_tpu_torch/ops/patches.py at commit d30c4f7 (the benchmark's plain reference).
"""Patch tiles of a pyramid atlas: the plain version only (the benchmark's
reference never launches a kernel of the program)."""

from __future__ import annotations

import torch

PATCH = 32


def patch_tiles_reference(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Plain torch version: [N, 32, 32] float32 tiles by advanced indexing."""
    h, w = img.shape
    half = PATCH // 2
    x0 = torch.clamp(xy[:, 0] - (half - 1), 0, w - PATCH).long()
    y0 = torch.clamp(xy[:, 1] - (half - 1), 0, h - PATCH).long()
    d = torch.arange(PATCH, device=img.device)
    ys = y0[:, None, None] + d[None, :, None]
    xs = x0[:, None, None] + d[None, None, :]
    return img[ys, xs]


def gather_patch_tiles(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """[N, 32, 32] float32 tiles of a float32 [H, W] image at int32
    [N, 2] (x, y) keypoints, by the plain version on any device."""
    if img.dim() != 2 or xy.dim() != 2 or xy.shape[1] != 2:
        raise ValueError(f"want img [H, W] and xy [N, 2], got {tuple(img.shape)}, {tuple(xy.shape)}")
    if img.dtype != torch.float32 or xy.dtype != torch.int32:
        raise TypeError(f"want float32 img and int32 xy, got {img.dtype}, {xy.dtype}")
    if img.shape[0] < PATCH or img.shape[1] < PATCH:
        raise ValueError(f"image {tuple(img.shape)} smaller than a {PATCH}x{PATCH} tile")
    if img.device != xy.device:
        raise ValueError(f"img on {img.device}, xy on {xy.device}")
    if not (img.is_contiguous() and xy.is_contiguous()):
        raise ValueError("img and xy must be contiguous")
    return patch_tiles_reference(img, xy)
