# Frozen copy of orb_line_slam_tpu_torch/ops/describe.py at commit d30c4f7 (the benchmark's plain reference).
"""Orientation and BRIEF-256 of keypoints from the pyramid atlas: the plain
composition clamped 32x32 tile -> shift_blur_tiles -> ic_angle_from_tiles
-> brief_descriptors_from_tiles, on any device (no kernel launch)."""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .brief import N_ANGLE_BINS, _rotated_flat_indices, brief_descriptors_from_tiles, ic_angle_from_tiles
from .image import _gaussian_taps
from .patches import PATCH, patch_tiles_reference

BAND_TAPS = 9   # row i of each shift+blur matrix is nonzero in columns i-4..i+4


@functools.lru_cache()
def _shift_blur_mats(sigma: float = 2.0, radius: int = 3):
    """Three static float32 [32, 32] matrices (B@S-, B, B@S+): the
    row-normalized zero-padded Gaussian blur B composed with the
    edge-clamped one-pixel shifts."""
    k = np.asarray(_gaussian_taps(sigma, radius), np.float32)
    n = 32
    B = np.zeros((n, n), np.float32)
    for i in range(n):
        for t in range(2 * radius + 1):
            j = i + t - radius
            if 0 <= j < n:
                B[i, j] = k[t]
    B /= B.sum(axis=1, keepdims=True)
    Sm = np.zeros((n, n), np.float32)
    Sp = np.zeros((n, n), np.float32)
    for i in range(n):
        Sm[i, max(i - 1, 0)] = 1.0
        Sp[i, min(i + 1, n - 1)] = 1.0
    return B @ Sm, B, B @ Sp


@functools.lru_cache(maxsize=8)
def _shift_blur_mats_on(device: torch.device):
    return tuple(torch.from_numpy(m).to(device) for m in _shift_blur_mats())


def shift_blur_tiles(tiles: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Fused sub-pixel shift + normalized Gaussian blur of [N, 32, 32]
    tiles, as batched products with the three static matrices."""
    Am, A0, Ap = _shift_blur_mats_on(tiles.device)

    def axis_weights(d):
        return torch.clamp(-d, min=0.0), 1.0 - torch.abs(d), torch.clamp(d, min=0.0)

    wmy, w0y, wpy = axis_weights(delta[:, 1][:, None, None])
    wmx, w0x, wpx = axis_weights(delta[:, 0][:, None, None])
    ty = wmy * (Am @ tiles) + w0y * (A0 @ tiles) + wpy * (Ap @ tiles)
    return wmx * (ty @ Am.T) + w0x * (ty @ A0.T) + wpx * (ty @ Ap.T)


def describe_reference(atlas: torch.Tensor, axy: torch.Tensor, delta: torch.Tensor):
    """Plain torch version: (angle float32 [B*N], desc uint8 [B*N, 32])."""
    tiles = torch.cat([patch_tiles_reference(atlas[i], axy[i]) for i in range(atlas.shape[0])])
    blur = shift_blur_tiles(tiles, delta.reshape(-1, 2))
    angles = ic_angle_from_tiles(blur)
    return angles, brief_descriptors_from_tiles(blur, angles)


def describe_keypoints(atlas: torch.Tensor, axy: torch.Tensor, delta: torch.Tensor):
    """Angle (float32 [B*N], radians) and BRIEF-256 (uint8 [B*N, 32]) of
    int32 [B, N, 2] (x, y) atlas keypoints with float32 [B, N, 2] sub-pixel
    offsets on a float32 [B, H, W] atlas, by the plain version."""
    if atlas.dim() != 3 or axy.dim() != 3 or axy.shape[2] != 2 or axy.shape[0] != atlas.shape[0]:
        raise ValueError(f"want atlas [B, H, W] and axy [B, N, 2], got {tuple(atlas.shape)}, {tuple(axy.shape)}")
    if delta.shape != axy.shape:
        raise ValueError(f"delta {tuple(delta.shape)} does not match axy {tuple(axy.shape)}")
    if atlas.dtype != torch.float32 or axy.dtype != torch.int32 or delta.dtype != torch.float32:
        raise TypeError(f"want float32 atlas, int32 axy, float32 delta, got {atlas.dtype}, {axy.dtype}, {delta.dtype}")
    if atlas.shape[1] < PATCH or atlas.shape[2] < PATCH:
        raise ValueError(f"atlas {tuple(atlas.shape)} smaller than a {PATCH}x{PATCH} tile")
    if not (atlas.device == axy.device == delta.device):
        raise ValueError(f"atlas on {atlas.device}, axy on {axy.device}, delta on {delta.device}")
    if not (atlas.is_contiguous() and axy.is_contiguous() and delta.is_contiguous()):
        raise ValueError("atlas, axy and delta must be contiguous")
    return describe_reference(atlas, axy, delta)
