# Frozen copy of orb_line_slam_tpu_torch/ops/brief.py at commit d30c4f7 (the benchmark's plain reference).
"""Oriented BRIEF-256 from patch tiles: intensity-centroid orientation
and the rotated test pattern.

Port of ``orb_line_slam_tpu/ops/brief.py`` — ``brief_pattern`` (34-50),
``circular_mask`` (53-57), ``_rotated_flat_indices`` (133-148),
``quantize_angle`` (183-185), ``_ic_weight_table`` (198-210),
``ic_angle_from_tiles`` (213-234) and the CPU branch of
``brief_descriptors_from_tiles`` (263-270): quantize the blurred tile to
round(tile * 16), gather the 512 rotated samples of the keypoint's angle
bin, compare pairs.  The moments are exact integer sums, so CPU and GPU
agree with each other and with the JAX package bit for bit on equal
tiles.  The TPU-only block-diagonal one-hot matmul (244-262) is not
ported.  Tiles are [N, 32, 32] with the keypoint at (15, 15).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .hamming import pack_bits

HALF_PATCH = 15
PATCH = 2 * HALF_PATCH + 1
N_ANGLE_BINS = 30
TILE = 32
TILE_C = 15
FIXED_SCALE = 16.0
# Below this intensity-centroid offset (pixels) the angle is noise and
# the patch snaps to upright (brief.py:188-195).
IC_MIN_OFFSET_PX = 0.5


@functools.lru_cache()
def brief_pattern() -> np.ndarray:
    """[256, 4] float32 rows (x1, y1, x2, y2), deterministic; test points
    clipped to euclidean radius 14 so rotations stay inside the tile."""
    rng = np.random.default_rng(0x0B51EF)
    sigma = PATCH / 5.0
    pts = rng.normal(0.0, sigma, size=(256, 4)).astype(np.float32)
    for cols in ((0, 1), (2, 3)):
        r = np.sqrt(pts[:, cols[0]] ** 2 + pts[:, cols[1]] ** 2)
        scale = np.minimum(1.0, 14.0 / np.maximum(r, 1e-6))
        pts[:, cols[0]] *= scale
        pts[:, cols[1]] *= scale
    return pts


@functools.lru_cache()
def circular_mask() -> np.ndarray:
    """[PATCH, PATCH] float32 disk mask of radius HALF_PATCH."""
    v, u = np.mgrid[-HALF_PATCH : HALF_PATCH + 1, -HALF_PATCH : HALF_PATCH + 1]
    return (u * u + v * v <= HALF_PATCH * HALF_PATCH).astype(np.float32)


@functools.lru_cache()
def _rotated_flat_indices() -> np.ndarray:
    """int32 [N_ANGLE_BINS, 512] flat tile indices of the rotated test
    points (256 p1 points, then 256 p2 points)."""
    pat = brief_pattern()
    out = np.zeros((N_ANGLE_BINS, 512), np.int32)
    for b in range(N_ANGLE_BINS):
        th = 2.0 * np.pi * b / N_ANGLE_BINS
        c, s = np.cos(th), np.sin(th)
        for half, (px, py) in enumerate(((pat[:, 0], pat[:, 1]), (pat[:, 2], pat[:, 3]))):
            rx = np.round(c * px - s * py).astype(np.int64)
            ry = np.round(s * px + c * py).astype(np.int64)
            row = np.clip(TILE_C + ry, 0, TILE - 1)
            col = np.clip(TILE_C + rx, 0, TILE - 1)
            out[b, half * 256 : (half + 1) * 256] = row * TILE + col
    return out


@functools.lru_cache()
def _ic_weight_table() -> np.ndarray:
    """int32 [1024, 3] moment weights over the 32x32 tile: disk mask x
    {u, v, 1}, zero outside the 31x31 patch."""
    mask = circular_mask()
    d = np.arange(-HALF_PATCH, HALF_PATCH + 1, dtype=np.float32)
    W = np.zeros((TILE, TILE, 3), np.int32)
    W[:31, :31, 0] = mask * d[None, :]
    W[:31, :31, 1] = mask * d[:, None]
    W[:31, :31, 2] = mask
    return W.reshape(TILE * TILE, 3)


@functools.lru_cache(maxsize=8)
def _table_on(name: str, device: torch.device) -> torch.Tensor:
    table = {"ic": _ic_weight_table, "rot": _rotated_flat_indices}[name]()
    return torch.from_numpy(table.astype(np.int64)).to(device)


def quantize_angle(angles: torch.Tensor) -> torch.Tensor:
    b = torch.round(angles / (2.0 * math.pi / N_ANGLE_BINS)).to(torch.int32)
    return torch.remainder(b, N_ANGLE_BINS)


def _fixed(tiles: torch.Tensor) -> torch.Tensor:
    return torch.round(tiles.reshape(tiles.shape[0], -1) * FIXED_SCALE).to(torch.int64)


def ic_angle_from_tiles(tiles: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle (radians) of [N, 32, 32] tiles from exact
    integer moments of round(tile * 16); weak centroids snap to 0."""
    tf = _fixed(tiles)
    W = _table_on("ic", tiles.device)
    m = [torch.sum(tf * W[:, c], dim=1).to(torch.float32) for c in range(3)]
    m10, m01, m00 = m
    offset = torch.sqrt(m10 * m10 + m01 * m01) / torch.clamp(m00, min=1e-6)
    return torch.where(offset >= IC_MIN_OFFSET_PX, torch.atan2(m01, m10), torch.zeros_like(m10))


def brief_descriptors_from_tiles(tiles_blur: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotated BRIEF-256 from blurred [N, 32, 32] tiles -> uint8 [N, 32]."""
    bins = quantize_angle(angles).long()
    tf = _fixed(tiles_blur)
    idx = _table_on("rot", tiles_blur.device)[bins]       # [N, 512]
    vals = torch.gather(tf, 1, idx)
    diff = vals[:, 256:] - vals[:, :256]
    return pack_bits(diff > 0)
