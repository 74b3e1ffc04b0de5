"""Orientation and BRIEF-256 of keypoints straight from the pyramid atlas.

``describe_keypoints`` computes, per keypoint, what the composition
clamped 32x32 tile (``ops/patches.py``) -> ``shift_blur_tiles`` ->
``ic_angle_from_tiles`` -> ``brief_descriptors_from_tiles`` computes
(``orb_line_slam_tpu/frontend/orb_extractor.py:155-211, 311-323``): the
intensity-centroid angle and the packed rotated BRIEF descriptor.  It
dispatches on the device of its input: CPU tensors take that composition
(``describe_reference``); CUDA tensors launch the fused kernel in
``csrc/orb_describe.cu``, which keeps the tile in shared memory and writes
36 bytes per keypoint, or raise.  ``launches`` counts kernel launches.

Kernel against plain version: everything after the blurred tile is exact
integer arithmetic; the blurred tile is a float32 sum whose order the
matrix-product library does not fix, so the two are held to each other
statistically (angles within 1e-4 rad and descriptors bit-identical on
nearly all keypoints), not to equality.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from . import _build
from .brief import N_ANGLE_BINS, _rotated_flat_indices, brief_descriptors_from_tiles, ic_angle_from_tiles
from .image import _gaussian_taps
from .patches import PATCH, patch_tiles_reference

BAND_TAPS = 9   # row i of each shift+blur matrix is nonzero in columns i-4..i+4
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
)
# float32(1 / (2 pi / 30)): torch divides a CUDA tensor by a Python scalar
# as a product with this reciprocal (quantize_angle).
_INV_BIN = float(np.float32(1.0 / (2.0 * math.pi / N_ANGLE_BINS)))

# Kernel launches since import (or since the caller last reset it).
launches = 0


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


@functools.lru_cache()
def shift_blur_bands() -> np.ndarray:
    """float32 [3, 32, 9]: entry [m, i, o] is matrix m's element
    [i, i - 4 + o] (0 outside the matrix); nothing lies outside the band."""
    half = BAND_TAPS // 2
    bands = np.zeros((3, PATCH, BAND_TAPS), np.float32)
    for m, mat in enumerate(_shift_blur_mats()):
        rest = mat.copy()
        for i in range(PATCH):
            for o in range(BAND_TAPS):
                j = i - half + o
                if 0 <= j < PATCH:
                    bands[m, i, o] = mat[i, j]
                    rest[i, j] = 0.0
        assert not rest.any(), "shift+blur matrix has entries outside the band"
    return bands


def band_rows() -> np.ndarray:
    """float32 [32, 28], the bands as the kernel takes them: row i holds
    its 27 coefficients, matrix-major ([m * 9 + o]), and one of padding.
    Each CTA copies the rows and taps it uses into shared memory once."""
    rows = np.zeros((PATCH, 3 * BAND_TAPS + 1), np.float32)
    rows[:, : 3 * BAND_TAPS] = shift_blur_bands().transpose(1, 0, 2).reshape(PATCH, 3 * BAND_TAPS)
    return rows


@functools.lru_cache(maxsize=8)
def _kernel_tables_on(device: torch.device):
    """(band rows float32 [32, 28], rotated test-point indices int16 [30, 512])."""
    rot = _rotated_flat_indices().astype(np.int16)
    return torch.from_numpy(band_rows()).to(device), torch.from_numpy(rot).to(device)


def describe_reference(atlas: torch.Tensor, axy: torch.Tensor, delta: torch.Tensor):
    """Plain torch version: (angle float32 [B*N], desc uint8 [B*N, 32])."""
    tiles = torch.cat([patch_tiles_reference(atlas[i], axy[i]) for i in range(atlas.shape[0])])
    blur = shift_blur_tiles(tiles, delta.reshape(-1, 2))
    angles = ic_angle_from_tiles(blur)
    return angles, brief_descriptors_from_tiles(blur, angles)


def describe_cuda(atlas: torch.Tensor, axy: torch.Tensor, delta: torch.Tensor):
    """Launch the fused kernel on the current stream (no synchronisation)."""
    global launches
    b, n = axy.shape[:2]
    angle = torch.empty((b * n,), dtype=torch.float32, device=atlas.device)
    desc = torch.empty((b * n, 32), dtype=torch.uint8, device=atlas.device)
    bands, rot = _kernel_tables_on(atlas.device)
    fn = _build.kernel("orb_describe", _ARGTYPES)
    _build.launch(fn, "orb_describe", atlas.device, atlas.data_ptr(), b, atlas.shape[1], atlas.shape[2],
                  axy.data_ptr(), delta.data_ptr(), n, bands.data_ptr(), rot.data_ptr(), _INV_BIN,
                  angle.data_ptr(), desc.data_ptr())
    if b * n > 0:      # with no keypoints the C function launches nothing
        launches += 1
    return angle, desc


def describe_keypoints(atlas: torch.Tensor, axy: torch.Tensor, delta: torch.Tensor):
    """Angle (float32 [B*N], radians) and BRIEF-256 (uint8 [B*N, 32]) of
    int32 [B, N, 2] (x, y) atlas keypoints with float32 [B, N, 2] sub-pixel
    offsets on a float32 [B, H, W] atlas; CPU tensors take the plain
    version, CUDA tensors the kernel."""
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
    if atlas.device.type == "cpu":
        return describe_reference(atlas, axy, delta)
    if atlas.device.type == "cuda":
        return describe_cuda(atlas, axy, delta)
    raise ValueError(f"no describe kernel for device {atlas.device}")
