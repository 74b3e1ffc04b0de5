"""The stereo matcher's sliding SAD, straight from the pyramid atlases.

``stereo_sad`` computes the [N, 11] centre-normalised sums of absolute
differences of ``orb_line_slam_tpu/frontend/stereo.py:153-165``: the
11x11 left patch (rows and columns 10..20 of the keypoint's clamped 32x32
tile) against eleven 11x11 windows of the right strip that
``_gather_window`` (``stereo.py:61-87``) blends from the clamped tile at
the floored right centre.  It dispatches on the device of its input: CPU
tensors take that composition (``stereo_sad_reference``); CUDA tensors
launch the fused kernel in ``csrc/stereo_sad.cu`` (one warp per keypoint,
no tile in device memory) or raise.  ``launches`` counts kernel launches.

Kernel against plain version: every product and difference is rounded
alike; the float32 sum of 121 terms is taken in another order, so
``|sad - plain| <= 1e-5 * plain + 1e-2``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .patches import PATCH, patch_tiles_reference

SAD_W = 5       # half window -> 11x11
SAD_SLIDE = 5   # +-5 px slide
N_OFFSETS = 2 * SAD_SLIDE + 1
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
)

# Kernel launches since import (or since the caller last reset it).
launches = 0


def gather_window_reference(atlas, cx, cy, half_w, extra=0):
    """[N, 2h+1, 2h+1+2*extra] bilinear windows at float centres, blended
    from one integer-aligned 32x32 tile per keypoint."""
    assert half_w + extra <= 10
    xi = torch.floor(cx)
    yi = torch.floor(cy)
    fx = (cx - xi)[:, None, None]
    fy = (cy - yi)[:, None, None]
    xy = torch.stack([xi, yi], dim=-1).to(torch.int32)
    t = patch_tiles_reference(atlas, xy)
    blend = (
        (1 - fy) * (1 - fx) * t[:, :-1, :-1]
        + (1 - fy) * fx * t[:, :-1, 1:]
        + fy * (1 - fx) * t[:, 1:, :-1]
        + fy * fx * t[:, 1:, 1:]
    )
    r0 = 15 - half_w
    c0 = 15 - half_w - extra
    return blend[:, r0 : r0 + 2 * half_w + 1, c0 : c0 + 2 * (half_w + extra) + 1]


def stereo_sad_reference(atlas_l, axy_l, atlas_r, cx, cy) -> torch.Tensor:
    """Plain torch version: float32 [N, 11]."""
    c = 15
    tiles_l = patch_tiles_reference(atlas_l, axy_l)
    patch_l = tiles_l[:, c - SAD_W : c + SAD_W + 1, c - SAD_W : c + SAD_W + 1]
    patch_l = patch_l - patch_l[:, SAD_W : SAD_W + 1, SAD_W : SAD_W + 1]
    strip_r = gather_window_reference(atlas_r, cx, cy, SAD_W, extra=SAD_SLIDE)   # [N, 11, 21]
    win = strip_r.unfold(2, 2 * SAD_W + 1, 1).permute(0, 2, 1, 3)               # [N, 11k, 11, 11]
    win = win - win[:, :, SAD_W : SAD_W + 1, SAD_W : SAD_W + 1]
    return torch.sum(torch.abs(patch_l[:, None] - win), dim=(2, 3))


def stereo_sad_cuda(atlas_l, axy_l, atlas_r, cx, cy) -> torch.Tensor:
    """Launch the fused kernel on the current stream (no synchronisation)."""
    global launches
    n = axy_l.shape[0]
    sad = torch.empty((n, N_OFFSETS), dtype=torch.float32, device=atlas_l.device)
    fn = _build.kernel("stereo_sad", _ARGTYPES)
    _build.launch(fn, "stereo_sad", atlas_l.device, atlas_l.data_ptr(), axy_l.data_ptr(), atlas_r.data_ptr(),
                  cx.data_ptr(), cy.data_ptr(), atlas_l.shape[0], atlas_l.shape[1], n, sad.data_ptr())
    if n > 0:      # with no keypoints the C function launches nothing
        launches += 1
    return sad


def stereo_sad(atlas_l, axy_l, atlas_r, cx, cy) -> torch.Tensor:
    """float32 [N, 11] SADs of int32 [N, 2] (x, y) left atlas keypoints
    against the right atlas around float32 [N] centres (cx, cy), both
    atlases float32 [H, W] of one shape; CPU tensors take the plain
    version, CUDA tensors the kernel."""
    n = axy_l.shape[0]
    if atlas_l.dim() != 2 or atlas_l.shape != atlas_r.shape or axy_l.dim() != 2 or axy_l.shape[1] != 2:
        raise ValueError(f"want two atlases [H, W] and axy [N, 2], got {tuple(atlas_l.shape)}, "
                         f"{tuple(atlas_r.shape)}, {tuple(axy_l.shape)}")
    if cx.dim() != 1 or cy.dim() != 1 or cx.shape[0] != n or cy.shape[0] != n:
        raise ValueError(f"want cx, cy [{n}], got {tuple(cx.shape)}, {tuple(cy.shape)}")
    f32 = torch.float32
    if atlas_l.dtype != f32 or atlas_r.dtype != f32 or axy_l.dtype != torch.int32 or cx.dtype != f32 or cy.dtype != f32:
        raise TypeError(f"want float32 atlases and centres and int32 keypoints, got {atlas_l.dtype}, "
                        f"{atlas_r.dtype}, {axy_l.dtype}, {cx.dtype}, {cy.dtype}")
    if atlas_l.shape[0] < PATCH or atlas_l.shape[1] < PATCH:
        raise ValueError(f"atlas {tuple(atlas_l.shape)} smaller than a {PATCH}x{PATCH} tile")
    dev = atlas_l.device
    if axy_l.device != dev or atlas_r.device != dev or cx.device != dev or cy.device != dev:
        raise ValueError(f"inputs on different devices: {dev}, {axy_l.device}, {atlas_r.device}, {cx.device}, {cy.device}")
    if not (atlas_l.is_contiguous() and axy_l.is_contiguous() and atlas_r.is_contiguous()
            and cx.is_contiguous() and cy.is_contiguous()):
        raise ValueError("atlases, keypoints and centres must be contiguous")
    if dev.type == "cpu":
        return stereo_sad_reference(atlas_l, axy_l, atlas_r, cx, cy)
    if dev.type == "cuda":
        return stereo_sad_cuda(atlas_l, axy_l, atlas_r, cx, cy)
    raise ValueError(f"no stereo-SAD kernel for device {dev}")
