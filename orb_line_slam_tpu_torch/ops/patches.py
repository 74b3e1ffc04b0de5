"""Per-keypoint 32x32 patch tiles: the port of the one TPU kernel.

Port of ``orb_line_slam_tpu/ops/pallas_patches.py`` (the Pallas kernel
``extract_patch_tiles``, ``pl.pallas_call`` at line 99, and its plain
gather ``gather_patch_tiles`` at lines 117-130).  Tile n holds
``img[y0 + r, x0 + c]`` for r, c in [0, 32) with
``x0 = clip(x - 15, 0, W - 32)``, ``y0 = clip(y - 15, 0, H - 32)``: the
keypoint sits at tile index (15, 15), clamped near the borders.

``gather_patch_tiles`` dispatches on the device of its input: a CPU
tensor takes the plain torch version (``patch_tiles_reference``); a
CUDA tensor launches the hand-written kernel in ``csrc/patch_tiles.cu``
(built with nvcc for sm_90a at first use and loaded with ctypes by
``ops/_build.py``) or raises.  ``launches`` counts kernel launches.  The
stereo path no longer writes tiles: ``ops/describe.py`` and
``ops/stereo_sad.py`` cut the same clamped tile into shared memory and
consume it there; this gather stays for ``extract_orb_with_tiles``,
which returns tiles.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

PATCH = 32
_ARGTYPES = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p)

# Kernel launches since import (or since the caller last reset it).
launches = 0


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


def patch_tiles_cuda(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no synchronisation)."""
    global launches
    n = xy.shape[0]
    out = torch.empty((n, PATCH, PATCH), dtype=torch.float32, device=img.device)
    fn = _build.kernel("patch_tiles", _ARGTYPES)
    _build.launch(fn, "patch_tiles", img.device, img.data_ptr(), img.shape[0], img.shape[1],
                  xy.data_ptr(), n, out.data_ptr())
    if n > 0:      # with no keypoints the C function launches nothing
        launches += 1
    return out


def gather_patch_tiles(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """[N, 32, 32] float32 tiles of a float32 [H, W] image at int32
    [N, 2] (x, y) keypoints; CPU tensors take the plain version, CUDA
    tensors the kernel."""
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
    if img.device.type == "cpu":
        return patch_tiles_reference(img, xy)
    if img.device.type == "cuda":
        return patch_tiles_cuda(img, xy)
    raise ValueError(f"no patch-tile kernel for device {img.device}")
