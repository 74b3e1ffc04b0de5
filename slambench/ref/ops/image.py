# Frozen copy of orb_line_slam_tpu_torch/ops/image.py at commit d30c4f7 (the benchmark's plain reference).
"""Image ops for the ORB and line front ends: pyramid, pyramid atlas,
separable filters, Sobel gradients and image sampling.

Port of ``orb_line_slam_tpu/ops/image.py`` — ``_gaussian_taps``
(lines 24-27), ``separable_filter`` and ``gaussian_blur`` (44-72),
``_resize_matrix`` (76-87), ``resize_bilinear`` (90-103),
``pyramid_shapes`` (106-110), ``build_pyramid`` (113-121),
``sobel_gradients`` (124-133), ``bilinear_sample`` and
``nearest_sample`` (136-183) and ``pyramid_atlas`` (186-202).
``resize_bilinear`` keeps the JAX package's two interpolation matmuls
with the numpy ``_resize_matrix`` weights (half-pixel centres,
anti-aliasing triangle when downsampling): ``F.interpolate`` weighs
pixels differently.  ``separable_filter`` is the banded matmul's
semantics (same tap order, zero padding) written as an fp32 stencil:
the banded form exists only for the TPU's MXU.  Images may carry a
leading batch dim (the stereo pair goes through as one [2, H, W]
tensor).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _gaussian_taps(sigma: float, radius: int) -> tuple[float, ...]:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return tuple((k / k.sum()).astype(np.float32).tolist())


@functools.lru_cache(maxsize=256)
def _resize_matrix(n_out: int, n_in: int) -> np.ndarray:
    """[n_out, n_in] row-interpolation matrix reproducing
    jax.image.resize(method='bilinear'): half-pixel centers with an
    anti-aliasing triangle kernel when downsampling."""
    scale = n_out / n_in
    inv = max(1.0 / scale, 1.0)
    x = (np.arange(n_out) + 0.5) / scale - 0.5
    j = np.arange(n_in)
    w = np.maximum(0.0, 1.0 - np.abs(j[None, :] - x[:, None]) / inv)
    w = w / np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
    return w.astype(np.float32)


@functools.lru_cache(maxsize=256)
def _resize_matrix_on(n_out: int, n_in: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_resize_matrix(n_out, n_in)).to(device)


def resize_bilinear(img: torch.Tensor, new_hw: tuple[int, int]) -> torch.Tensor:
    """Anti-aliased bilinear resize of [..., H, W] as two fp32 matmuls."""
    h2, w2 = new_hw
    h1, w1 = img.shape[-2], img.shape[-1]
    My = _resize_matrix_on(h2, h1, img.device)
    Mx = _resize_matrix_on(w2, w1, img.device)
    return (My @ img) @ Mx.T


def pyramid_shapes(h: int, w: int, n_levels: int, scale: float) -> list[tuple[int, int]]:
    return [
        (max(8, int(round(h / scale**i))), max(8, int(round(w / scale**i))))
        for i in range(n_levels)
    ]


def build_pyramid(img: torch.Tensor, n_levels: int, scale: float) -> list[torch.Tensor]:
    """Image pyramid as a list of float32 [..., h_l, w_l] tensors."""
    h, w = img.shape[-2], img.shape[-1]
    shapes = pyramid_shapes(h, w, n_levels, scale)
    levels = [img.to(torch.float32)]
    for lvl in range(1, n_levels):
        levels.append(resize_bilinear(levels[-1], shapes[lvl]))
    return levels


def _filter_dim(img: torch.Tensor, taps: tuple, dim: int) -> torch.Tensor:
    """out[i] = sum_k taps[k] * img[i + r - k] along `dim`, zero outside
    (row i of the JAX package's banded matrix); zero taps are skipped."""
    r = (len(taps) - 1) // 2
    n = img.shape[dim]
    pad = [0, 0] * (img.dim() - 1 - (dim % img.dim())) + [r, r]
    padded = torch.nn.functional.pad(img, pad)
    out = None
    for k, tap in enumerate(taps):
        if tap == 0.0:
            continue
        term = float(tap) * padded.narrow(dim, 2 * r - k, n)
        out = term if out is None else out + term
    return out if out is not None else torch.zeros_like(img)


def separable_filter(img: torch.Tensor, taps_y: tuple, taps_x: tuple) -> torch.Tensor:
    """Separable FIR filter of [..., H, W]: along y, then along x."""
    return _filter_dim(_filter_dim(img, taps_y, -2), taps_x, -1)


def gaussian_blur(img: torch.Tensor, sigma: float = 2.0, radius: int = 3) -> torch.Tensor:
    """Separable Gaussian blur of a [..., H, W] float image."""
    taps = _gaussian_taps(sigma, radius)
    return separable_filter(img, taps, taps)


def sobel_gradients(img: torch.Tensor):
    """Sobel (dx, dy) of a [..., H, W] float image, zero-padded; the tap
    order of the JAX package's (1, 0, -1) difference rows."""
    smooth = (1.0, 2.0, 1.0)
    diff = (1.0, 0.0, -1.0)
    return separable_filter(img, smooth, diff), separable_filter(img, diff, smooth)


def _flat_index(img: torch.Tensor, xy_shape, batch: int):
    """(flat image [*, C?], per-sample base offset) for image sampling:
    with `batch` leading dims, sample b reads image b."""
    h, w = img.shape[batch], img.shape[batch + 1]
    nb = 1
    for s in img.shape[:batch]:
        nb *= s
    chans = img.shape[batch + 2:]
    flat = img.reshape(nb * h * w, *chans)
    base = None
    if batch:
        base = (torch.arange(nb, device=img.device) * (h * w)).reshape(
            *img.shape[:batch], *([1] * (len(xy_shape) - batch - 1)))
    return flat, base, h, w, len(chans) > 0


def bilinear_sample(img: torch.Tensor, xy: torch.Tensor, batch: int = 0) -> torch.Tensor:
    """Bilinear samples of img at float (x, y) coords xy [..., 2], clamped
    to [0, w - 1.001] x [0, h - 1.001].  img is [*B, H, W] or
    [*B, H, W, C] (channels gathered together), with `batch` leading
    dims B shared with xy; returns xy.shape[:-1] (+ (C,))."""
    flat, base, h, w, channels = _flat_index(img, xy.shape, batch)
    x = torch.clamp(xy[..., 0], 0.0, w - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, h - 1.001)
    x0 = torch.floor(x).to(torch.int32)
    y0 = torch.floor(y).to(torch.int32)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = x - x0
    fy = y - y0
    r0 = y0 * w
    r1 = y1 * w
    if base is not None:
        r0 = r0 + base
        r1 = r1 + base
    v00 = flat[(r0 + x0).long()]
    v01 = flat[(r0 + x1).long()]
    v10 = flat[(r1 + x0).long()]
    v11 = flat[(r1 + x1).long()]
    if channels:
        fx = fx[..., None]
        fy = fy[..., None]
    return v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy) + v10 * (1 - fx) * fy + v11 * fx * fy


def nearest_sample(img: torch.Tensor, xy: torch.Tensor, batch: int = 0) -> torch.Tensor:
    """Nearest-neighbour samples (round half to even, clamped to the
    image); same layouts as ``bilinear_sample``."""
    flat, base, h, w, _ = _flat_index(img, xy.shape, batch)
    x = torch.clamp(torch.round(xy[..., 0]).to(torch.int32), 0, w - 1)
    y = torch.clamp(torch.round(xy[..., 1]).to(torch.int32), 0, h - 1)
    idx = y * w + x
    if base is not None:
        idx = idx + base
    return flat[idx.long()]


def pyramid_atlas(levels: list[torch.Tensor]):
    """Stack pyramid levels into one vertically concatenated atlas
    (level L at rows [offset[L], offset[L] + h_L), right-padded with
    zeros).  Returns (atlas [..., sumH, maxW] float32, offsets int32)."""
    max_w = max(l.shape[-1] for l in levels)
    offs, padded, y = [], [], 0
    for l in levels:
        offs.append(y)
        y += l.shape[-2]
        padded.append(torch.nn.functional.pad(l, (0, max_w - l.shape[-1])))
    atlas = torch.cat(padded, dim=-2)
    return atlas, torch.tensor(offs, dtype=torch.int32, device=atlas.device)
