# Frozen copy of orb_line_slam_tpu_torch/ops/lbd.py at commit d30c4f7 (the benchmark's plain reference).
"""Line Band Descriptor (LBD) as a batched band gather + reductions.

Port of ``orb_line_slam_tpu/ops/lbd.py:32-104``: 24 samples along each
segment, 9 bands of width 7 across it; per band the mean and the
population standard deviation (``jnp.std``, so ``correction=0`` here)
of the positive and negative parts of the perpendicular and parallel
gradient (72 floats), normalised, then binarised by the fixed 256-pair
comparison pattern and packed LSB-first with the port's ``pack_bits``.
Takes the stereo pair as a leading batch dim.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .hamming import pack_bits
from .image import bilinear_sample, sobel_gradients
from .lines import linspace_f32

N_BANDS = 9
BAND_W = 7
N_SAMPLES = 24  # samples along the line


@functools.lru_cache()
def _comparison_pattern() -> np.ndarray:
    """[256, 2] index pairs into the 72-dim float LBD."""
    rng = np.random.default_rng(0x1BD)
    pairs = []
    while len(pairs) < 256:
        i, j = rng.integers(0, 72, 2)
        if i != j:
            pairs.append((i, j))
    return np.asarray(pairs, np.int32)


def _band_stats(g: torch.Tensor):
    """Mean and population std over the samples (dim -2) of the positive
    and negative parts of g [..., S, B]."""
    pos = torch.clamp(g, min=0.0)
    neg = torch.clamp(-g, min=0.0)
    return (pos.mean(dim=-2), neg.mean(dim=-2),
            torch.std(pos, dim=-2, correction=0), torch.std(neg, dim=-2, correction=0))


def lbd_features(img: torch.Tensor, p0: torch.Tensor, p1: torch.Tensor, grads=None) -> torch.Tensor:
    """The normalised 72-float band statistics [B, L, 72] that the
    descriptor binarises, for segments p0/p1 [B, L, 2] of a [B, H, W]
    batch of images."""
    gx, gy = sobel_gradients(img.to(torch.float32)) if grads is None else grads
    dev = p0.device
    d = p1 - p0
    length = torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True)) + 1e-6
    dl = d / length                                              # unit direction
    dperp = torch.stack([-dl[..., 1], dl[..., 0]], dim=-1)       # unit normal
    ts = linspace_f32(0.0, 1.0, N_SAMPLES, device=dev)
    band_off = (torch.arange(N_BANDS, device=dev) - (N_BANDS - 1) / 2.0) * BAND_W
    centers = p0[..., None, :] + d[..., None, :] * ts[:, None]   # [B, L, S, 2]
    pts = centers[..., None, :] + dperp[..., None, None, :] * band_off[:, None]   # [B, L, S, 9, 2]
    g = bilinear_sample(torch.stack([gx, gy], dim=-1), pts, batch=1)              # [B, L, S, 9, 2]
    sgx, sgy = g[..., 0], g[..., 1]
    dl_ = dl[..., None, None, :]
    dp_ = dperp[..., None, None, :]
    g_par = sgx * dl_[..., 0] + sgy * dl_[..., 1]
    g_prp = sgx * dp_[..., 0] + sgy * dp_[..., 1]
    feats = torch.stack(_band_stats(g_prp) + _band_stats(g_par), dim=-1)         # [B, L, 9, 8]
    v = feats.reshape(*feats.shape[:-2], N_BANDS * 8)
    return v / (torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True)) + 1e-6)


def lbd_descriptors(img: torch.Tensor, p0: torch.Tensor, p1: torch.Tensor, valid: torch.Tensor,
                    grads=None) -> torch.Tensor:
    """Packed 32-byte LBD descriptors, uint8 [B, L, 32], for segments
    p0/p1 [B, L, 2] (valid [B, L]) of a [B, H, W] batch of images.
    grads: optional precomputed Sobel (gx, gy) shared with the detector."""
    v = lbd_features(img, p0, p1, grads)
    pat = torch.from_numpy(_comparison_pattern()).long().to(v.device)
    bits = (v[..., pat[:, 0]] > v[..., pat[:, 1]]).to(torch.uint8)
    desc = pack_bits(bits)
    return torch.where(valid[..., None], desc, torch.zeros_like(desc))
