# Frozen copy of orb_line_slam_tpu_torch/ops/lines.py at commit d30c4f7 (the benchmark's plain reference).
"""Line-segment detection as batched dense stencils.

Port of ``orb_line_slam_tpu/ops/lines.py`` — ``DetectedLines`` (58-64),
``detect_lines`` (67-257) and ``merge_collinear`` (260-283):

  1. Sobel gradients -> magnitude and level-line doubled-angle fields;
  2. coherence score: Gaussian-blurred edge-masked (cos 2θ, sin 2θ);
  3. candidate centres: per-cell top-2 of the score (the port's stable
     ``select_topk_grid``, so candidates come out in ``lax.top_k``'s
     tie order);
  4. two gap-tolerant endpoint walks (nearest samples of the fused
     (edge, cos 2θ, sin 2θ) field, 80 steps of 2 px each way), the
     second along the chord of the first;
  5. a 0.5 px longitudinal endpoint polish and a 3-round perpendicular
     least-squares refit on one bilinear sample pass.

Every function takes a leading batch dim: the stereo pair is detected as
one [2, H, W] batch (the JAX package vmaps).  Constants are built as the
JAX code builds them, in fp32: the walk positions feed nearest-sample
rounding, where one ulp can move a sample.  ``jnp.mod`` floors, as
``torch.remainder`` does.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .image import bilinear_sample, gaussian_blur, nearest_sample, sobel_gradients
from .topk_grid import select_topk_grid

WALK_STEPS = 80      # walk samples per direction
WALK_STRIDE = 2.0    # px between walk samples
GAP_TOL = 2          # tolerated consecutive support gaps (in samples)


class DetectedLines(NamedTuple):
    p0: torch.Tensor        # float32 [..., L, 2] endpoint (x, y)
    p1: torch.Tensor        # float32 [..., L, 2] endpoint
    angle: torch.Tensor     # float32 [..., L] direction in [0, pi)
    length: torch.Tensor    # float32 [..., L]
    response: torch.Tensor  # float32 [..., L] supported length
    valid: torch.Tensor     # bool [..., L]


def linspace_f32(start: float, stop: float, num: int, device=None) -> torch.Tensor:
    """``jnp.linspace``'s fp32 construction: start * (1 - s) + stop * s
    with s = i / (num - 1), and the last entry exactly `stop`."""
    s = torch.arange(num - 1, dtype=torch.float32, device=device) / float(num - 1)
    head = torch.tensor(start, dtype=torch.float32, device=device) * (1 - s) + torch.tensor(
        stop, dtype=torch.float32, device=device) * s
    return torch.cat([head, torch.tensor([stop], dtype=torch.float32, device=device)])


def _unit(theta: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)


def _cos2(s: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Normalised angle agreement cos(2(angle - theta)) of sampled
    (edge, cos 2a, sin 2a) triples [B, L, S, 3] with theta [B, L]."""
    nrm2 = torch.sqrt(s[..., 1] ** 2 + s[..., 2] ** 2) + 1e-6
    return (s[..., 1] * torch.cos(2 * theta)[..., None] + s[..., 2] * torch.sin(2 * theta)[..., None]) / nrm2


def _fields(img: torch.Tensor, min_mag: float, grads=None):
    """Stages 1-2 for a [B, H, W] batch: (score, (mag, edge, c2, s2, c2b, s2b))."""
    x = img.to(torch.float32)
    gx, gy = sobel_gradients(x) if grads is None else grads
    mag2 = gx * gx + gy * gy
    hh, ww = x.shape[-2], x.shape[-1]
    ys = torch.arange(hh, device=x.device)[:, None]
    xs = torch.arange(ww, device=x.device)[None, :]
    interior = (ys >= 4) & (ys < hh - 4) & (xs >= 4) & (xs < ww - 4)
    mag2 = torch.where(interior, mag2, torch.zeros_like(mag2))
    mag = torch.sqrt(mag2)
    edge = (mag2 > min_mag * min_mag).to(torch.float32)
    inv = edge / torch.clamp(mag2, min=1e-9)
    c2 = -(gx * gx - gy * gy) * inv
    s2 = -(2.0 * gx * gy) * inv
    c2b = gaussian_blur(c2, sigma=2.0, radius=4)
    s2b = gaussian_blur(s2, sigma=2.0, radius=4)
    return edge * torch.sqrt(c2b * c2b + s2b * s2b), (mag, edge, c2, s2, c2b, s2b)


def detect_lines(img: torch.Tensor, n_lines: int = 128, min_mag: float = 30.0, cell: int = 24,
                 grads=None) -> DetectedLines:
    """Up to n_lines segments per image of a [B, H, W] (or [H, W]) batch.

    grads: optional precomputed Sobel (gx, gy), shared with the LBD stage."""
    squeeze = img.dim() == 2
    if squeeze:
        img = img[None]
        grads = None if grads is None else (grads[0][None], grads[1][None])
    score, fields = _fields(img, min_mag, grads)
    xy, _, valid = select_topk_grid(score, cell, 2, n_lines, 0.06)
    out = segments_from_candidates(fields, xy, valid)
    return DetectedLines(*(a[0] for a in out)) if squeeze else out


def segments_from_candidates(fields, xy: torch.Tensor, valid: torch.Tensor) -> DetectedLines:
    """Stages 4-5 for a [B, H, W] batch: walk, polish and refit a segment
    through each candidate centre xy int32 [B, L, 2] (valid [B, L])."""
    mag, edge, c2, s2, c2b, s2b = fields
    dev = xy.device
    h, w = mag.shape[-2], mag.shape[-1]
    bidx = torch.arange(xy.shape[0], device=dev)[:, None]
    xl, yl = xy[..., 0].long(), xy[..., 1].long()
    theta = torch.remainder(0.5 * torch.atan2(s2b[bidx, yl, xl], c2b[bidx, yl, xl]), math.pi)

    field = torch.stack([edge, c2, s2], dim=-1)                   # [B, H, W, 3]
    steps = WALK_STRIDE * torch.arange(1, WALK_STEPS + 1, dtype=torch.float32, device=dev)
    centers = xy.to(torch.float32)

    def walk(sign: float, theta, dxy):
        pts = centers[..., None, :] + sign * dxy[..., None, :] * steps[:, None]
        s = nearest_sample(field, pts, batch=1)                   # [B, L, S, 3]
        good = (s[..., 0] > 0.25) & (_cos2(s, theta) > 0.5)
        # The walk dies at the first window of GAP_TOL + 1 consecutive misses.
        miss = ~good
        run = miss
        for sft in range(1, GAP_TOL + 1):
            run = run & torch.nn.functional.pad(miss, (sft, 0))[..., : miss.shape[-1]]
        alive = torch.cumsum(run.to(torch.int32), dim=-1) == 0
        ga = good & alive
        extent = torch.amax(torch.where(ga, steps, torch.zeros_like(steps)), dim=-1)
        supported = WALK_STRIDE * torch.sum(ga.to(torch.float32), dim=-1)
        return extent, supported

    def both_walks(theta):
        dxy = _unit(theta)
        ext_p, sup_p = walk(+1.0, theta, dxy)
        ext_m, sup_m = walk(-1.0, theta, dxy)
        p0 = centers - dxy * ext_m[..., None]
        p1 = centers + dxy * ext_p[..., None]
        return p0, p1, ext_p + ext_m, sup_p + sup_m + 1.0

    p0, p1, _, _ = both_walks(theta)
    d01 = p1 - p0
    theta = torch.remainder(torch.atan2(d01[..., 1], d01[..., 0]), math.pi)
    p0, p1, length, supported = both_walks(theta)

    # Longitudinal endpoint polish at 0.5 px (bilinear: the sub-pixel stage).
    polish_off = torch.arange(-6, 7, dtype=torch.float32, device=dev) * 0.5

    def polish(p, outward):
        pts = p[..., None, :] + outward[..., None, :] * polish_off[:, None]
        s = bilinear_sample(field, pts, batch=1)                  # [B, L, 13, 3]
        good = (s[..., 0] > 0.25) & (_cos2(s, theta) > 0.5)
        n_ok = torch.sum(torch.cumprod(good.to(torch.int32), dim=-1), dim=-1)
        off = polish_off[torch.clamp(n_ok - 1, 0, polish_off.shape[0] - 1)]
        off = torch.where(n_ok > 0, off, torch.zeros_like(off))
        return p + outward * off[..., None]

    dxy = _unit(theta)
    p0 = polish(p0, -dxy)
    p1 = polish(p1, dxy)

    # Perpendicular least-squares refit on one sample pass, 3 rounds.
    ts_ref = linspace_f32(0.02, 0.98, 32, device=dev)
    perp_off = torch.arange(-4, 5, dtype=torch.float32, device=dev)

    def refit(p0, p1, n_rounds=3):
        d01 = p1 - p0
        th = torch.atan2(d01[..., 1], d01[..., 0])
        nrm = torch.stack([-torch.sin(th), torch.cos(th)], dim=-1)
        base = p0[..., None, :] + d01[..., None, :] * ts_ref[:, None]
        samp = base[..., None, :] + nrm[..., None, None, :] * perp_off[:, None]   # [B, L, 32, 9, 2]
        wmag = bilinear_sample(mag, samp, batch=1)                               # [B, L, 32, 9]
        a_fit = torch.zeros(p0.shape[:-1], dtype=torch.float32, device=dev)
        b_fit = torch.zeros_like(a_fit)
        for _ in range(n_rounds):
            line_off = a_fit[..., None] + b_fit[..., None] * ts_ref
            dist = torch.abs(perp_off - line_off[..., None])
            wm = wmag * torch.clamp(1.0 - dist / 3.0, min=0.0)
            wsum = torch.sum(wm, dim=-1)
            woff = torch.sum(wm * perp_off, dim=-1) / (wsum + 1e-6)
            wn = wsum / (torch.sum(wsum, dim=-1, keepdim=True) + 1e-6)
            tbar = torch.sum(wn * ts_ref, dim=-1)
            obar = torch.sum(wn * woff, dim=-1)
            tc = ts_ref - tbar[..., None]
            b_fit = torch.sum(wn * tc * (woff - obar[..., None]), dim=-1) / (
                torch.sum(wn * tc * tc, dim=-1) + 1e-6)
            a_fit = obar - b_fit * tbar
        return p0 + nrm * a_fit[..., None], p1 + nrm * (a_fit + b_fit)[..., None]

    p0, p1 = refit(p0, p1)

    ok = valid & (length >= 12.0) & (supported / torch.clamp(length, min=1.0) > 0.75)
    lim = torch.tensor([w - 1, h - 1], dtype=torch.float32, device=dev)
    p0 = torch.minimum(torch.clamp(p0, min=0.0), lim)
    p1 = torch.minimum(torch.clamp(p1, min=0.0), lim)
    d01 = p1 - p0
    theta = torch.remainder(torch.atan2(d01[..., 1], d01[..., 0]), math.pi)
    length = torch.sqrt(torch.sum(d01 * d01, dim=-1))
    return DetectedLines(p0=p0, p1=p1, angle=theta, length=length, response=supported, valid=ok)


def merge_collinear(lines: DetectedLines, ang_tol: float = 0.06, dist_tol: float = 4.0) -> DetectedLines:
    """Suppress duplicate detections of one physical segment: of every
    pair with similar angle, nearby infinite lines and overlapping extent,
    keep the longer (the lower index on equal length).  [..., L] inputs."""
    L = lines.p0.shape[-2]
    ang = lines.angle
    mid = 0.5 * (lines.p0 + lines.p1)
    d = _unit(ang)
    n = torch.stack([-torch.sin(ang), torch.cos(ang)], dim=-1)
    dang = torch.abs(torch.remainder(ang[..., :, None] - ang[..., None, :] + math.pi / 2, math.pi) - math.pi / 2)
    dm = mid[..., None, :, :] - mid[..., :, None, :]
    perp = torch.abs(torch.sum(dm * n[..., :, None, :], dim=-1))
    along = torch.abs(torch.sum(dm * d[..., :, None, :], dim=-1))
    ln = lines.length
    overlap = along < 0.6 * (ln[..., :, None] + ln[..., None, :])
    dup = (dang < ang_tol) & (perp < dist_tol) & overlap
    dup = dup & lines.valid[..., :, None] & lines.valid[..., None, :]
    idx = torch.arange(L, device=ang.device)
    better = (ln[..., None, :] > ln[..., :, None]) | (
        (ln[..., None, :] == ln[..., :, None]) & (idx[None, :] < idx[:, None]))
    suppressed = torch.any(dup & better, dim=-1)
    return lines._replace(valid=lines.valid & ~suppressed)
