# Frozen copy of orb_line_slam_tpu_torch/frontend/stereo.py at commit d30c4f7 (the benchmark's plain reference).
"""Stereo matching: row-band Hamming search + SAD sub-pixel refinement.

Port of ``orb_line_slam_tpu/frontend/stereo.py`` — ``stereo_match``
(90-206): candidates in the same row band, ±1 octave and disparity
range; best Hamming match gated at 75 with mutual-best; an 11x11
centre-normalized SAD over a ±5 px slide at the left keypoint's level of
the right atlas (``ops/stereo_sad.py``, with ``_gather_window`` (61-87):
one fused kernel launch per frame, the second after the describe
kernel's); parabola sub-pixel fit; the
median-deviation and distinct-minimum gates; depth = bf / disparity.
The matcher is split where the SAD kernel is called, into the candidate
half and the refinement half; both take B pairs along a leading axis
(the batched front end), so B pairs need one SAD launch, and the SAD
median stays per pair.
``SEP_MARGIN`` and ``CURVE_RATIO`` are constants here (the JAX module
reads them from environment variables, ``stereo.py:52-53``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import CameraIntrinsics, OrbConfig
from ..ops.hamming import hamming_matrix, knn2
from ..ops.stereo_sad import SAD_SLIDE, stereo_sad

TH_STEREO = 75  # (TH_LOW + TH_HIGH)/2
SEP_MARGIN = 0
CURVE_RATIO = 0.8


class StereoMatch(NamedTuple):
    u_right: torch.Tensor  # float32 [N]; -1 when unmatched
    depth: torch.Tensor    # float32 [N]; -1 when unmatched


def nanmedian_linear(x: torch.Tensor) -> torch.Tensor:
    """Median of the non-NaN entries along the last dim of x [..., N],
    with jnp.nanmedian's semantics: the two middle values are averaged
    (``torch.nanmedian`` returns the lower one).  NaN where every entry is
    NaN.  Returns x.shape[:-1]: each row has its own median."""
    n = (~torch.isnan(x)).sum(dim=-1, keepdim=True)
    s = torch.sort(torch.nan_to_num(x, nan=torch.inf), dim=-1).values
    pos = 0.5 * (n - 1).clamp(min=0).to(torch.float32)
    lo = torch.floor(pos)
    w = pos - lo
    lo_i = lo.long()
    hi_i = torch.ceil(pos).long()
    med = s.gather(-1, lo_i) * (1.0 - w) + s.gather(-1, hi_i) * w
    return torch.where(n > 0, med, torch.full_like(med, torch.nan))[..., 0]


MIN_DISP = 0.1


def _max_disp(cam: CameraIntrinsics) -> float:
    return cam.bf / max(2.0 * cam.baseline, 1e-6)


class _Candidates(NamedTuple):
    """The stereo matcher's first half: each left feature's best right
    feature and where the SAD window sits ([..., N] each)."""

    matched: torch.Tensor   # bool: Hamming, mutual-best and separation gates
    sc: torch.Tensor        # float32 level scale of the left feature
    xr0: torch.Tensor       # float32 floored right x at that level
    cy: torch.Tensor        # float32 right atlas row of the window centre


def _candidates(featL, featR, offsR, cam: CameraIntrinsics, orb_cfg: OrbConfig) -> _Candidates:
    """Row-band, octave and disparity-gated best Hamming match of every
    left feature ([..., N] features; leading dims are independent pairs)."""
    dev = featL.xy.device
    scales = torch.tensor(orb_cfg.level_scales, dtype=torch.float32, device=dev)
    uL, vL = featL.xy[..., 0], featL.xy[..., 1]
    uR, vR = featR.xy[..., 0], featR.xy[..., 1]
    octL, octR = featL.octave.long(), featR.octave.long()

    dist = hamming_matrix(featL.desc, featR.desc)
    band = 2.0 * scales[octR]
    row_ok = torch.abs(vL[..., :, None] - vR[..., None, :]) <= band[..., None, :]
    oct_ok = torch.abs(octL[..., :, None] - octR[..., None, :]) <= 1
    disp = uL[..., :, None] - uR[..., None, :]
    disp_ok = (disp > MIN_DISP) & (disp < _max_disp(cam))
    valid = row_ok & oct_ok & disp_ok & featR.valid[..., None, :] & featL.valid[..., :, None]

    best_idx, best_d, second_d = knn2(dist, valid)
    best_idx = best_idx.long()
    dist_m = torch.where(valid, dist, torch.full_like(dist, 512))
    col_best = torch.argmin(dist_m, dim=-2)
    mutual = col_best.gather(-1, best_idx) == torch.arange(dist.shape[-2], device=dev)
    separated = best_d + SEP_MARGIN <= second_d
    matched = (best_d < TH_STEREO) & mutual & separated

    sc = scales[octL]
    xr0 = torch.floor(uR.gather(-1, best_idx) / sc)
    yl = torch.round(vL / sc)
    return _Candidates(matched=matched, sc=sc, xr0=xr0, cy=yl + offsR[octL].to(torch.float32))


def _refine(featL, deltaL, cand: _Candidates, sad: torch.Tensor, cam: CameraIntrinsics) -> StereoMatch:
    """Parabola sub-pixel fit on the [..., N, 11] SADs, the SAD-median and
    curvature gates (the median taken per pair) and depth = bf / disparity."""
    n_off = sad.shape[-1]
    sc, xr0, matched = cand.sc, cand.xr0, cand.matched

    best_k = torch.argmin(sad, dim=-1)
    s0 = sad.gather(-1, torch.clamp(best_k - 1, 0, n_off - 1)[..., None])[..., 0]
    s1 = sad.gather(-1, best_k[..., None])[..., 0]
    s2 = sad.gather(-1, torch.clamp(best_k + 1, 0, n_off - 1)[..., None])[..., 0]
    denom = s0 + s2 - 2.0 * s1
    delta = torch.where(torch.abs(denom) > 1e-6, (s0 - s2) / (2.0 * denom), torch.zeros_like(denom))
    interior = (best_k > 0) & (best_k < n_off - 1) & (torch.abs(delta) <= 1.0)

    uL = featL.xy[..., 0]
    xl_int = uL / sc - deltaL[..., 0]
    xr_m = xr0 + (best_k - SAD_SLIDE).to(torch.float32) + delta
    disparity = (xl_int - xr_m) * sc
    u_right = uL - disparity
    geom_ok = (disparity > MIN_DISP) & (disparity < _max_disp(cam))

    med = nanmedian_linear(torch.where(matched, s1, torch.full_like(s1, torch.nan)))[..., None]
    med = torch.where(torch.isnan(med), torch.full_like(med, torch.inf), med)
    sad_ok = s1 <= 2.1 * med
    curve_ok = s1 <= CURVE_RATIO * torch.minimum(sad[..., 0], sad[..., -1]) + 1e-3

    ok = matched & interior & geom_ok & sad_ok & curve_ok & featL.valid
    neg = torch.full_like(u_right, -1.0)
    depth = torch.where(ok, cam.bf / torch.clamp(disparity, min=MIN_DISP), neg)
    return StereoMatch(u_right=torch.where(ok, u_right, neg), depth=depth)


def stereo_match(featL, featR, atlasL, axyL, deltaL, atlasR, offsR, cam: CameraIntrinsics,
                 orb_cfg: OrbConfig) -> StereoMatch:
    """Stereo association of left features to right features (see module
    docstring).  atlasL/axyL: left pyramid atlas and the keypoints' int32
    [N, 2] atlas coordinates (in place of the JAX package's tilesL);
    deltaL: their sub-pixel offsets; atlasR/offsR: right pyramid atlas and
    level row offsets.  B pairs at once take a leading [B] on every input
    but offsR and give one on each output: both halves run on the batch,
    around one ``stereo_sad`` call."""
    cand = _candidates(featL, featR, offsR, cam, orb_cfg)
    sad = stereo_sad(atlasL, axyL, atlasR, cand.xr0.contiguous(), cand.cy.contiguous())   # [..., N, 11]
    return _refine(featL, deltaL, cand, sad, cam)
