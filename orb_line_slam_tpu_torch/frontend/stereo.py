"""Stereo matching: row-band Hamming search + SAD sub-pixel refinement.

Port of ``orb_line_slam_tpu/frontend/stereo.py`` — ``stereo_match``
(90-206): candidates in the same row band, ±1 octave and disparity
range; best Hamming match gated at 75 with mutual-best; an 11x11
centre-normalized SAD over a ±5 px slide at the left keypoint's level of
the right atlas (``ops/stereo_sad.py``, with ``_gather_window`` (61-87):
one fused kernel launch per frame, the second after the describe
kernel's); parabola sub-pixel fit; the
median-deviation and distinct-minimum gates; depth = bf / disparity.
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
    """Median of the non-NaN entries of a 1-D tensor with jnp.nanmedian's
    semantics: the two middle values are averaged (``torch.nanmedian``
    returns the lower one).  NaN when every entry is NaN."""
    n = (~torch.isnan(x)).sum()
    s = torch.sort(torch.nan_to_num(x, nan=torch.inf)).values
    pos = 0.5 * (n - 1).clamp(min=0).to(torch.float32)
    lo = torch.floor(pos)
    w = pos - lo
    lo_i = lo.long()
    hi_i = torch.ceil(pos).long()
    med = s[lo_i] * (1.0 - w) + s[hi_i] * w
    return torch.where(n > 0, med, torch.full_like(med, torch.nan))


def stereo_match(featL, featR, atlasL, axyL, deltaL, atlasR, offsR, cam: CameraIntrinsics,
                 orb_cfg: OrbConfig) -> StereoMatch:
    """Stereo association of left features to right features (see module
    docstring).  atlasL/axyL: left pyramid atlas and the keypoints' int32
    [N, 2] atlas coordinates (in place of the JAX package's tilesL);
    deltaL: their sub-pixel offsets; atlasR/offsR: right pyramid atlas and
    level row offsets."""
    dev = featL.xy.device
    scales = torch.tensor(orb_cfg.level_scales, dtype=torch.float32, device=dev)
    uL, vL = featL.xy[:, 0], featL.xy[:, 1]
    uR, vR = featR.xy[:, 0], featR.xy[:, 1]
    octL, octR = featL.octave.long(), featR.octave.long()

    min_disp = 0.1
    max_disp = cam.bf / max(2.0 * cam.baseline, 1e-6)

    dist = hamming_matrix(featL.desc, featR.desc)
    band = 2.0 * scales[octR]
    row_ok = torch.abs(vL[:, None] - vR[None, :]) <= band[None, :]
    oct_ok = torch.abs(octL[:, None] - octR[None, :]) <= 1
    disp = uL[:, None] - uR[None, :]
    disp_ok = (disp > min_disp) & (disp < max_disp)
    valid = row_ok & oct_ok & disp_ok & featR.valid[None, :] & featL.valid[:, None]

    best_idx, best_d, second_d = knn2(dist, valid)
    best_idx = best_idx.long()
    dist_m = torch.where(valid, dist, torch.full_like(dist, 512))
    col_best = torch.argmin(dist_m, dim=0)
    mutual = col_best[best_idx] == torch.arange(dist.shape[0], device=dev)
    separated = best_d + SEP_MARGIN <= second_d
    matched = (best_d < TH_STEREO) & mutual & separated

    sc = scales[octL]
    uR0 = uR[best_idx]
    xr0 = torch.floor(uR0 / sc)
    yl = torch.round(vL / sc)
    cy = yl + offsR[octL].to(torch.float32)

    sad = stereo_sad(atlasL, axyL, atlasR, xr0.contiguous(), cy.contiguous())   # [N, 11]
    n_off = sad.shape[1]

    best_k = torch.argmin(sad, dim=1)
    s0 = sad.gather(1, torch.clamp(best_k - 1, 0, n_off - 1)[:, None])[:, 0]
    s1 = sad.gather(1, best_k[:, None])[:, 0]
    s2 = sad.gather(1, torch.clamp(best_k + 1, 0, n_off - 1)[:, None])[:, 0]
    denom = s0 + s2 - 2.0 * s1
    delta = torch.where(torch.abs(denom) > 1e-6, (s0 - s2) / (2.0 * denom), torch.zeros_like(denom))
    interior = (best_k > 0) & (best_k < n_off - 1) & (torch.abs(delta) <= 1.0)

    xl_int = uL / sc - deltaL[:, 0]
    xr_m = xr0 + (best_k - SAD_SLIDE).to(torch.float32) + delta
    disparity = (xl_int - xr_m) * sc
    u_right = uL - disparity
    geom_ok = (disparity > min_disp) & (disparity < max_disp)

    med = nanmedian_linear(torch.where(matched, s1, torch.full_like(s1, torch.nan)))
    med = torch.where(torch.isnan(med), torch.full_like(med, torch.inf), med)
    sad_ok = s1 <= 2.1 * med
    curve_ok = s1 <= CURVE_RATIO * torch.minimum(sad[:, 0], sad[:, -1]) + 1e-3

    ok = matched & interior & geom_ok & sad_ok & curve_ok & featL.valid
    neg = torch.full_like(u_right, -1.0)
    depth = torch.where(ok, cam.bf / torch.clamp(disparity, min=min_disp), neg)
    return StereoMatch(u_right=torch.where(ok, u_right, neg), depth=depth)
