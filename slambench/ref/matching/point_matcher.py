# Frozen copy of orb_line_slam_tpu_torch/matching/point_matcher.py at commit d30c4f7 (the benchmark's plain reference).
"""Point matching as dense masked Hamming matrices.

Port of ``orb_line_slam_tpu/matching/point_matcher.py`` —
``rotation_consistency`` (39-56), ``match_descriptors`` (59-77),
``predict_scale`` (80-87), ``search_by_projection`` (90-182),
``search_by_sim3_dir`` (188-225), ``resolve_duplicates`` (228-245) and
``match_in_window`` (249-269): distance matrix + geometric mask +
best/second-best + ratio test + 30-bin rotation histogram, with the
reference's thresholds.  Leading batch dims are not supported; callers
loop over the few keyframe pairs.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import CameraIntrinsics
from ..geometry.camera import project, project_stereo
from ..geometry.se3 import se3_apply
from ..ops.hamming import TH_HIGH, TH_LOW, hamming_matrix, knn2

HISTO_BINS = 30


class Matches(NamedTuple):
    """Per-row match into the 'other' set; -1 where unmatched."""

    idx: torch.Tensor   # int32 [M]
    dist: torch.Tensor  # int32 [M]
    mask: torch.Tensor  # bool [M]


def _neg1(idx: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    return torch.where(ok, idx, torch.full_like(idx, -1))


def rotation_consistency(angle_a: torch.Tensor, angle_b_matched: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Keep matches whose angle difference falls in the 3 dominant 30-bin
    histogram bins holding >= 10% of the best bin (ComputeThreeMaxima)."""
    diff = torch.remainder((angle_a - angle_b_matched) * (180.0 / math.pi), 360.0)
    bins = torch.clamp((diff * HISTO_BINS / 360.0).to(torch.int32), 0, HISTO_BINS - 1).long()
    counts = torch.zeros(HISTO_BINS, dtype=torch.int64, device=mask.device).index_add(0, bins, mask.to(torch.int64))
    top3 = torch.sort(counts, descending=True).values[:3]
    good_bin = (counts >= top3[2]) & (counts * 10 >= top3[0]) & (counts > 0)
    return mask & good_bin[bins]


def match_descriptors(desc_a, valid_a, desc_b, valid_b, max_dist: int = TH_LOW,
                      ratio: float = 0.9, extra_mask=None) -> Matches:
    """Brute-force matching with the best/second ratio test."""
    dist = hamming_matrix(desc_a, desc_b)
    cols = valid_b[None, :]
    if extra_mask is not None:
        cols = cols & extra_mask
    idx, d1, d2 = knn2(dist, cols)
    ok = valid_a & (d1 < max_dist) & (d1.to(torch.float32) < ratio * d2.to(torch.float32))
    return Matches(_neg1(idx, ok), d1, ok)


def predict_scale(dist, max_dist_p, n_levels: int, scale_factor: float) -> torch.Tensor:
    """Expected octave at viewing distance `dist` (MapPoint::PredictScale)."""
    ratio = torch.clamp(max_dist_p, min=1e-6) / torch.clamp(dist, min=1e-6)
    oct_f = torch.ceil(torch.log(ratio) / math.log(scale_factor))
    return torch.clamp(oct_f, 0, n_levels - 1).to(torch.int32)


def search_by_projection(
    points_w, desc_p, valid_p, octave_p, Rcw, tcw, frame,
    cam: CameraIntrinsics, level_scales, radius: float,
    max_dist: int = TH_HIGH, ratio: float = 1.0, check_ur: bool = False,
    max_dist_p=None, min_dist_p=None, normal_p=None, oct_tol: int = 1,
) -> Matches:
    """Project landmarks [M] into `frame` at (Rcw, tcw) and match each to
    the best frame keypoint within a scale-adapted pixel window
    (SearchByProjection).  With max_dist_p the octave is predicted from
    the viewing distance; min_dist_p/normal_p gate the distance range
    and a 60-degree view cone.  Returns per-landmark Matches."""
    dev = points_w.device
    scales = torch.tensor(level_scales, dtype=torch.float32, device=dev)
    n_levels = len(level_scales)
    scale_factor = float(level_scales[1] / level_scales[0]) if n_levels > 1 else 1.2
    xc = se3_apply(Rcw, tcw, points_w)
    obs = project_stereo(cam, xc)
    in_front = xc[:, 2] > 0.1
    in_img = (obs[:, 0] >= 0) & (obs[:, 0] < cam.width) & (obs[:, 1] >= 0) & (obs[:, 1] < cam.height)
    dist_ok = torch.ones_like(in_front)
    view_ok = torch.ones_like(in_front)
    if max_dist_p is not None:
        cam_center = -(Rcw.T @ tcw)
        view = points_w - cam_center
        dist = torch.linalg.norm(view, dim=-1)
        octave_p = predict_scale(dist, max_dist_p, n_levels, scale_factor)
        if min_dist_p is not None:
            dist_ok = (dist >= 0.8 * min_dist_p) & (dist <= 1.2 * max_dist_p)
        if normal_p is not None:
            view_ok = torch.sum(view * normal_p, dim=-1) / torch.clamp(dist, min=1e-6) > 0.5
    octave_p = octave_p.long()
    r = radius * scales[torch.clamp(octave_p, 0, n_levels - 1)]

    du = obs[:, 0:1] - frame.xy[None, :, 0]
    dv = obs[:, 1:2] - frame.xy[None, :, 1]
    close = (du * du + dv * dv) <= (r * r)[:, None]
    oct_ok = torch.abs(frame.octave[None, :].long() - octave_p[:, None]) <= oct_tol
    col_mask = close & oct_ok & frame.valid[None, :]
    if check_ur:
        dur = torch.abs(obs[:, 2:3] - frame.u_right[None, :])
        col_mask &= (frame.u_right[None, :] < 0) | (dur <= r[:, None])
    idx, d1, d2 = knn2(hamming_matrix(desc_p, frame.desc), col_mask)
    ok = (
        valid_p & in_front & in_img & dist_ok & view_ok
        & (d1 < max_dist)
        & (d1.to(torch.float32) <= ratio * d2.to(torch.float32))
    )
    return Matches(_neg1(idx, ok), d1, ok)


def search_by_sim3_dir(
    pts_in_dst,   # [M, 3] source landmarks in the destination camera frame
    desc_src,     # [M, 32]
    valid_src,    # [M]
    xy_dst,       # [N, 2] destination keypoints
    desc_dst,     # [N, 32]
    oct_dst,      # [N]
    valid_dst,    # [N]
    cam: CameraIntrinsics, level_scales, radius: float = 7.5, max_dist: int = TH_HIGH,
) -> Matches:
    """One direction of SearchBySim3: project the source keyframe's
    landmarks (already moved by the current Sim3 into the destination
    camera frame) and match within a pixel window scaled by the
    destination keypoint's level, Hamming <= max_dist, no ratio test.
    The caller runs both directions and keeps the mutual pairs."""
    scales = torch.tensor(level_scales, dtype=torch.float32, device=pts_in_dst.device)
    uv = project(cam, pts_in_dst)
    ok_src = (
        valid_src & (pts_in_dst[:, 2] > 0.05)
        & (uv[:, 0] >= 0) & (uv[:, 0] < cam.width) & (uv[:, 1] >= 0) & (uv[:, 1] < cam.height)
    )
    du = uv[:, 0:1] - xy_dst[None, :, 0]
    dv = uv[:, 1:2] - xy_dst[None, :, 1]
    r = radius * scales[torch.clamp(oct_dst.long(), 0, len(level_scales) - 1)]
    close = (du * du + dv * dv) <= (r * r)[None, :]
    idx, d1, _ = knn2(hamming_matrix(desc_src, desc_dst), close & valid_dst[None, :])
    ok = ok_src & (d1 <= max_dist)
    return Matches(_neg1(idx, ok), d1, ok)


def resolve_duplicates(matches: Matches, n_targets: int) -> Matches:
    """Keep only the lowest-distance row per target keypoint; ties go to
    the first row claiming it."""
    dev = matches.idx.device
    big = 1 << 20
    tgt = torch.where(matches.mask, matches.idx, torch.full_like(matches.idx, n_targets)).long()
    best = torch.full((n_targets + 1,), big, dtype=matches.dist.dtype, device=dev)
    best = best.scatter_reduce(0, tgt, matches.dist, reduce="amin")
    keep = matches.mask & (matches.dist <= best[tgt])
    order = torch.arange(matches.idx.shape[0], dtype=torch.int64, device=dev)
    first = torch.full((n_targets + 1,), big, dtype=torch.int64, device=dev)
    first = first.scatter_reduce(0, torch.where(keep, tgt, n_targets), order, reduce="amin")
    keep = keep & (first[tgt] == order)
    return Matches(_neg1(matches.idx, keep), matches.dist, keep)


def match_in_window(frame_a, frame_b, radius: float = 100.0, max_dist: int = TH_LOW,
                    ratio: float = 0.9) -> Matches:
    """Frame-to-frame matching windowed around each keypoint's own location
    (``point_matcher.py:249-269``, SearchForInitialization: the window keeps
    the ratio test from drowning in far-away confusers)."""
    dist = hamming_matrix(frame_a.desc, frame_b.desc)
    du = frame_a.xy[:, 0:1] - frame_b.xy[None, :, 0]
    dv = frame_a.xy[:, 1:2] - frame_b.xy[None, :, 1]
    close = (du * du + dv * dv) <= radius * radius
    idx, d1, d2 = knn2(dist, close & frame_b.valid[None, :])
    ok = frame_a.valid & (d1 < max_dist) & (d1.to(torch.float32) < ratio * d2.to(torch.float32))
    return Matches(_neg1(idx, ok), d1, ok)
