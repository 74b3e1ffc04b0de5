# Frozen copy of orb_line_slam_tpu_torch/matching/line_matcher.py at commit d30c4f7 (the benchmark's plain reference).
"""Line matching: LBD Hamming distances with geometric gates.

Port of ``orb_line_slam_tpu/matching/line_matcher.py:20-90``:
frame-to-frame matching (``match_lines``: angle, midpoint distance and
length-ratio gates) and the projection search of 3D map segments into a
frame (``search_lines_by_projection``), both on the port's
``hamming_matrix`` and ``knn2`` (ties to the lower index) with the
ratio test.  ``jnp.mod`` floors, as ``torch.remainder`` does.
"""

from __future__ import annotations

import math

import torch

from ..config import CameraIntrinsics
from ..geometry.camera import project
from ..geometry.se3 import se3_apply
from ..ops.hamming import hamming_matrix, knn2
from .point_matcher import Matches


def _angle_diff(a, b):
    return torch.abs(torch.remainder(a - b + math.pi / 2, math.pi) - math.pi / 2)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1))


def _ratio_ok(d1, d2, max_dist: int, ratio: float):
    return (d1 < max_dist) & (d1.to(torch.float32) < ratio * d2.to(torch.float32))


def match_lines(lf_a, lf_b, max_dist: int = 80, ratio: float = 0.85, ang_tol: float = 0.2,
                mid_radius: float = 60.0) -> Matches:
    """Frame-to-frame line matching (rows = lines of a)."""
    dist = hamming_matrix(lf_a.desc, lf_b.desc)
    dang = _angle_diff(lf_a.angle[:, None], lf_b.angle[None, :])
    mid_a = 0.5 * (lf_a.p0 + lf_a.p1)
    mid_b = 0.5 * (lf_b.p0 + lf_b.p1)
    dm = _norm(mid_a[:, None] - mid_b[None, :])
    len_ratio = torch.minimum(lf_a.length[:, None], lf_b.length[None, :]) / (
        torch.maximum(lf_a.length[:, None], lf_b.length[None, :]) + 1e-6)
    gate = (dang < ang_tol) & (dm < mid_radius) & (len_ratio > 0.5) & lf_b.valid[None, :]
    idx, d1, d2 = knn2(dist, gate)
    ok = lf_a.valid & _ratio_ok(d1, d2, max_dist, ratio)
    return Matches(torch.where(ok, idx, torch.full_like(idx, -1)), d1, ok)


def search_lines_by_projection(start_w, end_w, desc_m, valid_m, Rcw, tcw, lf, cam: CameraIntrinsics,
                               mid_radius: float = 40.0, ang_tol: float = 0.25, max_dist: int = 96,
                               ratio: float = 0.9) -> Matches:
    """Project 3D map segments [M, 3] into the frame at (Rcw, tcw) and
    match them to its 2D lines (rows = map segments)."""
    s_c = se3_apply(Rcw, tcw, start_w)
    e_c = se3_apply(Rcw, tcw, end_w)
    in_front = (s_c[:, 2] > 0.1) & (e_c[:, 2] > 0.1)
    s_uv = project(cam, s_c)
    e_uv = project(cam, e_c)
    mid = 0.5 * (s_uv + e_uv)
    in_img = (mid[:, 0] >= 0) & (mid[:, 0] < cam.width) & (mid[:, 1] >= 0) & (mid[:, 1] < cam.height)
    d = e_uv - s_uv
    ang = torch.remainder(torch.atan2(d[:, 1], d[:, 0]), math.pi)
    dist = hamming_matrix(desc_m, lf.desc)
    dang = _angle_diff(ang[:, None], lf.angle[None, :])
    mid_f = 0.5 * (lf.p0 + lf.p1)
    dm = _norm(mid[:, None] - mid_f[None, :])
    gate = (dang < ang_tol) & (dm < mid_radius) & lf.valid[None, :]
    idx, d1, d2 = knn2(dist, gate)
    ok = valid_m & in_front & in_img & _ratio_ok(d1, d2, max_dist, ratio)
    return Matches(torch.where(ok, idx, torch.full_like(idx, -1)), d1, ok)
