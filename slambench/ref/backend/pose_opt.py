# Frozen copy of orb_line_slam_tpu_torch/backend/pose_opt.py at commit d30c4f7 (the benchmark's plain reference).
"""Motion-only bundle adjustment (the per-frame pose solve), plain version.

``rounds`` rounds of ``iters`` LM iterations on one SE3 vertex with point
edges and optional line edges, Huber on the first two rounds, chi2 gating
after every round (points 5.991 mono / 7.815 stereo, lines 5.991).  The
program launches a kernel for this on the card; the reference runs these
plain torch operations on any device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import CameraIntrinsics
from ..geometry.se3 import se3_compose, se3_exp
from .residuals import (
    inv_level_sigma2, line_residual_and_jacobian, point_residual, point_residual_and_jacobians,
)
from .robust import CHI2_MONO, CHI2_STEREO, huber_weight


class PoseOptResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor       # bool [M] point inliers
    line_inliers: torch.Tensor  # bool [L] ([0] without lines)
    n_inliers: torch.Tensor     # int32 scalar (points + lines)


def solve_args(R0, t0, points_w, obs_uvur, octave, valid, cam: CameraIntrinsics, scale_factor: float = 1.2,
               line_start_w=None, line_end_w=None, line_obs=None, line_octave=None, line_valid=None) -> tuple:
    """``pose_optimize``'s arguments as the operator takes them: (R0, t0,
    points, obs, p_info, valid, line_start, line_end, line_obs, l_info,
    l_valid, fx, fy, cx, cy, bf), the information weights precomputed;
    without lines the five line tensors have L = 0 rows."""
    p_info = inv_level_sigma2(octave, scale_factor)
    if line_start_w is None:
        dev, dt = points_w.device, points_w.dtype
        e3 = torch.empty((0, 3), dtype=dt, device=dev)
        lines = (e3, e3, e3, torch.empty(0, dtype=dt, device=dev), torch.empty(0, dtype=torch.bool, device=dev))
    else:
        lines = (line_start_w, line_end_w, line_obs, inv_level_sigma2(line_octave, scale_factor), line_valid)
    return (R0, t0, points_w, obs_uvur, p_info, valid, *lines,
            float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy), float(cam.bf))


def pose_solve_plain(R0, t0, points_w, obs_uvur, p_info, valid, line_start_w, line_end_w, line_obs, l_info,
                     line_valid, fx: float, fy: float, cx: float, cy: float, bf: float, rounds: int, iters: int,
                     round_masks: list | None = None):
    """Plain torch version of one solve.  Returns (R, t, point inliers,
    line inliers, n_inliers int32, steps uint8 [rounds * iters]: 1 where
    the LM step was accepted).  A ``round_masks`` list receives the
    (point, line) inlier masks each round starts from."""
    cam = CameraIntrinsics(fx, fy, cx, cy, bf)
    dev, dt_ = points_w.device, points_w.dtype
    has_lines = line_start_w.shape[0] > 0
    is_stereo = obs_uvur[:, 2] > 0
    chi2_th = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    eye6 = torch.eye(6, dtype=dt_, device=dev)
    zero = torch.zeros((), dtype=dt_, device=dev)
    steps = []

    def chi2(R, t):
        r = point_residual(cam, R, t, points_w, obs_uvur, is_stereo)
        c_p = torch.sum(r * r, dim=-1) * p_info
        if not has_lines:
            return c_p, None
        rl, _ = line_residual_and_jacobian(cam, R, t, line_start_w, line_end_w, line_obs, jacobian=False)
        return c_p, torch.sum(rl * rl, dim=-1) * l_info

    def lm_round(R, t, p_in, l_in, use_huber: bool):
        lam = torch.tensor(1e-3, dtype=dt_, device=dev)
        for _ in range(iters):
            r, Jc, _ = point_residual_and_jacobians(cam, R, t, points_w, obs_uvur, is_stereo)
            c = torch.sum(r * r, dim=-1) * p_info
            hw = huber_weight(c, CHI2_STEREO) if use_huber else torch.ones_like(c)
            w = torch.where(p_in, hw * p_info, zero)
            JtW = Jc.transpose(-1, -2) * w[:, None, None]          # [M, 6, 3]
            H = torch.einsum("mid,mdj->ij", JtW, Jc)
            g = torch.einsum("mid,md->i", JtW, r)
            err0 = torch.sum(torch.where(p_in, c * hw, zero))
            if has_lines:
                rl, Jl = line_residual_and_jacobian(cam, R, t, line_start_w, line_end_w, line_obs)
                cl = torch.sum(rl * rl, dim=-1) * l_info
                wl = huber_weight(cl, CHI2_MONO) * l_info if use_huber else l_info
                wl = torch.where(l_in, wl, zero)
                JltW = Jl.transpose(-1, -2) * wl[:, None, None]    # [L, 6, 2]
                H = H + torch.einsum("lid,ldj->ij", JltW, Jl)
                g = g + torch.einsum("lid,ld->i", JltW, rl)
                err0 = err0 + torch.sum(torch.where(l_in, cl, zero))
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-8 * eye6
            xi = -torch.linalg.solve_ex(Hd, g)[0]
            dR, dt = se3_exp(xi)
            R2, t2 = se3_compose(dR, dt, R, t)
            c2, cl2 = chi2(R2, t2)
            hw2 = huber_weight(c2, CHI2_STEREO) if use_huber else torch.ones_like(c2)
            err1 = torch.sum(torch.where(p_in, c2 * hw2, zero))
            if has_lines:
                err1 = err1 + torch.sum(torch.where(l_in, cl2, zero))
            accept = err1 < err0
            steps.append(accept)
            R = torch.where(accept, R2, R)
            t = torch.where(accept, t2, t)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6)
        return R, t

    R, t = R0, t0
    p_in = valid
    l_in = line_valid if has_lines else torch.zeros_like(line_valid)
    for rnd in range(rounds):
        if round_masks is not None:
            round_masks.append((p_in, l_in))
        R, t = lm_round(R, t, p_in, l_in, use_huber=(rnd < 2))
        c_p, c_l = chi2(R, t)
        p_in = valid & (c_p <= chi2_th)
        if has_lines:
            l_in = line_valid & (c_l <= CHI2_MONO)
    n_in = p_in.sum() + l_in.sum()
    return R, t, p_in, l_in, n_in.to(torch.int32), torch.stack(steps).to(torch.uint8)


def pose_optimize(
    R0: torch.Tensor,
    t0: torch.Tensor,
    points_w: torch.Tensor,   # [M, 3]
    obs_uvur: torch.Tensor,   # [M, 3] (u, v, uR); uR < 0 => mono
    octave: torch.Tensor,     # [M]
    valid: torch.Tensor,      # [M]
    cam: CameraIntrinsics,
    scale_factor: float = 1.2,
    line_start_w: torch.Tensor | None = None,  # [L, 3]
    line_end_w: torch.Tensor | None = None,    # [L, 3]
    line_obs: torch.Tensor | None = None,      # [L, 3] (a, b, c) normalised
    line_octave: torch.Tensor | None = None,   # [L]
    line_valid: torch.Tensor | None = None,    # [L]
    rounds: int = 4,
    iters: int = 10,
) -> PoseOptResult:
    """The plain pose solve on any device."""
    args = solve_args(R0, t0, points_w, obs_uvur, octave, valid, cam, scale_factor,
                      line_start_w, line_end_w, line_obs, line_octave, line_valid)
    return PoseOptResult(*pose_solve_plain(*args, rounds, iters)[:5])
