"""Sim3 relative-pose refinement (g2o OptimizeSim3 equivalent).

Port of ``orb_line_slam_tpu/backend/sim3_opt.py:53-140``
(``optimize_sim3``): given matched landmark pairs between two keyframes
and an initial Sim3 ``T_12`` (mapping frame-2 camera coordinates into
frame 1), minimize the bidirectional reprojection error

    e1_i = obs1_i - project(cam1, S_12    . p2_i)
    e2_i = obs2_i - project(cam2, S_12^-1 . p1_i)

over the 7-DoF Sim3 tangent (scale frozen when ``fix_scale``): two
fixed Gauss-Newton phases (5 + 5) with IRLS Huber weights, a chi2 = 10
outlier gate in between, a guard that weights out non-finite rows,
trace-scaled damping and rejection of a diverging step.  The Jacobians
are forward-mode derivatives through ``sim3_retract``
(``torch.func.jacfwd``), as the JAX package takes them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import CameraIntrinsics
from ..geometry.camera import project
from ..geometry.sim3 import sim3_inverse, sim3_retract
from ..utils.worker import FORWARD_AD_LOCK


class Sim3OptResult(NamedTuple):
    s: torch.Tensor          # scalar
    R: torch.Tensor          # [3, 3]
    t: torch.Tensor          # [3]
    inliers: torch.Tensor    # [N] bool
    n_inliers: torch.Tensor  # scalar int32


def _residuals(s, R, t, pts1, pts2, obs1, obs2, cam1, cam2):
    p2in1 = s * (pts2 @ R.T) + t
    e1 = obs1 - project(cam1, p2in1)
    si, Ri, ti = sim3_inverse(s, R, t)
    p1in2 = si * (pts1 @ Ri.T) + ti
    e2 = obs2 - project(cam2, p1in2)
    return e1, e2, p2in1[..., 2], p1in2[..., 2]


def sim3_residual_jacobian(s, R, t, pts1, pts2, obs1, obs2, cam1, cam2):
    """(r [2N, 2], J [2N, 2, 7]) of the stacked residuals (e1; e2) with
    respect to the tangent xi of ``sim3_retract(s, R, t, xi)`` at xi = 0."""

    def resid_flat(xi):
        s2, R2, t2 = sim3_retract(s, R, t, xi)
        e1, e2, _, _ = _residuals(s2, R2, t2, pts1, pts2, obs1, obs2, cam1, cam2)
        return torch.cat([e1, e2], dim=0)

    xi0 = torch.zeros(7, dtype=pts1.dtype, device=pts1.device)
    with FORWARD_AD_LOCK:
        J = torch.func.jacfwd(resid_flat)(xi0)
    return resid_flat(xi0), J


def optimize_sim3(
    s0: torch.Tensor,        # initial scale (scalar)
    R0: torch.Tensor,        # [3, 3]
    t0: torch.Tensor,        # [3]
    pts1: torch.Tensor,      # [N, 3] landmark positions in camera-1 frame
    pts2: torch.Tensor,      # [N, 3] matched positions in camera-2 frame
    obs1: torch.Tensor,      # [N, 2] measured keypoints in image 1
    obs2: torch.Tensor,      # [N, 2] measured keypoints in image 2
    sigma2_1: torch.Tensor,  # [N] per-match pixel variance in image 1
    sigma2_2: torch.Tensor,  # [N]
    valid: torch.Tensor,     # [N]
    cam1: CameraIntrinsics,
    cam2: CameraIntrinsics,
    fix_scale: bool = True,
    iters1: int = 5,
    iters2: int = 5,
    th2: float = 10.0,
) -> Sim3OptResult:
    dt_, dev = pts1.dtype, pts1.device
    w1 = 1.0 / torch.clamp(sigma2_1, min=1e-8)
    w2 = 1.0 / torch.clamp(sigma2_2, min=1e-8)
    inf = torch.full((), float("inf"), dtype=dt_, device=dev)
    zero = torch.zeros((), dtype=dt_, device=dev)
    eye7 = torch.eye(7, dtype=dt_, device=dev)

    def chi2(s, R, t):
        e1, e2, z1, z2 = _residuals(s, R, t, pts1, pts2, obs1, obs2, cam1, cam2)
        bad = (z1 <= 0.05) | (z2 <= 0.05)
        c1 = torch.where(bad, inf, torch.sum(e1 * e1, -1) * w1)
        c2 = torch.where(bad, inf, torch.sum(e2 * e2, -1) * w2)
        return c1, c2

    def total(s, R, t, mask):
        c1, c2 = chi2(s, R, t)
        return torch.sum(torch.where(mask > 0, c1 + c2, zero))

    def gn_step(s, R, t, mask):
        r, J = sim3_residual_jacobian(s, R, t, pts1, pts2, obs1, obs2, cam1, cam2)
        w = torch.cat([w1 * mask, w2 * mask], 0)                     # [2N]
        # Huber kernel of width sqrt(th2) on both edge directions, as IRLS.
        chi_row = torch.sqrt(torch.sum(r * r, -1) * torch.clamp(w, min=1e-12))
        w = w * torch.clamp(math.sqrt(th2) / torch.clamp(chi_row, min=1e-6), max=1.0)
        # Rows that are not finite (a point behind a camera under the
        # current iterate) are weighted out instead of poisoning H.
        row_ok = torch.isfinite(r).all(-1) & torch.isfinite(J.reshape(J.shape[0], -1)).all(-1)
        w = torch.where(row_ok, w, zero)
        r = torch.where(row_ok[:, None], r, zero)
        J = torch.where(row_ok[:, None, None], J, zero)
        H = torch.einsum("nrk,n,nrl->kl", J, w, J)
        g = torch.einsum("nrk,n,nr->k", J, w, r)
        if fix_scale:
            # Freeze the scale coordinate: unit row/col, zero gradient.
            H = H.clone()
            H[6, :] = 0.0
            H[:, 6] = 0.0
            H[6, 6] = 1.0
            g = g.clone()
            g[6] = 0.0
        H = H + 1e-6 * torch.trace(H) / 7.0 * eye7
        dx = -torch.linalg.solve(H, g)
        s2, R2, t2 = sim3_retract(s, R, t, dx)
        # Reject a diverging step.
        c_old = total(s, R, t, mask)
        c_new = total(s2, R2, t2, mask)
        take = torch.isfinite(c_new) & (c_new <= c_old)
        return torch.where(take, s2, s), torch.where(take, R2, R), torch.where(take, t2, t)

    s, R, t = torch.as_tensor(s0, dtype=dt_, device=dev), R0, t0
    mask0 = valid.to(dt_)
    for _ in range(iters1):
        s, R, t = gn_step(s, R, t, mask0)
    c1, c2 = chi2(s, R, t)
    inl = valid & (c1 < th2) & (c2 < th2)
    mask1 = inl.to(dt_)
    for _ in range(iters2):
        s, R, t = gn_step(s, R, t, mask1)
    c1, c2 = chi2(s, R, t)
    inl = inl & (c1 < th2) & (c2 < th2)
    return Sim3OptResult(s, R, t, inl, inl.sum().to(torch.int32))
