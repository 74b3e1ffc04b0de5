"""Sim3 estimation: Horn closed-form alignment inside batched RANSAC.

Port of ``orb_line_slam_tpu/backend/sim3_solver.py:51-95``
(``solve_sim3_ransac``): 3-point Horn similarity between matched 3D
point sets, scale free (mono) or fixed to 1 (stereo), every hypothesis
solved and scored at once by the symmetric reprojection gate
``9.21 * sigma2``.  ``horn_alignment`` is ``backend/pnp.py``'s (EPnP
uses it too).  The hypotheses are the JAX package's own draw,
``jax.random.choice(PRNGKey(seed), N, (n_hyps, 3), replace=True, p=p)``,
index for index (``backend/pnp.py::draw_hypotheses``).
"""

from __future__ import annotations

import torch

from ..config import CameraIntrinsics
from ..geometry.camera import project
from .pnp import draw_hypotheses, horn_alignment

__all__ = ["horn_alignment", "solve_sim3_ransac"]


def solve_sim3_ransac(
    pts1: torch.Tensor,      # [N, 3] points in frame-1 camera coords
    pts2: torch.Tensor,      # [N, 3] matched points in frame-2 camera coords
    valid: torch.Tensor,     # [N]
    seed: int,               # the JAX package's PRNGKey(seed)
    cam1: CameraIntrinsics,
    cam2: CameraIntrinsics,
    sigma2_1: torch.Tensor,  # [N] per-match max reproj chi2 in image 1
    sigma2_2: torch.Tensor,  # [N]
    fix_scale: bool = True,
    n_hyps: int = 256,
):
    """Batched RANSAC Sim3: returns (s, R, t) of T_12 (maps 2->1 coords),
    per-match inlier mask, and inlier count.  Ties in the inlier count
    go to the first hypothesis."""
    idx = draw_hypotheses(valid, seed, n_hyps, 3)
    s, R, t = horn_alignment(pts1[idx], pts2[idx], fix_scale)        # batched over H

    # Score: symmetric reprojection error.
    p2in1 = s[:, None, None] * torch.einsum("hij,nj->hni", R, pts2) + t[:, None, :]
    e1 = torch.sum((project(cam1, p2in1) - project(cam1, pts1)[None]) ** 2, dim=-1)
    s_i = 1.0 / s
    R_i = R.transpose(-1, -2)
    t_i = -s_i[:, None] * torch.einsum("hij,hj->hi", R_i, t)
    p1in2 = s_i[:, None, None] * torch.einsum("hij,nj->hni", R_i, pts1) + t_i[:, None, :]
    e2 = torch.sum((project(cam2, p1in2) - project(cam2, pts2)[None]) ** 2, dim=-1)
    inl = (e1 < 9.21 * sigma2_1[None]) & (e2 < 9.21 * sigma2_2[None]) & valid[None]
    counts = inl.sum(dim=1)
    best = torch.argmax(counts)
    return s[best], R[best], t[best], inl[best], counts[best]
