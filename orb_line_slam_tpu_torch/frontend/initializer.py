"""Monocular map initialization: parallel H/F RANSAC + motion recovery.

Port of ``orb_line_slam_tpu/frontend/initializer.py`` (src/Initializer.cc):
``InitResult`` (27-33), ``_normalize`` (36-41), ``_dlt_homography``
(44-55), ``_eight_point`` (58-69), ``_homography_score`` (72-86),
``_fundamental_score`` (89-105), ``triangulate_two_view`` (107-140),
``_check_rt`` (143-168) and ``initialize_two_view`` (171-287).  The 200
homography (4-point DLT) and 200 fundamental (8-point) hypotheses are
scored as two batches of tensors, the model is chosen by the
reference's RH = SH / (SH + SF) > 0.40 rule, and the four motion
candidates of the chosen model (Faugeras decomposition for H, the
essential decomposition for F) are checked as one batch for cheirality,
reprojection and parallax.  The hypotheses are the JAX package's own
draws: ``jax.random.choice`` from ``key`` for H and from
``jax.random.fold_in(key, 1)`` for F (``backend/pnp.py``).

The null vectors of the 9x9 normal matrices, the rank-2 projection of F
and the two 3x3 decompositions run in float64: a float32 eigensolver's
error depends on the library (LAPACK on the CPU, Jacobi sweeps on the
GPU), the same fragile step ``backend/pnp.py::epnp`` takes in float64.
Everything else is float32, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..backend.assembly import inv33
from ..backend.pnp import draw_hypotheses, fold_in
from ..config import CameraIntrinsics
from .stereo import nanmedian_linear


class InitResult(NamedTuple):
    success: torch.Tensor          # bool scalar
    R: torch.Tensor                # [3, 3] cam2 <- cam1 (world = cam1)
    t: torch.Tensor                # [3] unit-norm translation
    points3d: torch.Tensor         # [N, 3] triangulated (in cam1 frame)
    inliers: torch.Tensor          # [N] bool
    used_homography: torch.Tensor  # bool scalar


def _normalize(pts: torch.Tensor):
    """Hartley normalisation of [N, 2] points: (normalised points, T)."""
    c = pts.mean(dim=0)
    d = torch.linalg.norm(pts - c, dim=1).mean() + 1e-9
    s = torch.sqrt(torch.tensor(2.0, dtype=pts.dtype, device=pts.device)) / d
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    T = torch.stack([
        torch.stack([s, zero, -s * c[0]]),
        torch.stack([zero, s, -s * c[1]]),
        torch.stack([zero, zero, one]),
    ])
    return (pts - c) * s, T


def _null_vector(A: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of A^T A ([..., 9])."""
    return torch.linalg.eigh(A.transpose(-1, -2) @ A)[1][..., :, 0]


def _dlt_homography(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """4+ point DLT of normalised [..., k, 2] points: H [..., 3, 3] with
    p2 ~ H p1 (float64, up to sign)."""
    p1, p2 = p1.double(), p2.double()
    x, y = p1[..., 0], p1[..., 1]
    u, v = p2[..., 0], p2[..., 1]
    z, o = torch.zeros_like(x), torch.ones_like(x)
    rows1 = torch.stack([z, z, z, -x, -y, -o, v * x, v * y, v], dim=-1)
    rows2 = torch.stack([x, y, o, z, z, z, -u * x, -u * y, -u], dim=-1)
    A = torch.cat([rows1, rows2], dim=-2)
    return _null_vector(A).reshape(*A.shape[:-2], 3, 3)


def _eight_point(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """8+ point fundamental matrix of normalised [..., k, 2] points
    (p2^T F p1 = 0), rank 2 enforced (float64, up to sign)."""
    p1, p2 = p1.double(), p2.double()
    x, y = p1[..., 0], p1[..., 1]
    u, v = p2[..., 0], p2[..., 1]
    o = torch.ones_like(x)
    A = torch.stack([u * x, u * y, u, v * x, v * y, v, x, y, o], dim=-1)
    F = _null_vector(A).reshape(*A.shape[:-2], 3, 3)
    U, D, Vt = torch.linalg.svd(F)
    D = torch.cat([D[..., :2], torch.zeros_like(D[..., 2:])], dim=-1)
    return U @ torch.diag_embed(D) @ Vt


def _homog(a: torch.Tensor) -> torch.Tensor:
    return torch.cat([a, torch.ones_like(a[..., :1])], dim=-1)


def _homography_score(H: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor, sigma2: float):
    """Symmetric transfer error score (Initializer::CheckHomography) of
    H [..., 3, 3] on [N, 2] pixel matches: (score [..., N], inliers)."""
    def transfer(H, a, b):
        bh = _homog(a) @ H.transpose(-1, -2)
        w = bh[..., 2:3]
        w = torch.where(torch.abs(w) < 1e-9, torch.full_like(w, 1e-9), w)
        return torch.sum((bh[..., :2] / w - b) ** 2, dim=-1)

    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    Hinv = torch.linalg.inv(H + 1e-12 * eye)
    e12 = transfer(H, p1, p2) / sigma2
    e21 = transfer(Hinv, p2, p1) / sigma2
    th = 5.991
    zero = torch.zeros_like(e12)
    score = torch.where(e12 < th, th - e12, zero) + torch.where(e21 < th, th - e21, zero)
    return score, (e12 < th) & (e21 < th)


def _fundamental_score(F: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor, sigma2: float):
    """Symmetric epipolar distance score (Initializer::CheckFundamental) of
    F [..., 3, 3] on [N, 2] pixel matches: (score [..., N], inliers)."""
    ah, bh = _homog(p1), _homog(p2)
    l2 = ah @ F.transpose(-1, -2)          # lines in image 2
    l1 = bh @ F
    d2 = torch.sum(bh * l2, dim=-1) ** 2 / (l2[..., 0] ** 2 + l2[..., 1] ** 2 + 1e-12)
    d1 = torch.sum(ah * l1, dim=-1) ** 2 / (l1[..., 0] ** 2 + l1[..., 1] ** 2 + 1e-12)
    th, th_score = 3.841, 5.991
    s2, s1 = d2 / sigma2, d1 / sigma2
    zero = torch.zeros_like(s2)
    score = torch.where(s2 < th, th_score - s2, zero) + torch.where(s1 < th, th_score - s1, zero)
    return score, (s1 < th) & (s2 < th)


def triangulate_two_view(R, t, K, p1, p2):
    """Linear triangulation of pixel matches under (I|0) and (R|t):
    R [..., 3, 3], t [..., 3], K [3, 3], p1/p2 [..., N, 2] -> [..., N, 3]
    points in camera-1 frame (inhomogeneous DLT, X4 = 1)."""
    dev, dt = p1.device, p1.dtype
    P1 = K @ torch.cat([torch.eye(3, dtype=dt, device=dev), torch.zeros((3, 1), dtype=dt, device=dev)], dim=1)
    P2 = K @ torch.cat([R, t[..., None]], dim=-1)           # [..., 3, 4]
    P2 = P2[..., None, :, :]                                # broadcast over N
    A = torch.stack(
        [
            p1[..., 0:1] * P1[2] - P1[0],
            p1[..., 1:2] * P1[2] - P1[1],
            p2[..., 0:1] * P2[..., 2, :] - P2[..., 0, :],
            p2[..., 1:2] * P2[..., 2, :] - P2[..., 1, :],
        ],
        dim=-2,
    )                                                       # [..., N, 4, 4]
    A3 = A[..., :3]
    b3 = -A[..., 3]
    M = A3.transpose(-1, -2) @ A3 + 1e-9 * torch.eye(3, dtype=dt, device=dev)
    rhs = (A3.transpose(-1, -2) @ b3[..., None])[..., 0]
    return (inv33(M) @ rhs[..., None])[..., 0]


def _project(pts: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    pr = pts @ K.T
    z = pr[..., 2:]
    return pr[..., :2] / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)


def _check_rt(R, t, K, p1, p2, inl, sigma2: float):
    """Cheirality + reprojection + parallax check of motion candidates
    R [C, 3, 3], t [C, 3] on [N, 2] pixel matches: (n_good [C], points3d
    [C, N, 3], good [C, N], median parallax cosine [C])."""
    C, N = R.shape[0], p1.shape[0]
    pts = triangulate_two_view(R, t, K, p1.expand(C, N, 2), p2.expand(C, N, 2))
    pc2 = pts @ R.transpose(-1, -2) + t[:, None]
    e1 = torch.sum((_project(pts, K) - p1) ** 2, dim=-1)
    e2 = torch.sum((_project(pc2, K) - p2) ** 2, dim=-1)
    c2 = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    r2 = pts - c2[:, None]
    cosp = torch.sum(pts * r2, dim=-1) / (torch.linalg.norm(pts, dim=-1) * torch.linalg.norm(r2, dim=-1) + 1e-12)
    good = (inl & (pts[..., 2] > 0) & (pc2[..., 2] > 0) & (e1 < 4.0 * sigma2) & (e2 < 4.0 * sigma2)
            & (cosp < 0.99998))
    nan = torch.full_like(cosp, torch.nan)
    med = torch.stack([nanmedian_linear(torch.where(good[c], cosp[c], nan[c])) for c in range(C)])
    med = torch.where(torch.isnan(med), torch.ones_like(med), med)
    return good.sum(dim=-1), pts, good, med


def hypothesis_scores(p1_px, p2_px, valid, key, sigma: float = 1.0, n_hyps: int = 200):
    """The H and F RANSAC hypotheses of ``initialize_two_view`` (JAX
    ``initializer.py:182-207``): (sH [n_hyps], Hs [n_hyps, 3, 3], sF, Fs),
    each score the sum over valid matches, each matrix in pixel
    coordinates."""
    sigma2 = sigma * sigma
    idxH = draw_hypotheses(valid, key, n_hyps, 4).long()
    idxF = draw_hypotheses(valid, fold_in(key, 1), n_hyps, 8).long()
    p1n, T1 = _normalize(p1_px)
    p2n, T2 = _normalize(p2_px)
    H = _dlt_homography(p1n[idxH], p2n[idxH]).to(p1_px.dtype)
    Hs = torch.linalg.inv(T2) @ H @ T1
    F = _eight_point(p1n[idxF], p2n[idxF]).to(p1_px.dtype)
    Fs = T2.T @ F @ T1
    zero = torch.zeros((), dtype=p1_px.dtype, device=p1_px.device)
    sH = torch.where(valid, _homography_score(Hs, p1_px, p2_px, sigma2)[0], zero).sum(dim=-1)
    sF = torch.where(valid, _fundamental_score(Fs, p1_px, p2_px, sigma2)[0], zero).sum(dim=-1)
    return sH, Hs, sF, Fs


def _fix_det(R: torch.Tensor) -> torch.Tensor:
    return R * torch.sign(torch.linalg.det(R))[..., None, None]


def _motion_candidates(H: torch.Tensor, F: torch.Tensor, K: torch.Tensor):
    """The four motion candidates of each model (JAX ``initializer.py:
    216-254``), float64: (R_H [4, 3, 3], t_H [4, 3], R_F, t_F)."""
    H, F, K = H.double(), F.double(), K.double()
    # From F: essential decomposition.
    U, _, Vt = torch.linalg.svd(K.T @ F @ K)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=H.dtype, device=H.device)
    R1, R2 = _fix_det(U @ W @ Vt), _fix_det(U @ W.T @ Vt)
    tu = U[:, 2]
    RF = torch.stack([R1, R1, R2, R2])
    tF = torch.stack([tu, -tu, tu, -tu])
    # From H: Faugeras-style candidates from the SVD of K^-1 H K (the
    # four dominant ones of the principal case d1 != d2 != d3).
    Ua, Da, Vat = torch.linalg.svd(torch.linalg.inv(K) @ H @ K)
    d1, d2, d3 = Da[0], Da[1], Da[2]
    s_det = torch.linalg.det(Ua) * torch.linalg.det(Vat)
    x1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / (d1 * d1 - d3 * d3 + 1e-12), min=0))
    x3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / (d1 * d1 - d3 * d3 + 1e-12), min=0))
    sin_t = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0)) / ((d1 + d3) * d2 + 1e-12)
    cos_t = (d2 * d2 + d1 * d3) / ((d1 + d3) * d2 + 1e-12)
    e1 = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=H.dtype, device=H.device)
    e3 = torch.tensor([1.0, -1.0, 1.0, -1.0], dtype=H.dtype, device=H.device)
    st = e1 * e3 * sin_t
    zero, one = torch.zeros_like(st), torch.ones_like(st)
    ct = cos_t.expand(4)
    Rp = torch.stack([torch.stack([ct, zero, -st], -1), torch.stack([zero, one, zero], -1),
                      torch.stack([st, zero, ct], -1)], dim=-2)
    tp = (d1 - d3) * torch.stack([e1 * x1, zero, -e3 * x3], dim=-1)
    RH = _fix_det(s_det * Ua @ Rp @ Vat)
    tH = tp @ Ua.T
    tH = tH / (torch.linalg.norm(tH, dim=-1, keepdim=True) + 1e-12)
    return RH, tH, RF, tF


def initialize_two_view(p1_px: torch.Tensor, p2_px: torch.Tensor, valid: torch.Tensor, key,
                        cam: CameraIntrinsics, sigma: float = 1.0, n_hyps: int = 200) -> InitResult:
    """Two-view map initialization (JAX ``initializer.py:171-287``) from
    float32 [N, 2] matched pixels of two frames with a bool [N] validity
    mask; ``key`` is the draw's seed or uint32 key pair (the tracker
    passes its frame id, as the JAX tracker passes ``PRNGKey(frame_id)``).
    Everything stays on the device of the inputs."""
    dev, dt = p1_px.device, p1_px.dtype
    sigma2 = sigma * sigma
    K = torch.tensor([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]], dtype=dt, device=dev)
    sH, Hs, sF, Fs = hypothesis_scores(p1_px, p2_px, valid, key, sigma, n_hyps)
    bH, bF = torch.argmax(sH), torch.argmax(sF)
    SH, H = sH[bH], Hs[bH]
    SF, F = sF[bF], Fs[bF]
    _, inlH = _homography_score(H, p1_px, p2_px, sigma2)
    _, inlF = _fundamental_score(F, p1_px, p2_px, sigma2)
    use_H = SH / (SH + SF + 1e-9) > 0.40

    RH, tH, RF, tF = (c.to(dt) for c in _motion_candidates(H, F, K))
    inl = torch.where(use_H, inlH, inlF) & valid
    R = torch.where(use_H, RH, RF)
    t = torch.where(use_H, tH, tF)
    t = t / (torch.linalg.norm(t, dim=-1, keepdim=True) + 1e-12)
    goods, pts, good, med_cos = _check_rt(R, t, K, p1_px, p2_px, inl, sigma2)
    best = torch.argmax(goods)
    n_best = goods[best]
    n_second = torch.sort(goods).values[-2]
    t_best = t[best] / (torch.linalg.norm(t[best]) + 1e-12)
    # Accept if the winner clearly dominates, has enough support and
    # enough parallax (the reference's CheckRT parallax > 1 deg rule).
    success = (n_best > 30) & (n_second < 0.75 * n_best) & (med_cos[best] < 0.99985)
    return InitResult(success=success, R=R[best], t=t_best, points3d=pts[best], inliers=good[best],
                      used_homography=use_H)
