# Frozen copy of orb_line_slam_tpu_torch/backend/local_ba.py at commit d30c4f7 (the benchmark's plain reference).
"""Local bundle adjustment with a Schur-complement solve.

Port of ``orb_line_slam_tpu/backend/local_ba.py:69-236``
(``bundle_adjust``).  Per LM iteration: residuals with analytic
Jacobians; camera blocks Hcc [C,6,6], landmark blocks Hpp [P,3,3],
gradients and the Cholesky-folded camera-landmark coupling BL [P,C,6,3]
assembled by segment sums (``index_put_`` with accumulate — the JAX package's one-hot
matmuls exist for the MXU, and ``onehot(obs_lm, P)`` alone would be
512 MB at P=8192, O=16384); the reduced camera system
S = Hcc - (BL)(BL)^T solved by LU as the JAX code solves it
(``jnp.linalg.solve``): right after a loop correction float32 rounding
leaves S indefinite, where a Cholesky factorisation fails and every step
is rejected while LU still returns a usable one; landmark
back-substitution.  Two stages as the reference: 5 Huber
iterations, chi2 gate, 10 plain iterations, final gate; each stage
exits early after two accepted steps with < 0.1% relative gain.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import CameraIntrinsics
from ..geometry.se3 import se3_compose, se3_exp
from .assembly import chol33, inv33
from .residuals import inv_level_sigma2, point_residual, point_residual_and_jacobians
from .robust import CHI2_MONO, CHI2_STEREO, huber_weight


class BAResult(NamedTuple):
    R: torch.Tensor           # [C, 3, 3]
    t: torch.Tensor           # [C, 3]
    points: torch.Tensor      # [P, 3]
    obs_inlier: torch.Tensor  # bool [O]
    chi2: torch.Tensor        # float32 scalar, final total inlier chi2


def _segment_sum(idx: torch.Tensor, vals: torch.Tensor, n: int) -> torch.Tensor:
    """out[i] = sum of vals[idx == i].  index_put_ with accumulate sorts
    by index on the GPU instead of racing atomics, so the sums (and the
    whole solve) are reproducible from run to run."""
    out = torch.zeros((n,) + vals.shape[1:], dtype=vals.dtype, device=vals.device)
    return out.index_put_((idx,), vals, accumulate=True)


def bundle_adjust(
    R0: torch.Tensor,           # [C, 3, 3] world->cam
    t0: torch.Tensor,           # [C, 3]
    cam_fixed: torch.Tensor,    # bool [C]
    points0: torch.Tensor,      # [P, 3]
    point_valid: torch.Tensor,  # bool [P]
    obs_cam: torch.Tensor,      # int32 [O]
    obs_lm: torch.Tensor,       # int32 [O]
    obs_uvur: torch.Tensor,     # float32 [O, 3] (u, v, uR); uR<0 = mono
    obs_oct: torch.Tensor,      # int32 [O]
    obs_valid: torch.Tensor,    # bool [O]
    cam: CameraIntrinsics,
    scale_factor: float = 1.2,
    iters1: int = 5,
    iters2: int = 10,
    fix_first: bool = False,
) -> BAResult:
    C = R0.shape[0]
    P = points0.shape[0]
    dev, dt_ = points0.device, points0.dtype
    oc = obs_cam.long()
    ol = obs_lm.long()
    if fix_first:
        cam_fixed = cam_fixed.clone()
        cam_fixed[0] = True

    is_stereo = obs_uvur[:, 2] > 0
    info = inv_level_sigma2(obs_oct, scale_factor)
    chi2_th = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    obs_valid = obs_valid & point_valid[ol]
    free_c = (~cam_fixed).to(dt_)[:, None]
    m6 = free_c[:, 0].repeat_interleave(6)
    eye3 = torch.eye(3, dtype=dt_, device=dev)
    eye6 = torch.eye(6, dtype=dt_, device=dev)
    zero = torch.zeros((), dtype=dt_, device=dev)
    pair = ol * C + oc                                   # coupling block row

    def total_chi2(R, t, points, o_valid, use_huber):
        r = point_residual(cam, R[oc], t[oc], points[ol], obs_uvur, is_stereo)
        c = torch.sum(r * r, dim=-1) * info
        w = huber_weight(c, CHI2_STEREO) if use_huber else torch.ones_like(c)
        return torch.sum(torch.where(o_valid, c * w, zero)), c

    def lm_iteration(R, t, points, lam, o_valid, use_huber):
        r, Jc, Jp = point_residual_and_jacobians(cam, R[oc], t[oc], points[ol], obs_uvur, is_stereo)
        c = torch.sum(r * r, dim=-1) * info
        hw = huber_weight(c, CHI2_STEREO) if use_huber else torch.ones_like(c)
        w = torch.where(o_valid, info * hw, zero)[:, None, None]
        JcT = Jc.transpose(-1, -2) * w                   # [O,6,3]
        JpT = Jp.transpose(-1, -2) * w                   # [O,3,3]
        Hcc = _segment_sum(oc, JcT @ Jc, C)
        Hpp = _segment_sum(ol, JpT @ Jp, P)
        gc = _segment_sum(oc, (JcT @ r[..., None])[..., 0], C)
        gp = _segment_sum(ol, (JpT @ r[..., None])[..., 0], P)

        Hcc = Hcc + lam * Hcc * eye6 + 1e-8 * eye6
        Hpp = Hpp + lam * Hpp * eye3
        Hpp = Hpp + (1e-6 + (~point_valid).to(dt_)[:, None, None]) * eye3
        V = inv33(Hpp)
        # With V = L L^T the reduction B V B^T = (BL)(BL)^T: L folds into
        # the per-observation coupling blocks before assembly.
        L = chol33(V)
        GL = (JcT @ Jp) @ L[ol]                          # [O,6,3]
        BL = _segment_sum(pair, GL, P * C).reshape(P, C, 6, 3)
        u = (L.transpose(-1, -2) @ gp[..., None])[..., 0]  # L^T gp
        Bf = BL.permute(0, 3, 1, 2).reshape(P * 3, C * 6)
        S = torch.block_diag(*Hcc) - Bf.T @ Bf
        rhs = -(gc - torch.einsum("pcik,pk->ci", BL, u)).reshape(C * 6)
        # Fixed cameras: identity rows/cols, zero rhs.
        S = S * m6[:, None] * m6[None, :] + torch.diag(1.0 - m6)
        rhs = rhs * m6
        dc = torch.linalg.solve_ex(S, rhs)[0].reshape(C, 6)   # LU, as jnp.linalg.solve
        # dp = -(V gp + L (BL^T dc))
        blt_dc = torch.einsum("pcik,ci->pk", BL, dc)
        dp = -((V @ gp[..., None])[..., 0] + (L @ blt_dc[..., None])[..., 0])
        dp = dp * point_valid[:, None]

        dR, dt = se3_exp(dc * free_c)
        R2, t2 = se3_compose(dR, dt, R, t)
        points2 = points + dp
        err0 = torch.sum(torch.where(o_valid, c * hw, zero))
        err1, _ = total_chi2(R2, t2, points2, o_valid, use_huber)
        accept = err1 < err0
        R = torch.where(accept, R2, R)
        t = torch.where(accept, t2, t)
        points = torch.where(accept, points2, points)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 5.0), 1e-9, 1e5)
        rel = (err0 - err1) / torch.clamp(err0, min=1e-12)
        return R, t, points, lam, accept, rel

    def run_stage(R, t, points, o_valid, n_iters, use_huber):
        lam = torch.tensor(1e-4, dtype=dt_, device=dev)
        conv_ct = 0
        for _ in range(n_iters):
            if conv_ct >= 2:
                break
            R, t, points, lam, accept, rel = lm_iteration(R, t, points, lam, o_valid, use_huber)
            acc, small = (bool(v) for v in torch.stack([accept, rel < 1e-3]).tolist())
            conv_ct = conv_ct + 1 if (acc and small) else (0 if acc else conv_ct)
        return R, t, points

    R, t, points = run_stage(R0, t0, points0, obs_valid, iters1, True)
    _, c = total_chi2(R, t, points, obs_valid, False)
    o_valid = obs_valid & (c <= chi2_th)
    R, t, points = run_stage(R, t, points, o_valid, iters2, False)
    err, c = total_chi2(R, t, points, o_valid, False)
    o_valid = obs_valid & (c <= chi2_th)
    return BAResult(R=R, t=t, points=points, obs_inlier=o_valid, chi2=err)
