"""Large-scale bundle adjustment: matrix-free CG on the Schur complement.

Port of ``orb_line_slam_tpu/backend/global_ba.py:46-193``
(``bundle_adjust_cg``).  The dense solver (``local_ba.py``) materializes
the camera-landmark coupling [P, C, 6, 3] and the reduced system
[6C, 6C]; at global-BA scale (hundreds of keyframes, tens of thousands
of landmarks) the coupling alone is gigabytes.  Here neither exists:

  - every product against the coupling is a sorted segment sum over the
    observation list (``bt_x``, ``b_z``);
  - S dc = rhs is solved by preconditioned conjugate gradients with the
    block-Jacobi (per-camera 6x6) preconditioner, for a fixed number of
    iterations (no data-dependent exit, as in the JAX package, so both
    run the same arithmetic);
  - landmark back-substitution stays closed-form per landmark.

Memory is O(O + C + P); each CG step is two observation sweeps.  Same
two-stage LM schedule and chi2 gating as the dense solver (without its
early exit), so the two are interchangeable.
"""

from __future__ import annotations

import torch

from ..config import CameraIntrinsics
from ..geometry.se3 import se3_compose, se3_exp
from .assembly import inv33
from .local_ba import BAResult, _segment_sum
from .residuals import inv_level_sigma2, point_residual, point_residual_and_jacobians
from .robust import CHI2_MONO, CHI2_STEREO, huber_weight


def bundle_adjust_cg(
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
    cg_iters: int = 48,
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
    m = (~cam_fixed).to(dt_)[:, None]                    # [C,1] 1 = free
    eye3 = torch.eye(3, dtype=dt_, device=dev)
    eye6 = torch.eye(6, dtype=dt_, device=dev)
    zero = torch.zeros((), dtype=dt_, device=dev)

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
        # Per-observation weighted blocks stay in observation-major layout.
        JcT = Jc.transpose(-1, -2) * w                   # [O,6,3]
        JpT = Jp.transpose(-1, -2) * w                   # [O,3,3]
        JcT_Jp = JcT @ Jp                                # [O,6,3]
        Hcc = _segment_sum(oc, JcT @ Jc, C)
        Hpp = _segment_sum(ol, JpT @ Jp, P)
        gc = _segment_sum(oc, (JcT @ r[..., None])[..., 0], C)
        gp = _segment_sum(ol, (JpT @ r[..., None])[..., 0], P)

        Hcc = Hcc + lam * Hcc * eye6 + 1e-8 * eye6
        Hpp = Hpp + lam * Hpp * eye3
        Hpp = Hpp + (1e-6 + (~point_valid).to(dt_)[:, None, None]) * eye3
        V = inv33(Hpp)

        def mv(A, x):
            return (A @ x[..., None])[..., 0]

        def bt_x(x):
            """B^T x: [C,6] -> [P,3] via one observation sweep."""
            return _segment_sum(ol, (x[oc][:, None, :] @ JcT_Jp)[:, 0], P)

        def b_z(z):
            """B z: [P,3] -> [C,6] via one observation sweep."""
            return _segment_sum(oc, mv(JcT_Jp, z[ol]), C)

        def s_matvec(x):
            """Schur product S x with fixed cameras as identity rows."""
            xm = x * m
            sx = (mv(Hcc, xm) - b_z(mv(V, bt_x(xm)))) * m
            return sx + x * (1.0 - m)

        # rhs = -(gc - B V gp), masked at fixed cameras.
        rhs = -(gc - b_z(mv(V, gp))) * m
        # Block-Jacobi preconditioner: per-camera 6x6 inverse of Hcc.
        Minv = torch.linalg.inv(Hcc + 1e-6 * eye6)

        def precond(v):
            return mv(Minv, v * m) * m + v * (1.0 - m)

        x = torch.zeros_like(rhs)
        rr = rhs
        p = precond(rhs)
        rz = torch.sum(rhs * p)
        for _ in range(cg_iters):
            Ap = s_matvec(p)
            pAp = torch.sum(p * Ap)
            alpha = torch.where(pAp > 1e-20, rz / pAp, zero)
            x = x + alpha * p
            rr = rr - alpha * Ap
            z = precond(rr)
            rz_new = torch.sum(rr * z)
            beta = torch.where(rz > 1e-20, rz_new / rz, zero)
            p = z + beta * p
            rz = rz_new
        dc = x * m

        # Landmark back-substitution: dp = -V (gp + B^T dc).
        dp = -mv(V, gp + bt_x(dc)) * point_valid[:, None]

        dR, dt = se3_exp(dc * m)
        R2, t2 = se3_compose(dR, dt, R, t)
        points2 = points + dp
        err0 = torch.sum(torch.where(o_valid, c * hw, zero))
        err1, _ = total_chi2(R2, t2, points2, o_valid, use_huber)
        accept = err1 < err0
        R = torch.where(accept, R2, R)
        t = torch.where(accept, t2, t)
        points = torch.where(accept, points2, points)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 5.0), 1e-9, 1e5)
        return R, t, points, lam

    def run_stage(R, t, points, o_valid, n_iters, use_huber):
        lam = torch.tensor(1e-4, dtype=dt_, device=dev)
        for _ in range(n_iters):
            R, t, points, lam = lm_iteration(R, t, points, lam, o_valid, use_huber)
        return R, t, points

    R, t, points = run_stage(R0, t0, points0, obs_valid, iters1, True)
    _, c = total_chi2(R, t, points, obs_valid, False)
    o_valid = obs_valid & (c <= chi2_th)
    R, t, points = run_stage(R, t, points, o_valid, iters2, False)
    err, c = total_chi2(R, t, points, o_valid, False)
    o_valid = obs_valid & (c <= chi2_th)
    return BAResult(R=R, t=t, points=points, obs_inlier=o_valid, chi2=err)
