# Frozen copy of orb_line_slam_tpu_torch/backend/residuals.py at commit d30c4f7 (the benchmark's plain reference).
"""Point and line reprojection residuals and their analytic Jacobians.

Port of ``orb_line_slam_tpu/backend/residuals.py:27-78`` (the unified
mono/stereo point residual (du, dv, duR), duR zeroed for mono; the line
residual, the signed distances of a 3D segment's two projected
endpoints to an observed 2D line; ``line_obs_coeffs``) and of the
Jacobians the JAX package takes with ``jax.jacfwd`` at a zero SE3
tangent (``residuals.py:81-97``, ``local_ba.py:47-66``), written out:
with xc = R p + t and the left-multiplicative update exp(xi) * (R, t),
d xc / d xi = [I, -hat(xc)] and d xc / d p = R.
"""

from __future__ import annotations

import torch

from ..config import CameraIntrinsics
from ..geometry.camera import project_stereo
from ..geometry.se3 import hat, se3_apply


def inv_level_sigma2(octave: torch.Tensor, scale_factor: float) -> torch.Tensor:
    base = torch.tensor(scale_factor, dtype=torch.float32, device=octave.device)
    return torch.pow(base, -2.0 * octave.to(torch.float32))


def point_residual(cam: CameraIntrinsics, R, t, xyz_w, obs_uvur, is_stereo):
    """Residual [..., 3] = project_stereo(R x + t) - obs; duR = 0 for mono."""
    r = project_stereo(cam, se3_apply(R, t, xyz_w)) - obs_uvur
    return torch.cat([r[..., :2], torch.where(is_stereo, r[..., 2], torch.zeros_like(r[..., 2]))[..., None]], dim=-1)


def point_residual_and_jacobians(cam: CameraIntrinsics, R, t, xyz_w, obs_uvur, is_stereo):
    """(r [..., 3], Jc [..., 3, 6] w.r.t. the pose tangent [rho, phi],
    Jp [..., 3, 3] w.r.t. the world point)."""
    xc = se3_apply(R, t, xyz_w)
    z = xc[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    r = point_residual(cam, R, t, xyz_w, obs_uvur, is_stereo)
    x_z = xc[..., 0] * inv_z
    y_z = xc[..., 1] * inv_z
    o = torch.zeros_like(z)
    du = torch.stack([cam.fx * inv_z, o, -cam.fx * x_z * inv_z], dim=-1)
    dv = torch.stack([o, cam.fy * inv_z, -cam.fy * y_z * inv_z], dim=-1)
    st = is_stereo.to(z.dtype)
    dur = torch.stack([cam.fx * inv_z, o, (-cam.fx * x_z + cam.bf * inv_z) * inv_z], dim=-1) * st[..., None]
    Jx = torch.stack([du, dv, dur], dim=-2)                      # [..., 3, 3]
    dxi = torch.cat([torch.eye(3, dtype=z.dtype, device=z.device).expand(Jx.shape), -hat(xc)], dim=-1)
    Jc = Jx @ dxi
    Jp = Jx @ R
    return r, Jc, Jp


def line_obs_coeffs(p1_uv: torch.Tensor, p2_uv: torch.Tensor) -> torch.Tensor:
    """Normalised infinite-line coefficients (a, b, c), a^2 + b^2 = 1,
    through two 2D endpoints: the observation of a line feature."""
    a = p1_uv[..., 1] - p2_uv[..., 1]
    b = p2_uv[..., 0] - p1_uv[..., 0]
    c = p1_uv[..., 0] * p2_uv[..., 1] - p2_uv[..., 0] * p1_uv[..., 1]
    n = torch.sqrt(a * a + b * b + 1e-12)
    return torch.stack([a / n, b / n, c / n], dim=-1)


def _px(cam: CameraIntrinsics, xc: torch.Tensor):
    z = torch.where(torch.abs(xc[..., 2]) < 1e-9, torch.full_like(xc[..., 2], 1e-9), xc[..., 2])
    return cam.fx * xc[..., 0] / z + cam.cx, cam.fy * xc[..., 1] / z + cam.cy, z


def line_residual_and_jacobian(cam: CameraIntrinsics, R, t, p_start_w, p_end_w, obs_line,
                               jacobian: bool = True):
    """(r [..., 2], J [..., 2, 6]): signed distances a u + b v + c of the
    projected start and end points to the observed line, and their
    Jacobian w.r.t. the pose tangent [rho, phi] (J is None when
    jacobian=False)."""
    rows, jac = [], []
    for p_w in (p_start_w, p_end_w):
        xc = se3_apply(R, t, p_w)
        u, v, z = _px(cam, xc)
        rows.append(obs_line[..., 0] * u + obs_line[..., 1] * v + obs_line[..., 2])
        if jacobian:
            a, b = obs_line[..., 0] * cam.fx / z, obs_line[..., 1] * cam.fy / z
            dxc = torch.stack([a, b, -(a * xc[..., 0] + b * xc[..., 1]) / z], dim=-1)   # d r / d xc
            jac.append(torch.cat([dxc, torch.linalg.cross(xc, dxc)], dim=-1))           # dxc @ [I, -hat(xc)]
    r = torch.stack(rows, dim=-1)
    return r, (torch.stack(jac, dim=-2) if jacobian else None)
