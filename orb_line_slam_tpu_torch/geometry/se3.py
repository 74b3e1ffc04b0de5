"""SO3/SE3 tangent-space operations on torch tensors, batched over
leading dims.

Port of ``orb_line_slam_tpu/geometry/se3.py:28-132`` (hat, so3_exp/log,
se3_exp/compose/inverse/apply/retract).  Conventions are the JAX
package's: rotations are 3x3 world-to-camera matrices, tangent vectors
are [rho(3), phi(3)], poses act as x_cam = R @ x_world + t.  Matmuls run
in full fp32 (the package disables TF32 at import).
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector (batched over leading dims)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([o, -z, y], dim=-1),
            torch.stack([z, o, -x], dim=-1),
            torch.stack([-y, x, o], dim=-1),
        ],
        dim=-2,
    )


def _coeffs(phi: torch.Tensor):
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    K = hat(phi)
    K2 = K @ K
    small = theta2 < 1e-12
    t2c = theta2.clamp(min=_EPS * _EPS)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / t2c)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(K.shape)
    return theta, theta2, t2c, small, K, K2, b, eye


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle (3,) -> rotation matrix (3,3). Batched."""
    theta, theta2, _, small, K, K2, b, eye = _coeffs(phi)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    return eye + a * K + b * K2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> axis-angle. Batched; safe near identity."""
    # The angle keeps a trailing axis of 1: arithmetic between a Python
    # scalar and a 0-dim tensor promotes to float64 under torch.func.
    trace = (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2])[..., None]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0 + 1e-7, 1.0 - 1e-7)
    th = torch.arccos(cos_theta)
    w = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]],
        dim=-1,
    )
    scale = torch.where(th < 1e-6, 0.5 + th**2 / 12.0, th / (2.0 * torch.sin(th) + _EPS))
    return scale * w


def _left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """SO3 left Jacobian J_l(phi), batched."""
    theta, theta2, t2c, small, K, K2, b, eye = _coeffs(phi)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / (t2c * theta))
    return eye + b * K + c * K2


def se3_exp(xi: torch.Tensor):
    """se3 tangent [rho, phi] (6,) -> (R (3,3), t (3,)). Batched."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    R = so3_exp(phi)
    t = (_left_jacobian(phi) @ rho[..., None])[..., 0]
    return R, t


def se3_compose(Ra, ta, Rb, tb):
    """(Ra,ta) * (Rb,tb): first apply b then a."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def se3_inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def se3_apply(R, t, x):
    """Transform points x (...,3) by (R,t) (leading dims broadcast)."""
    return (R @ x[..., None])[..., 0] + t


def se3_retract(R, t, xi):
    """Left-multiplicative update exp(xi) * (R, t) (g2o VertexSE3Expmap)."""
    dR, dt = se3_exp(xi)
    return se3_compose(dR, dt, R, t)
