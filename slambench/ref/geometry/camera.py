# Frozen copy of orb_line_slam_tpu_torch/geometry/camera.py at commit d30c4f7 (the benchmark's plain reference).
"""Pinhole camera model: projection, stereo, radial-tangential distortion.

Port of ``orb_line_slam_tpu/geometry/camera.py:44-111`` (project,
project_stereo, backproject, distort, undistort_points, in_image) on
torch tensors.  ``CameraIntrinsics`` lives in the port's jax-free
``config``.
"""

from __future__ import annotations

import torch

from ..config import CameraIntrinsics

__all__ = [
    "CameraIntrinsics", "project", "project_stereo", "backproject",
    "distort", "undistort_points", "in_image",
]


def _inv_z(z: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)


def project(cam: CameraIntrinsics, xc: torch.Tensor) -> torch.Tensor:
    """Camera-frame points (...,3) -> pixel coords (...,2), no distortion."""
    inv_z = _inv_z(xc[..., 2])
    u = cam.fx * xc[..., 0] * inv_z + cam.cx
    v = cam.fy * xc[..., 1] * inv_z + cam.cy
    return torch.stack([u, v], dim=-1)


def project_stereo(cam: CameraIntrinsics, xc: torch.Tensor) -> torch.Tensor:
    """Camera-frame points (...,3) -> (u_L, v_L, u_R), u_R = u_L - bf/z."""
    inv_z = _inv_z(xc[..., 2])
    u = cam.fx * xc[..., 0] * inv_z + cam.cx
    v = cam.fy * xc[..., 1] * inv_z + cam.cy
    return torch.stack([u, v, u - cam.bf * inv_z], dim=-1)


def backproject(cam: CameraIntrinsics, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Pixels (...,2) + depth (...) -> camera-frame 3D points (...,3)."""
    x = (uv[..., 0] - cam.cx) / cam.fx * depth
    y = (uv[..., 1] - cam.cy) / cam.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def distort(cam: CameraIntrinsics, xn: torch.Tensor) -> torch.Tensor:
    """Apply radial-tangential distortion to normalized coords (...,2)."""
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
    xd = x * radial + 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_points(cam: CameraIntrinsics, uv: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Fixed-iteration inverse of ``distort`` on pixel coords (...,2)."""
    if cam.k1 == 0.0 and cam.k2 == 0.0 and cam.p1 == 0.0 and cam.p2 == 0.0:
        return uv
    xn0 = torch.stack([(uv[..., 0] - cam.cx) / cam.fx, (uv[..., 1] - cam.cy) / cam.fy], dim=-1)
    xn = xn0
    for _ in range(iters):
        xn = xn0 - (distort(cam, xn) - xn)
    return torch.stack([xn[..., 0] * cam.fx + cam.cx, xn[..., 1] * cam.fy + cam.cy], dim=-1)


def in_image(cam: CameraIntrinsics, uv: torch.Tensor, margin: float = 0.0) -> torch.Tensor:
    """Boolean mask for pixels inside the image bounds."""
    return (
        (uv[..., 0] >= margin) & (uv[..., 0] < cam.width - margin)
        & (uv[..., 1] >= margin) & (uv[..., 1] < cam.height - margin)
    )
