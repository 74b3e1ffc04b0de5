# Frozen copy of orb_line_slam_tpu_torch/geometry/lines3d.py at commit d30c4f7 (the benchmark's plain reference).
"""3D line geometry: Plücker coordinates and the orthonormal 4-DoF update.

Port of ``orb_line_slam_tpu/geometry/lines3d.py:22-91``.  A Plücker line
is (n, v): moment n = p × d for any point p on the line, direction v.
The orthonormal representation factors (n | v) ~ U diag(w1, w2) with
U in SO(3) and (w1, w2) on the unit circle: 3 + 1 DoF.  Batched over
leading dims; the numpy twins (``n*``) live in ``geometry/host.py``.
"""

from __future__ import annotations

import torch

from .se3 import so3_exp


def pluecker_from_endpoints(p1: torch.Tensor, p2: torch.Tensor):
    """Endpoints (..., 3) -> Plücker (n = p1 × p2, v = p2 - p1)."""
    return torch.linalg.cross(p1, p2), p2 - p1


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))


def orthonormal_from_pluecker(n: torch.Tensor, v: torch.Tensor):
    """(n, v) -> (U (..., 3, 3), w (..., 2)) with (n | v) ~ U diag(w)."""
    nn = _norm(n) + 1e-12
    nv = _norm(v) + 1e-12
    u1 = n / nn
    u2 = v / nv
    U = torch.stack([u1, u2, torch.linalg.cross(u1, u2)], dim=-1)   # columns
    w = torch.cat([nn, nv], dim=-1)
    return U, w / (_norm(w) + 1e-12)


def pluecker_from_orthonormal(U: torch.Tensor, w: torch.Tensor):
    """(U, w) -> (n, v) with |(|n|, |v|)| = 1."""
    return w[..., 0:1] * U[..., :, 0], w[..., 1:2] * U[..., :, 1]


def orthonormal_retract(U: torch.Tensor, w: torch.Tensor, xi: torch.Tensor):
    """4-DoF update U <- U exp([theta]x), w <- rot(phi) w, with
    xi (..., 4) = [theta (3), phi]."""
    phi = xi[..., 3]
    c, s = torch.cos(phi), torch.sin(phi)
    w1 = c * w[..., 0] - s * w[..., 1]
    w2 = s * w[..., 0] + c * w[..., 1]
    return U @ so3_exp(xi[..., :3]), torch.stack([w1, w2], dim=-1)


def pluecker_transform(Rcw: torch.Tensor, tcw: torch.Tensor, n_w: torch.Tensor, v_w: torch.Tensor):
    """World -> camera: n_c = R n_w + t × (R v_w), v_c = R v_w."""
    Rv = (Rcw @ v_w[..., None])[..., 0]
    Rn = (Rcw @ n_w[..., None])[..., 0]
    return Rn + torch.linalg.cross(tcw.expand_as(Rv), Rv), Rv


def line_projection_matrix(fx, fy, cx, cy, device=None) -> torch.Tensor:
    """K_L with image line l = K_L n_c (homogeneous coefficients)."""
    return torch.tensor([[fy, 0.0, 0.0], [0.0, fx, 0.0], [-fy * cx, -fx * cy, fx * fy]],
                        dtype=torch.float32, device=device)


def closest_points_on_line(n: torch.Tensor, v: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Orthogonal projection of points (..., 3) onto the line (n, v):
    p0 + ((p - p0) · v̂) v̂ with p0 = (v × n) / |v|^2."""
    v2 = torch.sum(v * v, dim=-1, keepdim=True) + 1e-12
    p0 = torch.linalg.cross(v, n) / v2
    vhat = v / torch.sqrt(v2)
    return p0 + torch.sum((pts - p0) * vhat, dim=-1, keepdim=True) * vhat
