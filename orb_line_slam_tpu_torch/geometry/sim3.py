"""Sim3 similarity-transform manifold (scale + SE3) on torch tensors,
batched over leading dims, fp32.

Port of ``orb_line_slam_tpu/geometry/sim3.py`` (``sim3_apply`` 26,
``sim3_compose`` 30, ``sim3_inverse`` 38, ``_sim3_W`` 44, ``sim3_exp``
89, ``sim3_log`` 99, ``sim3_retract`` 108).  A Sim3 is (s, R, t) acting
as x' = s * R @ x + t; tangent vectors are [rho(3), phi(3), sigma(1)]
(translation, rotation, log-scale).
"""

from __future__ import annotations

import torch

from ..backend.assembly import inv33
from .se3 import _EPS, hat, so3_exp, so3_log


def sim3_apply(s, R, t, x):
    return s[..., None] * (R @ x[..., None])[..., 0] + t


def sim3_compose(sa, Ra, ta, sb, Rb, tb):
    """(sa,Ra,ta) o (sb,Rb,tb): apply b then a."""
    return sa * sb, Ra @ Rb, sa[..., None] * (Ra @ tb[..., None])[..., 0] + ta


def sim3_inverse(s, R, t):
    Rt = R.transpose(-1, -2)
    s_inv = torch.reciprocal(s)   # not 1.0 / s: a Python scalar over a 0-dim tensor promotes to float64 under torch.func
    return s_inv, Rt, -s_inv[..., None] * (Rt @ t[..., None])[..., 0]


def _sim3_W(phi, sigma):
    """The Sim3 'W' matrix coupling translation with rotation+scale:
    t = W @ rho for exp([rho, phi, sigma]).  ``torch.where`` evaluates
    both branches, so every denominator is guarded as in the JAX code.
    The coefficients keep a trailing axis of 1: 0-dim tensors promote to
    float64 inside ``torch.func`` transforms."""
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    K = hat(phi)
    K2 = K @ K
    sig = sigma[..., None]
    es = torch.exp(sig)
    small_sig = sig.abs() < 1e-5
    small_th = theta < 1e-5
    one = torch.ones_like(sig)

    # A = coefficient of I, B of K, C of K^2.
    A = torch.where(small_sig, 1.0 + sig / 2.0 + sig * sig / 6.0, (es - 1.0) / torch.where(small_sig, one, sig))
    denom = sig * sig + theta2
    denom = torch.where(denom < 1e-12, one, denom)
    es_cos = es * torch.cos(theta)
    es_sin = es * torch.sin(theta)
    b_gen = (sig * es_sin + theta * (1.0 - es_cos)) / (torch.where(small_th, one, theta) * denom)
    b_series = 0.5 + sig / 3.0 + sig * sig / 8.0
    B = torch.where(small_th, torch.where(small_sig, 0.5 + sig / 3.0, b_series), b_gen)
    c_num = A - ((es_cos - 1.0) * sig + es_sin * theta) / denom
    C = torch.where(small_th, 1.0 / 6.0 + sig / 12.0, c_num / torch.where(small_th, one, theta2))

    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(K.shape)
    return A[..., None] * eye + B[..., None] * K + C[..., None] * K2


def sim3_exp(xi):
    """Tangent [rho(3), phi(3), sigma(1)] -> (s, R, t)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    t = (_sim3_W(phi, sigma) @ rho[..., None])[..., 0]
    return torch.exp(sigma), so3_exp(phi), t


def sim3_log(s, R, t):
    """(s, R, t) -> tangent [rho, phi, sigma]."""
    phi = so3_log(R)
    sigma = torch.log(s)
    # Closed-form 3x3 inverse: torch.linalg.solve returns wrong forward
    # derivatives under torch.func's batched jvp (torch 2.13, CPU), and
    # the pose graph differentiates through this function.
    rho = (inv33(_sim3_W(phi, sigma)) @ t[..., None])[..., 0]
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)


def sim3_retract(s, R, t, xi):
    """Left-multiplicative update exp(xi) o (s,R,t) (g2o VertexSim3Expmap
    oplus semantics)."""
    ds, dR, dt = sim3_exp(xi)
    return sim3_compose(ds, dR, dt, s, R, t)
