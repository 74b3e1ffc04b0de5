# Frozen copy of orb_line_slam_tpu_torch/backend/assembly.py at commit d30c4f7 (the benchmark's plain reference).
"""Closed-form small batched factorizations for the BA solvers.

Port of ``orb_line_slam_tpu/backend/assembly.py:54-143`` (``chol33``,
``chol44``, ``inv33``, ``inv44``).  The one-hot Hessian assembly of that
module exists for the TPU's MXU and is not ported: the BAs here assemble
with sorted segment sums (``index_put_`` with accumulate).
"""

from __future__ import annotations

import torch


def chol33(V: torch.Tensor) -> torch.Tensor:
    """Closed-form lower Cholesky of a [..., 3, 3] SPD batch."""
    a = torch.sqrt(torch.clamp(V[..., 0, 0], min=1e-30))
    b = V[..., 1, 0] / a
    c = V[..., 2, 0] / a
    d = torch.sqrt(torch.clamp(V[..., 1, 1] - b * b, min=1e-30))
    e = (V[..., 2, 1] - c * b) / d
    f = torch.sqrt(torch.clamp(V[..., 2, 2] - c * c - e * e, min=1e-30))
    z = torch.zeros_like(a)
    return torch.stack([a, z, z, b, d, z, c, e, f], dim=-1).reshape(*V.shape[:-2], 3, 3)


def chol44(V: torch.Tensor) -> torch.Tensor:
    """Closed-form lower Cholesky of a [..., 4, 4] SPD batch."""
    a = torch.sqrt(torch.clamp(V[..., 0, 0], min=1e-30))
    r10 = V[..., 1, 0] / a
    r20 = V[..., 2, 0] / a
    r30 = V[..., 3, 0] / a
    b = torch.sqrt(torch.clamp(V[..., 1, 1] - r10 * r10, min=1e-30))
    r21 = (V[..., 2, 1] - r20 * r10) / b
    r31 = (V[..., 3, 1] - r30 * r10) / b
    c = torch.sqrt(torch.clamp(V[..., 2, 2] - r20 * r20 - r21 * r21, min=1e-30))
    r32 = (V[..., 3, 2] - r30 * r20 - r31 * r21) / c
    d = torch.sqrt(torch.clamp(V[..., 3, 3] - r30 * r30 - r31 * r31 - r32 * r32, min=1e-30))
    z = torch.zeros_like(a)
    return torch.stack([a, z, z, z, r10, b, z, z, r20, r21, c, z, r30, r31, r32, d],
                       dim=-1).reshape(*V.shape[:-2], 4, 4)


def inv33(H: torch.Tensor) -> torch.Tensor:
    """Closed-form cofactor inverse of a [..., 3, 3] batch."""
    a, b, c = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    d, e, f = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    g, h, i = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30), det)
    out = torch.stack(
        [
            A, -(b * i - c * h), (b * f - c * e),
            B, (a * i - c * g), -(a * f - c * d),
            C, -(a * h - b * g), (a * e - b * d),
        ],
        dim=-1,
    ).reshape(*H.shape[:-2], 3, 3)
    return out * inv_det[..., None, None]


def _inv22(M: torch.Tensor) -> torch.Tensor:
    a, b = M[..., 0, 0], M[..., 0, 1]
    c, d = M[..., 1, 0], M[..., 1, 1]
    det = a * d - b * c
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30), det)
    return torch.stack([d, -b, -c, a], dim=-1).reshape(*M.shape[:-2], 2, 2) * inv_det[..., None, None]


def inv44(H: torch.Tensor) -> torch.Tensor:
    """Blockwise 2x2 (Schur) inverse of a [..., 4, 4] batch; the leading
    2x2 block must be invertible (true for BA's damped SPD blocks)."""
    A, B = H[..., :2, :2], H[..., :2, 2:]
    C, D = H[..., 2:, :2], H[..., 2:, 2:]
    Ai = _inv22(A)
    Si = _inv22(D - C @ Ai @ B)
    AiB = Ai @ B
    CAi = C @ Ai
    top = torch.cat([Ai + AiB @ Si @ CAi, -AiB @ Si], dim=-1)
    bot = torch.cat([-Si @ CAi, Si], dim=-1)
    return torch.cat([top, bot], dim=-2)
