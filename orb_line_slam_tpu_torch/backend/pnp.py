"""EPnP + RANSAC: camera pose from 2D-3D correspondences.

Port of ``orb_line_slam_tpu/backend/pnp.py:22-99`` (``_epnp_single`` and
``solve_pnp_ransac``) with ``horn_alignment`` from
``backend/sim3_solver.py:22-45``.  All hypotheses are solved as one
batch.  The hypotheses are the JAX package's own draw,
``jax.random.choice(PRNGKey(seed), N, (n_hyps, sample_size),
replace=True, p=valid / n_valid)``, index for index (``draw_hypotheses``):
the uniforms come from threefry-2x32 as ``jax.random.uniform`` makes
them, and the inverse-CDF search runs on a cumulative sum associated as
XLA's CPU backend associates ``jnp.cumsum`` (sequential runs of 16,
then the same scan over the run totals).  Which rows path B's 128
hypotheses take decides, on a weakly supported frame, which of two pose
basins the solve falls into, so a different draw is a different
trajectory.  ``fold_in`` derives a key as ``jax.random.fold_in`` does, for
the monocular initializer's second draw
(``frontend/initializer.py:184-189``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import CameraIntrinsics
from ..geometry.camera import project


def horn_alignment(p1: torch.Tensor, p2: torch.Tensor, fix_scale: bool):
    """Closed-form similarity aligning p2 -> p1 (both [..., N, 3]):
    (s, R, t) with p1 ~ s R p2 + t; rotation from the SVD of the
    correlation with the reflection fixed."""
    c1 = p1.mean(dim=-2, keepdim=True)
    c2 = p2.mean(dim=-2, keepdim=True)
    x1, x2 = p1 - c1, p2 - c2
    M = x1.transpose(-1, -2) @ x2
    U, _, Vt = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vt)
    # diag(1, 1, det) built out of place, so that torch.func.vmap can batch it.
    S = torch.diag_embed(torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1))
    R = U @ S @ Vt
    if fix_scale:
        s = torch.ones(M.shape[:-2], dtype=M.dtype, device=M.device)
    else:
        num = torch.sum(x1 * (x2 @ R.transpose(-1, -2)), dim=(-2, -1))
        s = num / (torch.sum(x2 * x2, dim=(-2, -1)) + 1e-12)
    t = c1[..., 0, :] - s[..., None] * (R @ c2[..., 0, :, None])[..., 0]
    return s, R, t


def epnp(pw: torch.Tensor, uv: torch.Tensor, cam: CameraIntrinsics):
    """EPnP on [H, n, 3] world points and [H, n, 2] pixels (n >= 6),
    batched over H hypotheses.  Returns (R [H,3,3], t [H,3]) world->cam."""
    H, n = pw.shape[0], pw.shape[1]
    dev, dt = pw.device, pw.dtype
    c0 = pw.mean(dim=1)
    centered = pw - c0[:, None]
    cov = centered.transpose(-1, -2) @ centered / n
    w, v = torch.linalg.eigh(cov)
    scales = torch.sqrt(torch.clamp(w, min=1e-8))
    C = torch.cat([c0[:, None], c0[:, None] + v.transpose(-1, -2) * scales[..., None]], dim=1)  # [H,4,3]

    ones4 = torch.ones((H, 1, 4), dtype=dt, device=dev)
    Ch = torch.cat([C.transpose(-1, -2), ones4], dim=1)                         # [H,4,4]
    pwh = torch.cat([pw.transpose(-1, -2), torch.ones((H, 1, n), dtype=dt, device=dev)], dim=1)
    alpha = torch.linalg.solve_ex(Ch, pwh)[0].transpose(-1, -2)                # [H,n,4]

    u, vv = uv[..., 0], uv[..., 1]
    zeros = torch.zeros_like(alpha)
    rows_u = torch.cat([alpha * cam.fx, zeros, alpha * (cam.cx - u)[..., None]], dim=-1)
    rows_v = torch.cat([zeros, alpha * cam.fy, alpha * (cam.cy - vv)[..., None]], dim=-1)
    M = torch.cat([rows_u, rows_v], dim=1).double()                             # [H,2n,12]
    # The null vector of this 12x12 normal matrix is the fragile step: in
    # float32 its error depends on the eigensolver (LAPACK on the CPU,
    # Jacobi on the GPU) and reaches ~2 mm of translation on the pose
    # parity problem (the JAX package's float32 EPnP included); float64
    # makes it solver-independent.
    _, vecs = torch.linalg.eigh(M.transpose(-1, -2) @ M)
    x = vecs[..., 0].to(dt)
    Cc = torch.stack([x[:, 0:4], x[:, 4:8], x[:, 8:12]], dim=2)                 # [H,4,3]

    dw = torch.linalg.norm(C[:, :, None] - C[:, None, :], dim=-1)
    dc = torch.linalg.norm(Cc[:, :, None] - Cc[:, None, :], dim=-1)
    beta = torch.sum(dw * dc, dim=(1, 2)) / torch.clamp(torch.sum(dc * dc, dim=(1, 2)), min=1e-12)
    Cc = Cc * beta[:, None, None]
    pc = alpha @ Cc
    sign = torch.where(pc[..., 2].mean(dim=1) < 0, -1.0, 1.0).to(dt)
    Cc = Cc * sign[:, None, None]
    _, R, t = horn_alignment(Cc, C, fix_scale=True)
    return R, t


def _threefry2x32(k1: int, k2: int, x1: np.ndarray, x2: np.ndarray):
    """Threefry-2x32 (20 rounds) on uint32 counter pairs, as
    ``jax._src.prng._threefry2x32_lowering`` computes it."""
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    ks = (np.uint32(k1), np.uint32(k2), np.uint32(k1) ^ np.uint32(k2) ^ np.uint32(0x1BD11BDA))
    x1, x2 = x1 + ks[0], x2 + ks[1]
    for i in range(5):
        for r in rot[i % 2]:
            x1 = x1 + x2
            x2 = x1 ^ ((x2 << np.uint32(r)) | (x2 >> np.uint32(32 - r)))
        x1 = x1 + ks[(i + 1) % 3]
        x2 = x2 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x1, x2


def prng_key(seed: int) -> tuple[int, int]:
    """The uint32 pair of ``jax.random.PRNGKey(seed)`` (threefry keys)."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return s >> 32, s & 0xFFFFFFFF


def fold_in(key, data: int) -> tuple[int, int]:
    """``jax.random.fold_in(key, data)`` as a uint32 pair: threefry-2x32
    of the key on the counter pair (0, data).  ``key`` is a seed (an int,
    read as ``PRNGKey(seed)``) or a pair."""
    k1, k2 = _as_key(key)
    a, b = _threefry2x32(k1, k2, np.zeros(1, np.uint32), np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return int(a[0]), int(b[0])


def _as_key(key) -> tuple[int, int]:
    if isinstance(key, (int, np.integer)):
        return prng_key(int(key))
    k1, k2 = key
    return int(k1), int(k2)


@functools.lru_cache(maxsize=64)
def jax_uniform(key, n: int) -> np.ndarray:
    """``jax.random.uniform(key, (n,))`` bit for bit (threefry keys,
    partitionable counters; float32 in [0, 1)); ``key`` is a seed, read as
    ``PRNGKey(seed)``, or a raw uint32 pair such as ``fold_in`` returns."""
    b1, b2 = _threefry2x32(*_as_key(key), np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32))
    bits = (b1 ^ b2) >> np.uint32(9) | np.uint32(0x3F800000)
    u = bits.view(np.float32) - np.float32(1.0)
    u.setflags(write=False)
    return u


@functools.lru_cache(maxsize=16)
def _uniform_on(key: tuple[int, int], n: int, device: str) -> torch.Tensor:
    return torch.from_numpy(jax_uniform(key, n).copy()).to(device)


def xla_cumsum(x: torch.Tensor, run: int = 16) -> torch.Tensor:
    """Inclusive float32 cumulative sum of a 1-D tensor, associated as
    XLA's CPU backend evaluates ``jnp.cumsum``: sequential sums within
    runs of ``run`` elements, plus the exclusive scan (the same way) of
    the run totals.  ``torch.cumsum`` associates differently on either
    device."""
    n = x.shape[0]
    m = -(-n // run)
    xs = torch.nn.functional.pad(x, (0, m * run - n)).reshape(m, run)
    cols = [xs[:, 0]]
    for k in range(1, run if m > 1 else n):
        cols.append(cols[-1] + xs[:, k])
    loc = torch.stack(cols, dim=1)
    if m == 1:
        return loc[0, :n]
    tot = xla_cumsum(loc[:, -1], run)
    carry = torch.cat([tot.new_zeros(1), tot[:-1]])
    return (loc + carry[:, None]).reshape(-1)[:n]


def draw_hypotheses(valid: torch.Tensor, key, n_hyps: int = 128, sample_size: int = 6) -> torch.Tensor:
    """Row indices [n_hyps, sample_size] of ``jax.random.choice(key, N,
    (n_hyps, sample_size), replace=True, p=valid / max(n_valid, 1))``;
    ``key`` is a seed, read as ``PRNGKey(seed)``, or a uint32 pair.  With no
    valid row every index is 0."""
    p = valid.to(torch.float32)
    p = p / torch.clamp(p.sum(), min=1.0)
    cum = xla_cumsum(p)
    u = _uniform_on(_as_key(key), n_hyps * sample_size, str(valid.device))
    idx = torch.searchsorted(cum, cum[-1] * (1.0 - u))
    return idx.reshape(n_hyps, sample_size)


def solve_pnp_ransac(
    points_w: torch.Tensor,   # [N, 3]
    uv: torch.Tensor,         # [N, 2]
    valid: torch.Tensor,      # [N]
    seed: int,
    cam: CameraIntrinsics,
    sigma2: torch.Tensor,     # [N] per-point sigma^2 (octave-scaled)
    n_hyps: int = 128,
    sample_size: int = 6,
):
    """Batched RANSAC EPnP. Returns (R, t, inlier_mask, n_inliers).

    The hypotheses sample valid rows with replacement, drawn as the JAX
    package draws them from ``PRNGKey(seed)`` (``draw_hypotheses``)."""
    idx = draw_hypotheses(valid, seed, n_hyps, sample_size)
    Rs, ts = epnp(points_w[idx], uv[idx], cam)
    pc = torch.einsum("hij,nj->hni", Rs, points_w) + ts[:, None, :]
    err = torch.sum((project(cam, pc) - uv[None]) ** 2, dim=-1)
    ok = (err < 5.991 * sigma2[None]) & (pc[..., 2] > 0.05) & valid[None]
    counts = ok.sum(dim=1)
    best = torch.argmax(counts)
    return Rs[best], ts[best], ok[best], counts[best]
