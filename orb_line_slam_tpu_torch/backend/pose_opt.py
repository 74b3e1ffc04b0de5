"""Motion-only bundle adjustment (the per-frame pose solve).

Port of ``orb_line_slam_tpu/backend/pose_opt.py:34-155``: ``rounds``
rounds of ``iters`` LM iterations on one SE3 vertex with point edges and
optional line edges, Huber on the first two rounds, chi2 gating after
every round (points 5.991 mono / 7.815 stereo, lines 5.991) — the fixed
schedule of the reference's PoseOptimization.  As in the JAX code, line
terms are Huber-weighted in H and g but enter the step's error
comparison unweighted.  ``n_inliers`` counts points and lines together.

``pose_optimize`` runs the custom operator ``orb_line_slam::pose_solve``,
which dispatches on the device of its inputs: CPU tensors take the plain
version (``pose_solve_plain``: the analytic Jacobians of
``residuals.py``, 6x6 normal equations solved with ``solve_ex``, which
does not synchronize with the host, a rejected step keeping the pose as
``jnp.where`` does in the JAX scan); CUDA tensors launch the hand-written
kernel ``csrc/pose_solve.cu`` — the whole schedule in one launch of one
thread-block cluster of ``cluster_size(M, L)`` CTAs — or raise.  The
operator has a vmap rule, so under ``torch.func.vmap`` (the batched
multi-sequence step) the B solves are one launch of B clusters.
``launches`` counts kernel launches.  ``pose_optimize_reference`` is the
plain version behind ``pose_optimize``'s signature.

Kernel against plain version: the same arithmetic, the sums over
observations taken in another order, so an accept/reject or gating
decision decided by the last bits can flip; they are held to the pose
contract (1e-3 rad, 5e-3 m, inlier counts within 3).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..config import CameraIntrinsics
from ..geometry.se3 import se3_compose, se3_exp
from ..ops import _build
from .residuals import (
    inv_level_sigma2, line_residual_and_jacobian, point_residual, point_residual_and_jacobians,
)
from .robust import CHI2_MONO, CHI2_STEREO, huber_weight

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (*(_P,) * 11, _I, _I, _I, *(_F,) * 5, _I, _I, *(_P,) * 6)
_N_TENSORS = 11

# Kernel launches since import (or since the caller last reset it).
launches = 0

# The kernel's launch rule (csrc/pose_solve.cu: kWorkers, kMaxCluster,
# kHeaderBytes, kMaxSharedBytes, cluster_size, shared_bytes): a CTA's 256
# worker threads take a row each, at most 8 CTAs a solve; a CTA holds its
# share of the rows in shared memory, 30 bytes a point and 42 a line after
# a 4096-byte header, at most 227 KB.
_WORKERS, _MAX_CLUSTER, _HEADER_BYTES, MAX_SHARED_BYTES = 256, 8, 4096, 232448


def cluster_size(M: int, L: int) -> int:
    """CTAs in the cluster of one solve of M points and L lines."""
    return min(_MAX_CLUSTER, max(1, -(-(M + L) // _WORKERS)))


def shared_bytes(M: int, L: int, rounds: int, iters: int) -> int:
    """Shared memory one CTA of that cluster needs."""
    C = cluster_size(M, L)
    return _HEADER_BYTES + 30 * -(-M // C) + 42 * -(-L // C) + rounds * iters


class PoseOptResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor       # bool [M] point inliers
    line_inliers: torch.Tensor  # bool [L] ([0] without lines)
    n_inliers: torch.Tensor     # int32 scalar (points + lines)


def solve_args(R0, t0, points_w, obs_uvur, octave, valid, cam: CameraIntrinsics, scale_factor: float = 1.2,
               line_start_w=None, line_end_w=None, line_obs=None, line_octave=None, line_valid=None) -> tuple:
    """``pose_optimize``'s arguments as the operator takes them: (R0, t0,
    points, obs, p_info, valid, line_start, line_end, line_obs, l_info,
    l_valid, fx, fy, cx, cy, bf), the information weights precomputed;
    without lines the five line tensors have L = 0 rows."""
    p_info = inv_level_sigma2(octave, scale_factor)
    if line_start_w is None:
        dev, dt = points_w.device, points_w.dtype
        e3 = torch.empty((0, 3), dtype=dt, device=dev)
        lines = (e3, e3, e3, torch.empty(0, dtype=dt, device=dev), torch.empty(0, dtype=torch.bool, device=dev))
    else:
        lines = (line_start_w, line_end_w, line_obs, inv_level_sigma2(line_octave, scale_factor), line_valid)
    return (R0, t0, points_w, obs_uvur, p_info, valid, *lines,
            float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy), float(cam.bf))


def pose_solve_plain(R0, t0, points_w, obs_uvur, p_info, valid, line_start_w, line_end_w, line_obs, l_info,
                     line_valid, fx: float, fy: float, cx: float, cy: float, bf: float, rounds: int, iters: int):
    """Plain torch version of one solve.  Returns (R, t, point inliers,
    line inliers, n_inliers int32, steps uint8 [rounds * iters]: 1 where
    the LM step was accepted)."""
    cam = CameraIntrinsics(fx, fy, cx, cy, bf)
    dev, dt_ = points_w.device, points_w.dtype
    has_lines = line_start_w.shape[0] > 0
    is_stereo = obs_uvur[:, 2] > 0
    chi2_th = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    eye6 = torch.eye(6, dtype=dt_, device=dev)
    zero = torch.zeros((), dtype=dt_, device=dev)
    steps = []

    def chi2(R, t):
        r = point_residual(cam, R, t, points_w, obs_uvur, is_stereo)
        c_p = torch.sum(r * r, dim=-1) * p_info
        if not has_lines:
            return c_p, None
        rl, _ = line_residual_and_jacobian(cam, R, t, line_start_w, line_end_w, line_obs, jacobian=False)
        return c_p, torch.sum(rl * rl, dim=-1) * l_info

    def lm_round(R, t, p_in, l_in, use_huber: bool):
        lam = torch.tensor(1e-3, dtype=dt_, device=dev)
        for _ in range(iters):
            r, Jc, _ = point_residual_and_jacobians(cam, R, t, points_w, obs_uvur, is_stereo)
            c = torch.sum(r * r, dim=-1) * p_info
            hw = huber_weight(c, CHI2_STEREO) if use_huber else torch.ones_like(c)
            w = torch.where(p_in, hw * p_info, zero)
            JtW = Jc.transpose(-1, -2) * w[:, None, None]          # [M, 6, 3]
            H = torch.einsum("mid,mdj->ij", JtW, Jc)
            g = torch.einsum("mid,md->i", JtW, r)
            err0 = torch.sum(torch.where(p_in, c * hw, zero))
            if has_lines:
                rl, Jl = line_residual_and_jacobian(cam, R, t, line_start_w, line_end_w, line_obs)
                cl = torch.sum(rl * rl, dim=-1) * l_info
                wl = huber_weight(cl, CHI2_MONO) * l_info if use_huber else l_info
                wl = torch.where(l_in, wl, zero)
                JltW = Jl.transpose(-1, -2) * wl[:, None, None]    # [L, 6, 2]
                H = H + torch.einsum("lid,ldj->ij", JltW, Jl)
                g = g + torch.einsum("lid,ld->i", JltW, rl)
                err0 = err0 + torch.sum(torch.where(l_in, cl, zero))
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-8 * eye6
            xi = -torch.linalg.solve_ex(Hd, g)[0]
            dR, dt = se3_exp(xi)
            R2, t2 = se3_compose(dR, dt, R, t)
            c2, cl2 = chi2(R2, t2)
            hw2 = huber_weight(c2, CHI2_STEREO) if use_huber else torch.ones_like(c2)
            err1 = torch.sum(torch.where(p_in, c2 * hw2, zero))
            if has_lines:
                err1 = err1 + torch.sum(torch.where(l_in, cl2, zero))
            accept = err1 < err0
            steps.append(accept)
            R = torch.where(accept, R2, R)
            t = torch.where(accept, t2, t)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6)
        return R, t

    R, t = R0, t0
    p_in = valid
    l_in = line_valid if has_lines else torch.zeros_like(line_valid)
    for rnd in range(rounds):
        R, t = lm_round(R, t, p_in, l_in, use_huber=(rnd < 2))
        c_p, c_l = chi2(R, t)
        p_in = valid & (c_p <= chi2_th)
        if has_lines:
            l_in = line_valid & (c_l <= CHI2_MONO)
    n_in = p_in.sum() + l_in.sum()
    return R, t, p_in, l_in, n_in.to(torch.int32), torch.stack(steps).to(torch.uint8)


def _check_inputs(args, rounds: int, iters: int, kernel: bool):
    """Shapes, types and devices of the operator's tensor arguments: one
    solve (R0 [3, 3]) or B (R0 [B, 3, 3], every tensor with a leading [B]).
    The kernel also wants every tensor contiguous, and a CTA's share of
    the rows within its shared memory (M up to ~60,000 without lines)."""
    R0, t0, pts, obs, p_info, valid, ls, le, lobs, l_info, l_valid = args
    if R0.dim() not in (2, 3) or tuple(R0.shape[-2:]) != (3, 3):
        raise ValueError(f"want R0 [3, 3] or [B, 3, 3], got {tuple(R0.shape)}")
    lead = tuple(R0.shape[:-2])
    M, L = pts.shape[-2] if pts.dim() >= 2 else -1, ls.shape[-2] if ls.dim() >= 2 else -1
    want = ((t0, (3,)), (pts, (M, 3)), (obs, (M, 3)), (p_info, (M,)), (valid, (M,)),
            (ls, (L, 3)), (le, (L, 3)), (lobs, (L, 3)), (l_info, (L,)), (l_valid, (L,)))
    for x, shape in want:
        if tuple(x.shape) != lead + shape:
            raise ValueError(f"pose solve: want {list(lead + shape)}, got {tuple(x.shape)} (R0 {tuple(R0.shape)}, "
                             f"points {tuple(pts.shape)}, lines {tuple(ls.shape)})")
    for i, x in enumerate(args):
        want_dtype = torch.bool if i in (5, 10) else torch.float32
        if x.dtype != want_dtype:
            raise TypeError(f"pose solve: argument {i} is {x.dtype}, want {want_dtype}")
        if x.device != R0.device:
            raise ValueError(f"pose solve: inputs on different devices: {R0.device}, {x.device}")
        if kernel and not x.is_contiguous():
            raise ValueError(f"pose solve: argument {i} is not contiguous")
    if rounds < 1 or iters < 1:
        raise ValueError(f"want rounds and iters >= 1, got {rounds}, {iters}")
    if kernel and shared_bytes(M, L, rounds, iters) > MAX_SHARED_BYTES:
        raise ValueError(f"pose solve kernel: M = {M} points and L = {L} lines need "
                         f"{shared_bytes(M, L, rounds, iters)} bytes of shared memory a CTA, above {MAX_SHARED_BYTES}")


def pose_solve_cuda(R0, t0, points_w, obs_uvur, p_info, valid, line_start_w, line_end_w, line_obs, l_info,
                    line_valid, fx: float, fy: float, cx: float, cy: float, bf: float, rounds: int, iters: int):
    """Launch the kernel on the current stream (no synchronisation): one
    solve, or B with a leading [B] on every tensor (one launch of B
    clusters).  Returns what ``pose_solve_plain`` returns, with the same
    leading dimensions."""
    global launches
    args = (R0, t0, points_w, obs_uvur, p_info, valid, line_start_w, line_end_w, line_obs, l_info, line_valid)
    _check_inputs(args, rounds, iters, kernel=True)
    dev = R0.device
    lead = tuple(R0.shape[:-2])
    B = R0.shape[0] if lead else 1
    M, L = points_w.shape[-2], line_start_w.shape[-2]
    R = torch.empty((*lead, 3, 3), dtype=torch.float32, device=dev)
    t = torch.empty((*lead, 3), dtype=torch.float32, device=dev)
    p_in = torch.empty((*lead, M), dtype=torch.bool, device=dev)
    l_in = torch.empty((*lead, L), dtype=torch.bool, device=dev)
    n_in = torch.empty(lead, dtype=torch.int32, device=dev)
    steps = torch.empty((*lead, rounds * iters), dtype=torch.uint8, device=dev)
    fn = _build.kernel("pose_solve", _ARGTYPES)
    _build.launch(fn, "pose_solve", dev, *(x.data_ptr() for x in args), B, M, L, fx, fy, cx, cy, bf, rounds, iters,
                  R.data_ptr(), t.data_ptr(), p_in.data_ptr(), l_in.data_ptr(), n_in.data_ptr(), steps.data_ptr())
    if B > 0:      # with no solves the C function launches nothing
        launches += 1
    return R, t, p_in, l_in, n_in, steps


_SCHEMA = ("(Tensor R0, Tensor t0, Tensor points, Tensor obs, Tensor p_info, Tensor valid, Tensor line_start, "
           "Tensor line_end, Tensor line_obs, Tensor l_info, Tensor l_valid, float fx, float fy, float cx, float cy, "
           "float bf, int rounds, int iters) -> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)")


@torch.library.custom_op("orb_line_slam::pose_solve", mutates_args=(), device_types="cpu", schema=_SCHEMA)
def pose_solve(R0, t0, points, obs, p_info, valid, line_start, line_end, line_obs, l_info, l_valid,
               fx, fy, cx, cy, bf, rounds, iters):
    """One pose solve, or B with a leading [B] on every tensor.  CPU
    tensors: the plain version (for B solves, batched by vmap)."""
    args = (R0, t0, points, obs, p_info, valid, line_start, line_end, line_obs, l_info, l_valid)
    scalars = (fx, fy, cx, cy, bf, rounds, iters)
    _check_inputs(args, rounds, iters, kernel=False)
    if R0.dim() == 2:
        return pose_solve_plain(*args, *scalars)
    return torch.func.vmap(pose_solve_plain, in_dims=(0,) * _N_TENSORS + (None,) * 7)(*args, *scalars)


pose_solve.register_kernel("cuda", pose_solve_cuda)


@pose_solve.register_vmap
def _pose_solve_vmap(info, in_dims, *args):
    """B solves as one call with a leading [B] on every tensor: batched
    arguments moved to the front, unbatched ones repeated B times."""
    B = info.batch_size
    tensors = [x.movedim(d, 0).contiguous() if d is not None else x.expand(B, *x.shape).contiguous()
               for x, d in zip(args[:_N_TENSORS], in_dims[:_N_TENSORS])]
    return pose_solve(*tensors, *args[_N_TENSORS:]), (0,) * 6


def pose_optimize(
    R0: torch.Tensor,
    t0: torch.Tensor,
    points_w: torch.Tensor,   # [M, 3]
    obs_uvur: torch.Tensor,   # [M, 3] (u, v, uR); uR < 0 => mono
    octave: torch.Tensor,     # [M]
    valid: torch.Tensor,      # [M]
    cam: CameraIntrinsics,
    scale_factor: float = 1.2,
    line_start_w: torch.Tensor | None = None,  # [L, 3]
    line_end_w: torch.Tensor | None = None,    # [L, 3]
    line_obs: torch.Tensor | None = None,      # [L, 3] (a, b, c) normalised
    line_octave: torch.Tensor | None = None,   # [L]
    line_valid: torch.Tensor | None = None,    # [L]
    rounds: int = 4,
    iters: int = 10,
) -> PoseOptResult:
    """The pose solve through the operator: the plain version on CPU
    tensors, one kernel launch on CUDA tensors."""
    args = solve_args(R0, t0, points_w, obs_uvur, octave, valid, cam, scale_factor,
                      line_start_w, line_end_w, line_obs, line_octave, line_valid)
    return PoseOptResult(*pose_solve(*args, rounds, iters)[:5])


def pose_optimize_reference(R0, t0, points_w, obs_uvur, octave, valid, cam: CameraIntrinsics,
                            scale_factor: float = 1.2, line_start_w=None, line_end_w=None, line_obs=None,
                            line_octave=None, line_valid=None, rounds: int = 4, iters: int = 10) -> PoseOptResult:
    """The plain version with ``pose_optimize``'s signature, on any device."""
    args = solve_args(R0, t0, points_w, obs_uvur, octave, valid, cam, scale_factor,
                      line_start_w, line_end_w, line_obs, line_octave, line_valid)
    return PoseOptResult(*pose_solve_plain(*args, rounds, iters)[:5])
