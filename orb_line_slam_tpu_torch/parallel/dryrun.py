"""The distributed global BA at production scale, against the single solver.

Port of ``__graft_entry__.py::_make_gba_problem`` and
``dryrun_multichip`` (35-180): 256 cameras, 65,536 landmarks and 262,144
observations (four per landmark), two LM iterations of 12 CG steps,
solved landmark-sharded over a mesh and by the single-device
``bundle_adjust_cg`` on the same problem.  Where the mesh's shards share
one device, ``t_single / t_mesh`` is the overhead of the sharding
machinery (more, smaller launches and the reductions) on that device, not
a scaling across devices.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..backend.global_ba import bundle_adjust_cg
from ..config import CameraIntrinsics
from .multihost import device_mesh
from .sharded_ba import distributed_ba_cg

DRYRUN_CAMERAS = 256
DRYRUN_POINTS = 65536
DRYRUN_OBS_PER_POINT = 4
DRYRUN_ITERS = (2, 0, 12)     # LM stage 1, stage 2, CG steps


def make_gba_problem(n_shards: int, C: int, p_per: int, obs_per_lm: int, seed: int = 0):
    """A global-BA problem with its observations grouped by landmark shard
    (``obs_lm`` local to each shard): cameras along a line, landmarks in a
    corridor around it, each seen by ``obs_per_lm`` cameras near its x.
    Returns (cam, R0, t0, pts, oc, ol, ouv, ooct, oval); the observation
    arrays are [n_shards, p_per * obs_per_lm]."""
    cam = CameraIntrinsics(fx=400.0, fy=400.0, cx=320.0, cy=160.0, bf=160.0, width=640, height=320)
    rng = np.random.default_rng(seed)
    P = p_per * n_shards
    t0 = np.zeros((C, 3), np.float32)
    t0[:, 0] = -0.3 * np.arange(C)
    R0 = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
    pts = np.stack([rng.uniform(0, 0.3 * C, P), rng.uniform(-3, 3, P), rng.uniform(4, 20, P)], -1).astype(np.float32)
    o_per = p_per * obs_per_lm
    oc = np.zeros((n_shards, o_per), np.int32)
    ol = np.zeros((n_shards, o_per), np.int32)
    ouv = np.zeros((n_shards, o_per, 3), np.float32)
    for d in range(n_shards):
        lm = np.arange(p_per)
        gid = d * p_per + lm
        base_cam = np.clip((pts[gid, 0] / 0.3).astype(np.int32), 0, C - obs_per_lm)
        for j in range(obs_per_lm):
            c = base_cam + j
            sl = slice(j * p_per, (j + 1) * p_per)
            oc[d, sl] = c
            ol[d, sl] = lm
            pc = pts[gid] + t0[c]
            z = np.maximum(pc[:, 2], 0.5)
            u = cam.fx * pc[:, 0] / z + cam.cx
            ouv[d, sl, 0] = u
            ouv[d, sl, 1] = cam.fy * pc[:, 1] / z + cam.cy
            ouv[d, sl, 2] = u - cam.bf / z
    ooct = np.zeros((n_shards, o_per), np.int32)
    oval = np.ones((n_shards, o_per), bool)
    return cam, R0, t0, pts, oc, ol, ouv, ooct, oval


def dryrun_problem(n_shards: int):
    """The production-scale problem laid out for n_shards: (cam, sharded
    args in the solvers' input order, the same problem with global
    landmark indices for the single solver, true landmarks)."""
    C, p_per = DRYRUN_CAMERAS, DRYRUN_POINTS // n_shards
    cam, R0, t0, pts, oc, ol, ouv, ooct, oval = make_gba_problem(n_shards, C, p_per, DRYRUN_OBS_PER_POINT)
    rng = np.random.default_rng(1)
    pts0 = (pts + rng.normal(0, 0.05, pts.shape)).astype(np.float32)
    fixed = np.zeros(C, bool)
    fixed[0] = True
    gl = ol + (np.arange(n_shards, dtype=np.int32) * p_per)[:, None]
    flat = (oc.reshape(-1), ol.reshape(-1), ouv.reshape(-1, 3), ooct.reshape(-1), oval.reshape(-1))
    sharded = (R0, t0, fixed, pts0, np.ones(len(pts), bool)) + flat
    single = sharded[:6] + (gl.reshape(-1),) + flat[2:]
    return cam, sharded, single, pts


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device):
    """(result, seconds) of fn's second call; the first warms up."""
    fn()
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def dryrun_multichip(n_shards: int, device="cuda") -> dict:
    """The production-scale distributed CG global BA on n_shards slots of
    ``device``, then the identical problem through the
    single-device ``bundle_adjust_cg`` with the same iterations.  Returns
    the median landmark error against the truth (must stay < 0.05 m), the
    largest camera translation difference to the single solve, the two
    solve times (second call of each, device synchronised), their ratio,
    the mesh's reductions per solve, the mesh solve's R, t, points, and
    the two solves as functions (``solve_mesh``, ``solve_single``) for a
    profiler."""
    mesh = device_mesh(device, n_shards)
    home = mesh.home
    cam, sharded, single, pts_true = dryrun_problem(n_shards)
    i1, i2, ncg = DRYRUN_ITERS
    margs = tuple(torch.from_numpy(a).to(home) for a in sharded)

    def solve_mesh():
        mesh.reset_counts()
        return distributed_ba_cg(mesh, cam, *margs, iters1=i1, iters2=i2, cg_iters=ncg)

    sargs = tuple(torch.from_numpy(a).to(home) for a in single)

    def solve_single():
        return bundle_adjust_cg(*sargs, cam, iters1=i1, iters2=i2, cg_iters=ncg)

    (R1, t1, pts1, _, chi2), t_mesh = _timed(solve_mesh, home)
    ref, t_single = _timed(solve_single, home)
    pts_mesh = pts1.cpu().numpy()
    err = float(np.median(np.linalg.norm(pts_mesh - pts_true, axis=-1)))
    if not np.isfinite(err) or err >= 0.05:
        raise RuntimeError(f"distributed BA diverged: median landmark error {err}")
    return {
        "n_shards": n_shards, "cameras": DRYRUN_CAMERAS, "points": len(pts_true),
        "observations": len(single[5]), "median_landmark_err_m": err,
        "pose_agreement_m": float((ref.t - t1).abs().max()), "t_mesh_s": t_mesh, "t_single_s": t_single,
        "efficiency": t_single / t_mesh, "reductions": mesh.n_reductions, "reduced_bytes": mesh.reduced_bytes,
        "collectives": mesh.n_collectives, "chi2": float(chi2),
        "R": R1.cpu().numpy(), "t": t1.cpu().numpy(), "points": pts_mesh,
        "solve_mesh": solve_mesh, "solve_single": solve_single,
    }
