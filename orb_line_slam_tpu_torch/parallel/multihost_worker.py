"""One process of a multi-process distributed global BA.

The port's counterpart of ``tools/multihost_gba_worker.py``.  Each of
``nprocs`` processes joins the group at ``coordinator`` (``host:port``)
through ``multihost.initialize``, builds the same problem from a fixed
seed, solves it landmark-sharded over the global mesh and writes its
replicated outputs (R, t, chi2) and its own shards' landmarks and inlier
flags to ``<out>.rank<pid>.npz``.  Process 0 also writes the port's
single-process dense ``bundle_adjust`` result of the same problem.

    python -m orb_line_slam_tpu_torch.parallel.multihost_worker \\
        <coordinator> <nprocs> <pid> <out> [--local-shards N] [--device cuda|cpu]
        [--backend gloo|nccl] [--problem small|dryrun] [--timed-runs K]

One torch thread per process; a group that does not form within 120 s
raises.

``small`` is the JAX worker's problem (seed 3: 12 cameras, 512
landmarks, 3,072 observations; 5 + 10 LM iterations of 48 CG steps);
``dryrun`` is ``parallel/dryrun.py``'s production-scale one.  The N
local shards share ``cuda:0`` (the default; no card raises) or, with
``--device cpu``, the CPU.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..backend.local_ba import bundle_adjust
from ..config import CameraIntrinsics
from . import multihost
from .dryrun import DRYRUN_ITERS, dryrun_problem
from .sharded_ba import distributed_ba_cg, shard_gba_pack

SMALL_ITERS = (5, 10, 48)


def small_problem():
    """tools/multihost_gba_worker.py's problem, as a pack dict."""
    cam = CameraIntrinsics(fx=400.0, fy=400.0, cx=320.0, cy=160.0, bf=160.0, width=640, height=320)
    rng = np.random.default_rng(3)
    C, Pn, O = 12, 512, 3072
    pts = np.stack([rng.uniform(-15, 15, Pn), rng.uniform(-4, 4, Pn), rng.uniform(5, 50, Pn)], -1).astype(np.float32)
    R = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
    t = np.zeros((C, 3), np.float32)
    t[:, 0] = np.arange(C) * 0.4
    oc = rng.integers(0, C, O).astype(np.int32)
    ol = rng.integers(0, Pn, O).astype(np.int32)
    xc = np.einsum("oij,oj->oi", R[oc], pts[ol]) + t[oc]
    z = np.maximum(xc[:, 2], 1.0)
    obs = np.stack([cam.fx * xc[:, 0] / z + cam.cx, cam.fy * xc[:, 1] / z + cam.cy,
                    cam.fx * xc[:, 0] / z + cam.cx - cam.bf / z], -1).astype(np.float32)
    obs += rng.normal(0, 0.3, obs.shape).astype(np.float32)
    pts_noisy = (pts + rng.normal(0, 0.03, pts.shape)).astype(np.float32)
    fixed = np.zeros(C, bool)
    fixed[0] = True
    pack = dict(R=R, t=t, cam_fixed=fixed, points=pts_noisy, point_valid=np.ones(Pn, bool), obs_cam=oc,
                obs_lm=ol, obs_uvur=obs, obs_oct=np.zeros(O, np.int32), obs_valid=np.ones(O, bool))
    return cam, pack


def run(args) -> dict:
    """Join, solve, and return what this rank writes."""
    torch.set_num_threads(1)
    shards = args.local_shards if args.device == "cpu" else [torch.device(args.device)] * args.local_shards
    mesh = multihost.initialize(args.coordinator, args.nprocs, args.pid, local_shards=shards,
                                backend=args.backend)
    try:
        if args.problem == "small":
            cam, pack = small_problem()
            sharded, _ = shard_gba_pack(pack, mesh.n_shards)
            iters = SMALL_ITERS
        else:
            cam, sharded, _, _ = dryrun_problem(mesh.n_shards)
            iters = DRYRUN_ITERS
        i1, i2, ncg = iters

        def solve():
            mesh.reset_counts()
            return [x.cpu().numpy() for x in distributed_ba_cg(mesh, cam, *sharded, iters1=i1, iters2=i2,
                                                               cg_iters=ncg)]

        t0 = time.perf_counter()
        R, t, pts, inl, chi2 = solve()
        times = [time.perf_counter() - t0]
        for _ in range(args.timed_runs):
            t0 = time.perf_counter()
            solve()
            times.append(time.perf_counter() - t0)
        out = dict(R=R, t=t, chi2=chi2, points_local=pts, inlier_local=inl, first=mesh.first,
                   n_local=mesh.n_local, n_shards=mesh.n_shards, nprocs=args.nprocs,
                   solve_s=np.array(times), reductions=mesh.n_reductions, reduced_bytes=mesh.reduced_bytes,
                   collectives=mesh.n_collectives)
        if args.pid == 0 and args.problem == "small":
            dense = bundle_adjust(*(torch.from_numpy(np.array(pack[k])) for k in (
                "R", "t", "cam_fixed", "points", "point_valid", "obs_cam", "obs_lm", "obs_uvur", "obs_oct",
                "obs_valid")), cam, 1.2)
            out["R_dense"], out["t_dense"] = dense.R.numpy(), dense.t.numpy()
        return out
    finally:
        multihost.shutdown()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("coordinator")
    ap.add_argument("nprocs", type=int)
    ap.add_argument("pid", type=int)
    ap.add_argument("out")
    ap.add_argument("--local-shards", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--problem", choices=("small", "dryrun"), default="small")
    ap.add_argument("--timed-runs", type=int, default=0)
    args = ap.parse_args(argv)
    np.savez(f"{args.out}.rank{args.pid}.npz", **run(args))
    print(f"rank {args.pid} of {args.nprocs}: done", flush=True)


if __name__ == "__main__":
    main()
