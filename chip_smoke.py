#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one GPU.

Drives the port's two paths — stereo point-only tracking on a synthetic
KITTI-size sequence, and stereo point+line tracking with joint
point+line local BA on a synthetic EuRoC-size sequence, both with
synchronous local mapping — through ``System.track_stereo``, after
building the hand-written CUDA kernel from the sources in this checkout
and holding it to its plain PyTorch version.  Run from the root of a
checkout:

    python3 chip_smoke.py

Phases (each fails loudly, and the script exits non-zero):
  1. device: a CUDA card is required; prints its name and power limit;
  2. build: nvcc builds csrc/patch_tiles.cu for sm_90a;
  3. kernel vs plain: patch tiles at both cells' atlas shapes, exact
     equality, CUDA-event times of both at the point cell's;
  4. one frame: build_stereo_frame on the card vs its plain path on the
     CPU, held to the frame contract of tests/test_torch_frontend.py;
  5. the slice: 60 frames, state OK, >= 3 keyframes, >= 1 local BA,
     3 kernel launches per frame, ATE no more than 10% + 1 cm above
     the JAX package's ATE on the same frames and schedule;
  6. one line frame: build_line_features on the card vs its plain path
     on the CPU, on a EuRoC-size pair, held to the line contract of
     tests/test_tpu_parity.py, and its time per stereo pair;
  7. the point+line slice: 60 EuRoC-size frames (BASELINE config #2's
     camera and budgets), state OK, >= 3 keyframes, >= 1 joint
     point+line BA with line observations, >= 10 map lines, line
     inliers on most frames, 3 kernel launches per frame, ATE no more
     than 10% + 1 cm above the JAX package's;
  8. profile: a torch.profiler window of frames 25-35 of phase 7's
     sequence on a fresh System, with record_function ranges around
     the stages: kernels and device ms per frame, device ms per range,
     the top device kernels (printed as a JSON line and a table).
A fixed host-CPU probe is timed at the start and after each slice.
The last line is the JSON device record.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# ATE (m) of the JAX package (orb_line_slam_tpu) on the same 60 frames,
# rendered by orb_line_slam_tpu_torch.data.synthetic with the phase-5
# config, on the same pinned schedule (System(use_loop_closing=False),
# tracker.async_mapping = False, tracker.pipeline_depth = 0), run on the
# CPU with JAX_PLATFORMS=cpu (14 keyframes, final state OK).
JAX_CPU_REFERENCE_ATE_M = 0.01896567472094079
# The same for phase 7: the JAX package on phase 7's 60 frames and
# config, lines on, same schedule, on the CPU (5 keyframes, final state
# OK).
JAX_CPU_REFERENCE_ATE_LINES_M = 0.005195998586362491
# Phase 7's scene (the camera's working volume, m) and speed: 0.025 m per
# frame is 0.5 m/s at EuRoC's 20 Hz.  At 0.05 m/frame a weakly supported
# keyframe late in the sequence can lock a ~0.5 m pose error into the
# map in either package, depending on float rounding and sensor noise
# (PERF.md), so an ATE bound there would test luck.
LINE_SCENE = dict(n_points=700, n_lines=60, seed=3, extent=((-8, 8), (-4, 4), (2, 20)))
LINE_STEP = 0.025

N_FRAMES = 60
WARMUP_FRAMES = 10


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str):
    if not cond:
        fail(msg)


def cuda_times_ms(fn, n: int = 20, reps: int = 1, warmup: int = 3) -> float:
    """Median over n CUDA-event windows of the time per call (ms), each
    window holding `reps` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def kitti_config():
    from orb_line_slam_tpu_torch.config import CameraIntrinsics, LineConfig, OrbConfig, SlamConfig

    cam = CameraIntrinsics(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, bf=386.1448,
                           width=1241, height=376)
    return SlamConfig(camera=cam, orb=OrbConfig(n_features=2000, n_levels=8),
                      lines=LineConfig(enabled=False))


def euroc_config():
    """BASELINE config #2: examples/configs/EuRoC.yaml's rectified camera
    and ORB budget, the default LineConfig (lines on, 128 per frame)."""
    from orb_line_slam_tpu_torch.config import CameraIntrinsics, LineConfig, OrbConfig, SlamConfig

    cam = CameraIntrinsics(fx=435.2046959714599, fy=435.2046959714599, cx=367.4517211914062,
                           cy=252.2008514404297, bf=47.90639384423901, width=752, height=480)
    return SlamConfig(camera=cam, orb=OrbConfig(n_features=1200, n_levels=8), lines=LineConfig())


def host_probe(tag: str):
    """Wall time of a fixed pure-Python loop, min and median of 7: how much
    host CPU this process gets.  The host-clock numbers of two runs are
    comparable only when their probes are."""
    times = []
    for _ in range(7):
        t0 = time.perf_counter()
        acc = 0
        for i in range(200_000):
            acc += i * i
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"host probe ({tag}): {min(times):.2f} ms min, {statistics.median(times):.2f} ms median "
          f"for a fixed Python loop")


def phase_device():
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False: this smoke test needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    host_probe("start")


def phase_build():
    from orb_line_slam_tpu_torch.ops import patches

    t0 = time.perf_counter()
    so = patches.build_library()
    patches._library()
    print(f"build: {os.path.relpath(so, ROOT)} in {time.perf_counter() - t0:.2f} s")


def phase_kernel():
    """Patch tiles on the card at the slice's shapes vs the plain version."""
    import torch

    from orb_line_slam_tpu_torch.ops import patches

    from orb_line_slam_tpu_torch.ops.image import pyramid_shapes

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    # The pyramid atlases of the point cell (1241x376, 2000 features) and
    # of the point+line cell (752x480, 1200 features), 8 levels each.
    err = 0.0
    for w, h0, n in ((1241, 376, 2000), (752, 480, 1200)):
        h = sum(s[0] for s in pyramid_shapes(h0, w, 8, 1.2))
        img = torch.from_numpy((rng.random((h, w)) * 255).astype(np.float32)).to(dev)
        xy = np.stack([rng.integers(-20, w + 20, n), rng.integers(-20, h + 20, n)], -1)
        border = np.array([[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1], [-7, 5], [5, -7],
                           [w + 3, h + 3], [w // 2, h - 3], [w - 1, h // 2], [15, 15], [16, 16], [w - 17, h - 17]])
        xy[: len(border)] = border
        xy = torch.from_numpy(xy.astype(np.int32)).to(dev)
        out = patches.gather_patch_tiles(img, xy)
        ref = patches.patch_tiles_reference(img, xy)
        torch.cuda.synchronize()
        err = max(err, float((out - ref).abs().max()))
        check(torch.equal(out, ref), f"patch tiles at [{h}x{w}] differ from the plain version (max abs err {err})")
        if n == 2000:
            timed = (img, xy, h, w, n)
    img, xy, h, w, n = timed
    # Plain, kernel, kernel, plain; each a median over 20 windows of 50 calls.
    plain_ms = cuda_times_ms(lambda: patches.patch_tiles_reference(img, xy), reps=50)
    ms = cuda_times_ms(lambda: patches.gather_patch_tiles(img, xy), reps=50)
    ms2 = cuda_times_ms(lambda: patches.gather_patch_tiles(img, xy), reps=50)
    plain_ms2 = cuda_times_ms(lambda: patches.patch_tiles_reference(img, xy), reps=50)
    print(f"patch_tiles: exact at both cells' atlases; at [{h}x{w}] N={n}: kernel {ms * 1e3:.2f}/{ms2 * 1e3:.2f} us, "
          f"plain {plain_ms * 1e3:.2f}/{plain_ms2 * 1e3:.2f} us per call "
          f"(median of 20 CUDA-event windows of 50 calls; plain, kernel, kernel, plain)")
    return {"max_abs_err": err, "ms": min(ms, ms2), "plain_ms": min(plain_ms, plain_ms2)}


def render_sequence(cfg, n_frames, scene_kw=None, step=0.25):
    from orb_line_slam_tpu_torch.data.synthetic import SyntheticScene, circular_trajectory

    scene = SyntheticScene(cfg.camera, **(scene_kw or dict(n_points=700, seed=3)))
    poses = circular_trajectory(n_frames, step=step)
    return poses, [scene.render_stereo(R, t) for R, t in poses]


def phase_frame(cfg, pair):
    """build_stereo_frame on the card vs the plain path on the CPU."""
    import torch

    from orb_line_slam_tpu_torch.frontend.frame import build_stereo_frame

    l, r = (torch.from_numpy(x) for x in pair)
    fc = build_stereo_frame(l, r, cfg).numpy()
    lg, rg = l.cuda(), r.cuda()
    fg = build_stereo_frame(lg, rg, cfg).numpy()
    agree = float((fc.valid == fg.valid).mean())
    both = fc.valid & fg.valid
    d_xy = float(np.abs(fc.xy[both] - fg.xy[both]).max())
    bits = np.unpackbits(fc.desc[both] ^ fg.desc[both], axis=1).sum(1)
    dc, dg = fc.depth[both], fg.depth[both]
    hit_agree = float(((dc > 0) == (dg > 0)).mean())
    hit = (dc > 0) & (dg > 0)
    frac = float((np.abs(dc[hit] - dg[hit]) / np.maximum(dg[hit], 1e-6) < 0.01).mean())
    print(f"frame GPU vs CPU: valid agreement {agree:.4f}, max keypoint diff {d_xy:.2e} px, "
          f"median desc bits {np.median(bits):.0f} ({(bits == 0).mean():.4f} identical), "
          f"stereo-hit agreement {hit_agree:.4f}, depths within 1% {frac:.4f} ({int(hit.sum())} depths)")
    check(agree > 0.98 and d_xy < 0.51 and np.median(bits) <= 1 and hit_agree > 0.95 and frac > 0.95,
          "GPU frame breaks the frame contract against the CPU plain path")
    ms = cuda_times_ms(lambda: build_stereo_frame(lg, rg, cfg))
    print(f"front end (build_stereo_frame, 376x1241, 2000 features, 8 levels): {ms:.2f} ms/frame, "
          f"{1e3 / ms:.2f} frames/s (median of 20)")
    return 1e3 / ms


def phase_bench_ba(cfg):
    """bench.py's local-BA shape (32 cams, 16 fixed, 4096 points, 16384
    observations), timed as bench.py times it: solve time / 15."""
    import torch

    from orb_line_slam_tpu_torch.backend.local_ba import bundle_adjust

    cam = cfg.camera
    rng = np.random.default_rng(1)
    C, P, O = 32, 4096, 16384
    pts = np.stack([rng.uniform(-20, 20, P), rng.uniform(-5, 5, P), rng.uniform(5, 60, P)], -1).astype(np.float32)
    R = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
    t = np.zeros((C, 3), np.float32)
    t[:, 0] = np.arange(C) * 0.5
    obs_cam = rng.integers(0, C, O).astype(np.int32)
    obs_lm = rng.integers(0, P, O).astype(np.int32)
    xc = np.einsum("oij,oj->oi", R[obs_cam], pts[obs_lm]) + t[obs_cam]
    z = np.maximum(xc[:, 2], 1.0)
    obs = np.stack([cam.fx * xc[:, 0] / z + cam.cx, cam.fy * xc[:, 1] / z + cam.cy,
                    cam.fx * xc[:, 0] / z + cam.cx - cam.bf / z], -1).astype(np.float32)
    fixed = np.zeros(C, bool)
    fixed[:16] = True
    g = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    args = (g(R), g(t), g(fixed), g(pts), torch.ones(P, dtype=torch.bool, device="cuda"),
            g(obs_cam), g(obs_lm), g(obs), torch.zeros(O, dtype=torch.int32, device="cuda"),
            torch.ones(O, dtype=torch.bool, device="cuda"))

    def run():
        res = bundle_adjust(*args, cam)
        return float(res.chi2)

    run()
    t0 = time.perf_counter()
    run()
    run()
    ms = (time.perf_counter() - t0) / 2 / 15 * 1e3
    print(f"local BA bench shape (C=32, P=4096, O=16384): {ms:.3f} ms per iteration (solve / 15)")
    return ms


def run_slice(cfg, poses, frames, name, dt):
    """Drive System.track_stereo on the card over the frames, with the
    kernel's launch count set to 0 just before and read just after.
    Returns (System, launches, fps over frames WARMUP_FRAMES.., ATE)."""
    import torch

    from orb_line_slam_tpu_torch.eval.trajectory import ate_rmse
    from orb_line_slam_tpu_torch.ops import patches
    from orb_line_slam_tpu_torch.pipeline.system import System

    slam = System(cfg, use_loop_closing=False, device="cuda")
    patches.launches = 0
    stamps = []
    for i, (l, r) in enumerate(frames):
        slam.track_stereo(l, r, timestamp=dt * i)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    slam.shutdown()
    torch.cuda.synchronize()
    launches = patches.launches
    traj = slam.tracker.final_trajectory()
    est = np.stack([-R.T @ t for (_, _, R, t, _) in traj])
    gt = np.stack([-R.T @ t for (R, t) in poses])
    check(np.isfinite(est).all() and est.shape == gt.shape, f"{name}: trajectory not finite / wrong shape {est.shape}")
    ate = float(ate_rmse(est, gt, align=True))
    fps = (len(frames) - WARMUP_FRAMES) / (stamps[-1] - stamps[WARMUP_FRAMES - 1])
    n_kf = int(slam.map.n_keyframes())
    host_probe(f"after the {name}")
    print(f"{name}: {len(frames)} frames, state {slam.tracking_state()}, {n_kf} keyframes, "
          f"{slam.tracker.n_local_ba} local BAs, {launches} patch-tile launches")
    print(f"{name} stages: " + json.dumps(slam.tracker.timing.table(len(frames))))
    check(slam.tracking_state() == "OK", f"{name}: final state {slam.tracking_state()}")
    check(n_kf >= 3, f"{name}: only {n_kf} keyframes")
    check(slam.tracker.n_local_ba >= 1, f"{name}: no local BA ran")
    check(launches == 3 * len(frames), f"{name}: {launches} kernel launches for {len(frames)} frames (want 3 per frame)")
    return slam, launches, fps, ate


def check_ate(name, ate, ref):
    """ATE is an error: the port may not be worse than the JAX package by
    more than 10% + 1 cm.  A lower error is not a fault: which frames
    become keyframes moves either package's ATE between a few modes."""
    bound = 1.1 * ref + 0.01
    check(ate <= bound, f"{name}: ATE {ate:.5f} m exceeds {bound:.5f} m (JAX reference {ref:.5f} m + 10% + 1 cm)")


def phase_slice(cfg, poses, frames):
    slam, launches, fps, ate = run_slice(cfg, poses, frames, "slice", 0.1)
    ba = slam.tracker.timing.table().get("local_ba", {"ms_per_call": float("nan")})
    print(f"slice: {fps:.2f} frames/s steady state (frames {WARMUP_FRAMES}-{len(frames) - 1}), "
          f"{ba['ms_per_call']:.1f} ms per local BA, ATE {ate:.5f} m "
          f"(JAX CPU reference {JAX_CPU_REFERENCE_ATE_M:.5f} m)")
    check_ate("slice", ate, JAX_CPU_REFERENCE_ATE_M)
    return launches, fps, ba["ms_per_call"], ate


def phase_line_frame(cfg, pair):
    """build_line_features on the card vs the plain path on the CPU, held
    to the line contract of tests/test_tpu_parity.py:213-250."""
    import torch

    from orb_line_slam_tpu_torch.frontend.line_extractor import build_line_features

    l, r = (torch.from_numpy(x) for x in pair)
    lc = build_line_features(l, r, cfg.camera, cfg.lines).numpy()
    lg, rg = l.cuda(), r.cuda()
    lgpu = build_line_features(lg, rg, cfg.camera, cfg.lines).numpy()
    agree = float((lc.valid == lgpu.valid).mean())
    both = lc.valid & lgpu.valid
    d_ep = np.maximum(np.abs(lc.p0 - lgpu.p0).max(-1), np.abs(lc.p1 - lgpu.p1).max(-1))[both]
    bits = np.unpackbits(lc.desc[both] ^ lgpu.desc[both], axis=1).sum(1)
    rels = []
    for dc, dg in ((lc.depth0[both], lgpu.depth0[both]), (lc.depth1[both], lgpu.depth1[both])):
        hit = (dc > 0) & (dg > 0)
        rels.append(np.abs(dc[hit] - dg[hit]) / dg[hit])
    rel = np.concatenate(rels)
    med_rel = float(np.median(rel)) if len(rel) else float("nan")
    print(f"line frame GPU vs CPU: valid agreement {agree:.4f}, {int(both.sum())} common lines, "
          f"median endpoint diff {np.median(d_ep):.2e} px (max {d_ep.max():.2e}), median LBD bits "
          f"{np.median(bits):.0f} ({(bits == 0).mean():.4f} identical), median depth diff {med_rel:.2e} "
          f"({len(rel)} endpoint depths)")
    check(agree > 0.9 and both.sum() >= 8 and np.median(d_ep) < 1.0 and np.median(bits) <= 8
          and len(rel) >= 3 and med_rel < 0.02,
          "GPU line features break the line contract against the CPU plain path")
    ms = cuda_times_ms(lambda: build_line_features(lg, rg, cfg.camera, cfg.lines))
    print(f"line front end (build_line_features, 480x752, {cfg.lines.n_lines} lines): {ms:.2f} ms per stereo pair "
          f"(median of 20)")
    return ms


def phase_line_slice(cfg, poses, frames):
    slam, launches, fps, ate = run_slice(cfg, poses, frames, "point+line slice", 0.05)
    tr = slam.tracker
    n_lines = int(slam.map.ln_valid.sum())
    tracked = [s for s in tr.stats if s["state"] == "OK"]
    with_lines = sum(s["line_inliers"] > 0 for s in tracked)
    ba = tr.timing.table().get("joint_ba", {"ms_per_call": float("nan")})
    print(f"point+line slice: {fps:.2f} frames/s steady state (frames {WARMUP_FRAMES}-{len(frames) - 1}), "
          f"{len(tr.joint_ba_lobs)} joint BAs ({ba['ms_per_call']:.1f} ms per solve, line observations "
          f"{tr.joint_ba_lobs}), {n_lines} map lines, line inliers on {with_lines}/{len(tracked)} tracked frames, "
          f"ATE {ate:.5f} m (JAX CPU reference {JAX_CPU_REFERENCE_ATE_LINES_M:.5f} m)")
    check(len(tr.joint_ba_lobs) >= 1 and max(tr.joint_ba_lobs) >= 1, "no joint point+line BA with line observations")
    check(n_lines >= 10, f"only {n_lines} map lines")
    check(with_lines > 0.5 * len(tracked), f"line inliers on only {with_lines}/{len(tracked)} tracked frames")
    check_ate("point+line slice", ate, JAX_CPU_REFERENCE_ATE_LINES_M)
    return launches, fps, ba["ms_per_call"], ate


PROFILE_START, PROFILE_FRAMES = 25, 11
# (module, function, range name): the stages a profile range is opened
# around.  Nested ranges (the line pose terms inside the tracking step,
# the segment sums inside the joint BA) count inside their parents too.
PROFILE_RANGES = (
    ("pipeline.tracking", "build_stereo_frame", "point_frontend"),
    ("pipeline.tracking", "build_line_features", "line_frontend"),
    ("pipeline.tracking", "track_step", "track_step"),
    ("pipeline.track_step", "search_lines_by_projection", "line_search"),
    ("backend.pose_opt", "line_residual_and_jacobian", "line_pose_terms"),
    ("pipeline.tracking", "bundle_adjust_pl", "joint_ba"),
    ("backend.line_ba", "_segment_sum", "joint_ba_segment_sums"),
    ("ops.lines", "nearest_sample", "line_walk_gather"),
    ("ops.lbd", "bilinear_sample", "lbd_band_gather"),
    ("frontend.line_extractor", "_sad_refine", "line_sad"),
)


def phase_profile(cfg, frames):
    """torch.profiler over frames PROFILE_START.. of phase 7's sequence
    (keyframe 34 and its joint BA fall inside), after the earlier frames
    unprofiled, on a fresh System.  Device time per range is the sum of
    the device kernels that start inside the range's device interval."""
    import bisect
    import importlib

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from orb_line_slam_tpu_torch.pipeline.system import System

    saved = []

    def labelled(fn, tag):
        def wrapper(*a, **k):
            with record_function(tag):
                return fn(*a, **k)
        return wrapper

    for mod_name, fn_name, tag in PROFILE_RANGES:
        mod = importlib.import_module(f"orb_line_slam_tpu_torch.{mod_name}")
        saved.append((mod, fn_name, getattr(mod, fn_name)))
        setattr(mod, fn_name, labelled(getattr(mod, fn_name), tag))
    try:
        slam = System(cfg, use_loop_closing=False, device="cuda")
        for i in range(PROFILE_START):
            slam.track_stereo(*frames[i], timestamp=0.05 * i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(PROFILE_START, PROFILE_START + PROFILE_FRAMES):
                slam.track_stereo(*frames[i], timestamp=0.05 * i)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        slam.shutdown()
    finally:
        for mod, fn_name, fn in saved:
            setattr(mod, fn_name, fn)
    n = PROFILE_FRAMES
    tags = [tag for _, _, tag in PROFILE_RANGES]
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    ranges = [e for e in dev if e.name in tags]
    kern = sorted((e for e in dev if e.name not in tags and not e.name.startswith("ProfilerStep")),
                  key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in kern]
    csum = [0.0]
    for e in kern:
        csum.append(csum[-1] + e.time_range.end - e.time_range.start)
    busy_us = csum[-1]
    check(busy_us > 0 and ranges, "profile: no device kernels or no device ranges recorded")
    per = dict.fromkeys(tags, 0.0)
    calls = dict.fromkeys(tags, 0)
    for r in ranges:
        i = bisect.bisect_left(starts, r.time_range.start)
        j = bisect.bisect_right(starts, r.time_range.end)
        per[r.name] += csum[j] - csum[i]
        calls[r.name] += 1
    launches = sum(e.count for e in prof.key_averages()
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    by_name = {}
    for e in kern:
        d = by_name.setdefault(e.name, [0.0, 0])
        d[0] += e.time_range.end - e.time_range.start
        d[1] += 1
    print(json.dumps({"profile": {
        "frames": f"{PROFILE_START}-{PROFILE_START + n - 1}", "wall_ms_per_frame_profiled": wall * 1e3 / n,
        "device_busy_ms_per_frame": busy_us / 1e3 / n, "kernels_per_frame": len(kern) / n,
        "kernel_launch_calls_per_frame": launches / n, "device_idle_share_profiled": 1 - busy_us / 1e6 / wall,
        "range_device_ms_per_frame": {k: v / 1e3 / n for k, v in per.items()},
        "range_device_ms_per_call": {k: (per[k] / 1e3 / calls[k] if calls[k] else None) for k in tags},
        "range_calls": calls,
        "range_share_of_busy": {k: v / busy_us for k, v in per.items()},
    }}))
    for name, (d, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"profile top kernel: {d / 1e3 / n:8.3f} ms/frame {c / n:8.1f} calls/frame  {name[:110]}")


def main():
    if not os.path.isdir(os.path.join(ROOT, "orb_line_slam_tpu_torch")):
        fail("orb_line_slam_tpu_torch/ not found beside chip_smoke.py: run from a checkout of the repo")
    sys.path.insert(0, ROOT)
    import torch

    phase_device()
    import orb_line_slam_tpu_torch  # noqa: F401  (sets the fp32 policy)

    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
          "TF32 is enabled")
    phase_build()
    kern = phase_kernel()
    cfg = kitti_config()
    t0 = time.perf_counter()
    poses, frames = render_sequence(cfg, N_FRAMES)
    print(f"rendered {N_FRAMES} stereo pairs in {time.perf_counter() - t0:.1f} s (host, set-up)")
    fe_fps = phase_frame(cfg, frames[0])
    ba_iter_ms = phase_bench_ba(cfg)
    launches, fps, ba_ms, ate = phase_slice(cfg, poses, frames)
    lcfg = euroc_config()
    t0 = time.perf_counter()
    lposes, lframes = render_sequence(lcfg, N_FRAMES, LINE_SCENE, LINE_STEP)
    print(f"rendered {N_FRAMES} EuRoC-size stereo pairs with lines in {time.perf_counter() - t0:.1f} s (host, set-up)")
    line_ms = phase_line_frame(lcfg, lframes[0])
    l_launches, l_fps, joint_ms, l_ate = phase_line_slice(lcfg, lposes, lframes)
    launches += l_launches
    phase_profile(lcfg, lframes)
    print(json.dumps({
        "stereo_frontend_fps": fe_fps, "full_pipeline_fps": fps, "local_ba_iter_ms": ba_iter_ms,
        "local_ba_ms_per_solve": ba_ms, "ate_rmse_synth_m": ate,
        "line_frontend_ms": line_ms, "lines_pipeline_fps": l_fps, "joint_ba_ms_per_solve": joint_ms,
        "ate_rmse_lines_m": l_ate,
    }))
    print(json.dumps({"kernels": [{
        "name": "patch_tiles", "route": "cuda",
        "source": "orb_line_slam_tpu_torch/csrc/patch_tiles.cu",
        "replaces": "orb_line_slam_tpu/ops/pallas_patches.py:99",
        "launches": launches, **kern,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
