#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one GPU.

Drives the port's three paths — stereo point-only tracking on a
synthetic KITTI-size sequence, stereo point+line tracking with joint
point+line local BA on a synthetic EuRoC-size sequence, and a closed
circuit with loop closing on (detection, Sim3, correction, essential
graph, global BA), all with synchronous local mapping — through
``System.track_stereo``, after building the hand-written CUDA kernel
from the sources in this checkout and holding it to its plain PyTorch
version.  Run from the root of a checkout:

    python3 chip_smoke.py

Phases (each fails loudly, and the script exits non-zero):
  1. device: a CUDA card is required; prints its name and power limit;
  2. build: nvcc builds csrc/patch_tiles.cu for sm_90a;
  3. kernel vs plain: patch tiles at each of the three cells' atlas
     shapes and feature budgets (8, 8 and 4 pyramid levels), exact
     equality; at each, CUDA-event times of the kernel, the plain
     version and one indexing call, the kernel's own device time, and
     the bound from the bytes that input needs;
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
  8. profile: a torch.profiler window of frames 33-35 of phase 7's
     sequence on a fresh System, with record_function ranges around
     the stages: kernels and device ms per frame, device ms per range,
     the top device kernels (printed as a JSON line and a table);
  9. loop components on the card vs the same code on CPU tensors, at
     real sizes, with CUDA-event or host-clock times and the device time
     of one call under torch.profiler: the word descent
     of 2000 descriptors through a 10^5-word vocabulary (identical
     words), Sim3 RANSAC (N = 256, 256 hypotheses) and refinement
     (N = 512) on a pair with 30% outliers, the pose graph at K = 128
     on a drifted 100-keyframe ring with one loop edge, and the
     matrix-free CG global BA at the default map capacity (512 cameras,
     65,536 points, 524,288 observations; held to the CPU over its
     first two LM iterations, to the truth over all twelve);
 10. the loop slice: bench.py's 170-frame closed circuit with
     use_loop_closing=True, state OK, >= 1 loop closed, >= 1 global BA
     applied (the dense joint point+line solve), 3 kernel launches per
     frame, ATE no more than 10% + 1 cm above the JAX package's and
     below that of the port's own run without loop closing, and the
     closing keyframe's position error seen from the loop keyframe
     smaller after the closure than before it; then a torch.profiler
     window of frames 30-32 of the
     circuit with loop closing on (kernels, device ms and idle share per
     frame, device ms of the loop closer's per-keyframe work).
A fixed host-CPU probe is timed at the start and after each slice, and
the seconds since the start are printed after each group of phases.
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

# The loop slice: bench.py::_bench_ate's circuit (bench.py:251-285).  ATE
# (m) of the JAX package on these 170 frames, rendered by
# orb_line_slam_tpu_torch.data.synthetic, use_loop_closing=True,
# async_loop=False, tracker.async_mapping = False, pipeline_depth = 0,
# gba_async = False, on the CPU with JAX_PLATFORMS=cpu: 1 loop closed
# (at the keyframe event of frame 155), 52 keyframes, final state OK.
# The same run with use_loop_closing=False gives 0.032101357466846114 m
# (58 keyframes).
JAX_CPU_REFERENCE_ATE_LOOP_M = 0.025552260523899487
LOOP_FRAMES, LOOP_RADIUS, LOOP_LAPS = 170, 8.0, 1.12
LOOP_SCENE = dict(n_points=1600, seed=5, extent=((-24, 40), (-4, 4), (-32, 32)))
LOOP_NOISE_SIGMA = 6.0

# NVIDIA H100 SXM data sheet: HBM3 bandwidth (bytes/s), float32 rate
# outside the tensor cores (FLOP/s).
H100_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS = 67e12

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


def loop_config():
    """bench.py::_bench_ate's wide-FOV validation rig and budgets."""
    from orb_line_slam_tpu_torch.config import CameraIntrinsics, LineConfig, MapConfig, OrbConfig, SlamConfig

    cam = CameraIntrinsics(fx=320.0, fy=320.0, cx=320.0, cy=160.0, bf=160.0, width=640, height=320)
    return SlamConfig(camera=cam, orb=OrbConfig(n_features=1000, n_levels=4),
                      lines=LineConfig(enabled=True, n_lines=64),
                      map=MapConfig(max_keyframes=128, max_points=16384, max_lines=1024,
                                    local_window=8, local_points=4096))


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


def phase_kernel(cells):
    """Patch tiles on the card at every cell's atlas shape (the padded
    pyramid of its image size and level count, its feature budget) vs the
    plain version: exact equality, then CUDA-event times of the kernel,
    the plain version and one library call, the kernel's own device time
    under torch.profiler, and the bound from the bytes this input needs.
    Returns the kernels-line record: the first cell's numbers at the top
    level, every cell's under ``by_shape``."""
    import torch

    from orb_line_slam_tpu_torch.ops import patches
    from orb_line_slam_tpu_torch.ops.image import pyramid_shapes

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    records = []
    for name, cfg in cells:
        w, n, levels = cfg.camera.width, cfg.orb.n_features, cfg.orb.n_levels
        h = sum(s[0] for s in pyramid_shapes(cfg.camera.height, w, levels, cfg.orb.scale_factor))
        img = torch.from_numpy((rng.random((h, w)) * 255).astype(np.float32)).to(dev)
        xy = np.stack([rng.integers(-20, w + 20, n), rng.integers(-20, h + 20, n)], -1)
        border = np.array([[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1], [-7, 5], [5, -7],
                           [w + 3, h + 3], [w // 2, h - 3], [w - 1, h // 2], [15, 15], [16, 16], [w - 17, h - 17]])
        xy[: len(border)] = border
        xy = torch.from_numpy(xy.astype(np.int32)).to(dev)
        out = patches.gather_patch_tiles(img, xy)
        ref = patches.patch_tiles_reference(img, xy)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        check(torch.equal(out, ref), f"patch tiles at [{h}x{w}] N={n} differ from the plain version (max abs err {err})")
        # The nearest single PyTorch call: one advanced-indexing gather with
        # the [N, 32, 32] index tensors built beforehand (the plain version
        # builds them inside the timed call).
        d = torch.arange(patches.PATCH, device=dev)
        iy = (torch.clamp(xy[:, 1] - 15, 0, h - patches.PATCH).long()[:, None, None] + d[None, :, None]).expand(n, 32, 32).contiguous()
        ix = (torch.clamp(xy[:, 0] - 15, 0, w - patches.PATCH).long()[:, None, None] + d[None, None, :]).expand(n, 32, 32).contiguous()
        check(torch.equal(img[iy, ix], ref), "library gather differs from the plain version")
        # Plain, kernel, library, library, kernel, plain; each a median over
        # 20 windows of 50 calls.
        plain_ms = cuda_times_ms(lambda: patches.patch_tiles_reference(img, xy), reps=50)
        ms = cuda_times_ms(lambda: patches.gather_patch_tiles(img, xy), reps=50)
        lib_ms = cuda_times_ms(lambda: img[iy, ix], reps=50)
        lib_ms2 = cuda_times_ms(lambda: img[iy, ix], reps=50)
        ms2 = cuda_times_ms(lambda: patches.gather_patch_tiles(img, xy), reps=50)
        plain_ms2 = cuda_times_ms(lambda: patches.patch_tiles_reference(img, xy), reps=50)
        own, n_k = device_ms(lambda: [patches.gather_patch_tiles(img, xy) for _ in range(20)])
        check(n_k == 20, f"the wrapper launched {n_k} device kernels for 20 calls")
        # The least the card could take, by bytes (the kernel computes
        # nothing but addresses): every atlas pixel that lies under some
        # tile read once, the keypoints read once, every tile written once,
        # at the HBM rate.
        covered = torch.zeros((h, w), dtype=torch.bool, device=dev)
        covered[iy, ix] = True
        n_read = int(covered.sum()) * 4 + xy.numel() * 4
        n_written = n * patches.PATCH * patches.PATCH * 4
        bound_ms = (n_read + n_written) / H100_BYTES_PER_S * 1e3
        print(f"patch_tiles ({name}: atlas [{h}x{w}], {levels} levels, N={n}): exact; kernel {ms * 1e3:.2f}/{ms2 * 1e3:.2f} us, "
              f"plain {plain_ms * 1e3:.2f}/{plain_ms2 * 1e3:.2f} us, one indexing call with prebuilt indices "
              f"{lib_ms * 1e3:.2f}/{lib_ms2 * 1e3:.2f} us per call (median of 20 CUDA-event windows of 50 calls; "
              f"plain, kernel, library, library, kernel, plain); kernel's own device time {own / 20 * 1e3:.2f} us "
              f"(torch.profiler, mean of 20); bound {bound_ms * 1e3:.2f} us ({n_read} bytes read: "
              f"{int(covered.sum())} of {h * w} atlas pixels lie under a tile; {n_written} bytes written; "
              f"at {H100_BYTES_PER_S / 1e12:.2f} TB/s)")
        records.append({"shape": f"{name}: atlas [{h}x{w}], N={n}", "max_abs_err": err, "ms": min(ms, ms2),
                        "plain_ms": min(plain_ms, plain_ms2), "bound_ms": bound_ms, "bound_by": "bytes",
                        "library_ms": min(lib_ms, lib_ms2), "device_ms": own / 20})
    return {**records[0], "max_abs_err": max(r["max_abs_err"] for r in records), "by_shape": records}


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


def run_slice(cfg, poses, frames, name, dt, use_loop_closing=False):
    """Drive System.track_stereo on the card over the frames, with the
    kernel's launch count set to 0 just before and read just after.
    Returns (System, launches, fps over frames WARMUP_FRAMES.., ATE)."""
    import torch

    from orb_line_slam_tpu_torch.eval.trajectory import ate_rmse
    from orb_line_slam_tpu_torch.ops import patches
    from orb_line_slam_tpu_torch.pipeline.system import System

    slam = System(cfg, use_loop_closing=use_loop_closing, device="cuda")
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


def _rot(rotvec):
    """Rotation matrix of an axis-angle vector (Rodrigues, numpy)."""
    th = float(np.linalg.norm(rotvec))
    if th < 1e-12:
        return np.eye(3, dtype=np.float32)
    k = np.asarray(rotvec, np.float64) / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return (np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K).astype(np.float32)


def _rot_angle(Ra, Rb):
    d = np.asarray(Ra, np.float64) @ np.swapaxes(np.asarray(Rb, np.float64), -1, -2)
    w = np.stack([d[..., 2, 1] - d[..., 1, 2], d[..., 0, 2] - d[..., 2, 0], d[..., 1, 0] - d[..., 0, 1]], -1)
    return np.arcsin(np.clip(np.linalg.norm(w, axis=-1) / 2, 0, 1))


def host_times_ms(fn, n=5):
    """Median host-clock time (ms) of fn, which must end synchronised."""
    fn()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_ms(fn):
    """(device-busy ms, kernels) of one call of fn under torch.profiler:
    the sum of the device kernels' own times, whatever the host took."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    check(len(kern) > 0, "profiler recorded no device kernel")
    return sum(e.time_range.end - e.time_range.start for e in kern) / 1e3, len(kern)


def phase_loop_words(frame, k=10, depth=5):
    """Word descent of a real frame's descriptors through a synthetic
    k^depth-word vocabulary: the card's words against the CPU's."""
    import torch

    from orb_line_slam_tpu_torch.loop.vocabulary import Vocabulary

    voc = Vocabulary.synthesize(k=k, depth=depth)
    desc = frame.desc
    check(desc.is_cuda, "phase 9 wants the frame's descriptors on the card")
    words = voc.dispatch_transform(desc)
    words_cpu = voc.dispatch_transform(frame.desc.cpu())
    check(torch.equal(words.cpu(), words_cpu), "vocabulary words on the card differ from the CPU's")
    check(int(words.min()) >= 0 and int(words.max()) < voc.n_words, "vocabulary words out of range")
    ms = cuda_times_ms(lambda: voc.dispatch_transform(desc))
    busy, n_k = device_ms(lambda: voc.dispatch_transform(desc))
    print(f"loop words: {desc.shape[0]} descriptors through {voc.n_words} words ({len(voc.word_id)} nodes, "
          f"{depth} levels): identical to the CPU's, {int(torch.unique(words).numel())} distinct; "
          f"{ms:.3f} ms per descent (median of 20, CUDA events), {busy:.3f} ms of device time in {n_k} kernels")
    return ms


def sim3_pair(cam, n, n_valid, outlier_frac, seed):
    """Matched 3D points of two cameras related by a known rigid motion
    (p1 = R p2 + t), with noise, gross outliers and masked padding."""
    rng = np.random.default_rng(seed)
    p2 = np.stack([rng.uniform(-4, 4, n), rng.uniform(-2, 2, n), rng.uniform(5, 20, n)], -1).astype(np.float32)
    R = _rot(np.array([0.03, -0.12, 0.02]))
    t = np.array([0.6, -0.1, 0.3], np.float32)
    true_p1 = (p2 @ R.T + t).astype(np.float32)
    p1 = (true_p1 + rng.normal(0, 0.01, p2.shape)).astype(np.float32)
    out = rng.random(n) < outlier_frac
    p1[out] += rng.normal(0, 1.5, (int(out.sum()), 3)).astype(np.float32)
    valid = np.zeros(n, bool)
    valid[:n_valid] = True
    proj = lambda p: np.stack([cam.fx * p[:, 0] / p[:, 2] + cam.cx, cam.fy * p[:, 1] / p[:, 2] + cam.cy], -1)  # noqa: E731
    obs1 = (proj(true_p1) + rng.normal(0, 0.3, (n, 2))).astype(np.float32)
    obs2 = (proj(p2) + rng.normal(0, 0.3, (n, 2))).astype(np.float32)
    return p1, p2, obs1, obs2, valid, R, t


def phase_loop_sim3(cam):
    """Sim3 RANSAC (N = 256, 256 hypotheses) and refinement (N = 512) on
    a synthetic pair with 30% outliers: the card against the CPU."""
    import torch

    from orb_line_slam_tpu_torch.backend.sim3_opt import optimize_sim3
    from orb_line_slam_tpu_torch.backend.sim3_solver import solve_sim3_ransac

    g = lambda a, d: torch.from_numpy(a).to(d)  # noqa: E731
    p1, p2, _, _, valid, R_true, t_true = sim3_pair(cam, 256, 200, 0.3, seed=3)
    ones = np.ones(256, np.float32)

    def ransac(d):
        out = solve_sim3_ransac(g(p1, d), g(p2, d), g(valid, d), 11, cam, cam, g(ones, d), g(ones, d),
                                fix_scale=True, n_hyps=256)
        return [x.cpu().numpy() for x in out]

    s, R, t, inl, cnt = ransac("cuda")
    sc, Rc, tc, inlc, cntc = ransac("cpu")
    ang, dt = float(_rot_angle(R, Rc)), float(np.abs(t - tc).max())
    check(np.array_equal(inl, inlc) and int(cnt) == int(cntc), f"Sim3 RANSAC inliers differ: {int(cnt)} vs CPU {int(cntc)}")
    check(ang < 1e-4 and dt < 1e-3, f"Sim3 RANSAC differs from the CPU's by {ang:.2e} rad, {dt:.2e} m")
    check(int(cnt) > 100 and float(_rot_angle(R, R_true)) < 0.02 and np.abs(t - t_true).max() < 0.1,
          "Sim3 RANSAC is far from the true motion")
    ransac_ms, n_ransac = host_times_ms(lambda: ransac("cuda")), int(cnt)

    q1, q2, obs1, obs2, qvalid, _, _ = sim3_pair(cam, 512, 400, 0.3, seed=5)
    sig = (1.2 ** np.random.default_rng(6).integers(0, 4, 512) * 1.0).astype(np.float32) ** 2
    R0 = (_rot(np.array([0.01, -0.02, 0.015])) @ R_true).astype(np.float32)
    t0 = t_true + np.array([0.05, -0.04, 0.06], np.float32)

    def refine(d):
        res = optimize_sim3(torch.tensor(1.0, device=d), g(R0, d), g(t0, d), g(q1, d), g(q2, d), g(obs1, d), g(obs2, d),
                            g(sig, d), g(sig, d), g(qvalid, d), cam, cam, fix_scale=True)
        return [x.cpu().numpy() for x in res]

    s, R, t, inl, cnt = refine("cuda")
    sc, Rc, tc, inlc, cntc = refine("cpu")
    ang, dt = float(_rot_angle(R, Rc)), float(np.abs(t - tc).max())
    check(np.array_equal(inl, inlc), f"Sim3 refinement inliers differ: {int(cnt)} vs CPU {int(cntc)}")
    check(ang < 1e-4 and dt < 1e-3, f"Sim3 refinement differs from the CPU's by {ang:.2e} rad, {dt:.2e} m")
    check(int(cnt) > 200 and float(_rot_angle(R, R_true)) < 5e-3 and np.abs(t - t_true).max() < 0.03,
          "Sim3 refinement is far from the true motion")
    refine_ms = host_times_ms(lambda: refine("cuda"))
    (rb, rk), (fb, fk) = device_ms(lambda: ransac("cuda")), device_ms(lambda: refine("cuda"))
    print(f"loop Sim3: RANSAC N=256 x 256 hypotheses {n_ransac} inliers, same mask as the CPU's, {ransac_ms:.2f} ms; "
          f"refinement N=512 {int(cnt)} inliers, same mask, within {ang:.1e} rad / {dt:.1e} m of the CPU's, "
          f"{refine_ms:.2f} ms (host clock, results fetched, median of 5); device time {rb:.3f} ms in {rk} kernels "
          f"and {fb:.3f} ms in {fk} kernels")
    return ransac_ms, refine_ms


def phase_loop_pose_graph(K=128, n_live=100):
    """optimize_pose_graph at K slots on a drifted ring of n_live
    keyframes with one loop edge: the card against the CPU."""
    import torch

    from orb_line_slam_tpu_torch.backend.pose_graph import optimize_pose_graph

    rng = np.random.default_rng(0)
    ang = np.linspace(0, 2 * np.pi, n_live, endpoint=False)
    R_true = np.stack([_rot(np.array([0.0, a, 0.0])) for a in ang])
    c = np.stack([20 * np.cos(ang), np.zeros(n_live), 20 * np.sin(ang)], -1).astype(np.float32)
    t_true = -np.einsum("kij,kj->ki", R_true, c).astype(np.float32)
    rel = lambda Rb, tb, Ra, ta: (Rb @ Ra.T, tb - Rb @ Ra.T @ ta)  # noqa: E731
    R0 = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    t0 = np.zeros((K, 3), np.float32)
    R0[0], t0[0] = R_true[0], t_true[0]
    ei, ej, eR, et = [], [], [], []
    for k in range(1, n_live):
        Rm, tm = rel(R_true[k], t_true[k], R_true[k - 1], t_true[k - 1])
        ei.append(k - 1), ej.append(k), eR.append(Rm), et.append(tm)
        Rd = _rot(rng.normal(0, 0.002, 3)) @ Rm            # drifted odometry
        R0[k], t0[k] = Rd @ R0[k - 1], Rd @ t0[k - 1] + tm + rng.normal(0, 0.01, 3).astype(np.float32)
    Rm, tm = rel(R_true[0], t_true[0], R_true[n_live - 1], t_true[n_live - 1])
    ei.append(n_live - 1), ej.append(0), eR.append(Rm), et.append(tm)
    valid = np.zeros(K, bool)
    valid[:n_live] = True
    fixed = ~valid
    fixed[0] = True
    E = len(ei)
    arrs = (np.ones(K, np.float32), R0, t0, valid, fixed, np.array(ei, np.int64), np.array(ej, np.int64),
            np.ones(E, np.float32), np.stack(eR).astype(np.float32), np.stack(et).astype(np.float32),
            np.ones(E, bool), np.ones(E, np.float32))

    def solve(d, n_iters=20):
        return [x.cpu().numpy() for x in optimize_pose_graph(*(torch.from_numpy(a).to(d) for a in arrs), n_iters=n_iters)]

    s, R, t = solve("cuda")
    sc, Rc, tc = solve("cpu")
    dt = float(np.abs(t - tc).max())
    before = float(np.linalg.norm(t0[:n_live] - t_true, axis=1).max())
    after = float(np.linalg.norm(t[:n_live] - t_true, axis=1).max())
    check(dt < 1e-3, f"pose graph on the card differs from the CPU's by {dt:.2e} m")
    check(after < 0.5 * before and np.array_equal(t[fixed], t0[fixed]), f"pose graph did not close the ring: {before:.3f} -> {after:.3f} m")
    ms = host_times_ms(lambda: solve("cuda"), n=3)
    busy, n_k = device_ms(lambda: solve("cuda", n_iters=4))        # 4 of the 20 iterations under the profiler
    print(f"loop pose graph: K={K} slots, {n_live} keyframes, {E} edges, 20 iterations: worst keyframe error "
          f"{before:.3f} -> {after:.3f} m, within {dt:.1e} m of the CPU's; {ms:.1f} ms per solve "
          f"(host clock, result fetched, median of 3), {busy / 4:.2f} ms of device time in {n_k // 4} kernels per iteration")
    return ms


def phase_loop_gba_cg(cam, C=512, P=65536, O=524288):
    """bundle_adjust_cg at the default MapConfig capacity (the size
    LoopCloser gives it there: 512 cameras, 65,536 points, n_cams * 1024
    observations), single robust stage 12 + 0, 64 CG iterations, on a
    perturbed synthetic problem built as phase_bench_ba builds its own.
    The card is held to the same code on CPU tensors over the first two
    LM iterations (the CPU takes ~3 s per iteration); the full solve is
    held to the truth it was perturbed from."""
    import torch

    from orb_line_slam_tpu_torch.backend.global_ba import bundle_adjust_cg

    rng = np.random.default_rng(2)
    pts = np.stack([rng.uniform(-20, 40, P), rng.uniform(-5, 5, P), rng.uniform(5, 60, P)], -1).astype(np.float32)
    R = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
    t = np.zeros((C, 3), np.float32)
    t[:, 0] = -np.arange(C) * (20.0 / C)
    obs_cam = rng.integers(0, C, O).astype(np.int32)
    obs_lm = rng.integers(0, P, O).astype(np.int32)
    xc = pts[obs_lm] + t[obs_cam]
    z = xc[:, 2]
    u = cam.fx * xc[:, 0] / z + cam.cx
    obs = (np.stack([u, cam.fy * xc[:, 1] / z + cam.cy, u - cam.bf / z], -1) + rng.normal(0, 0.5, (O, 3))).astype(np.float32)
    t0 = (t + rng.normal(0, 0.02, t.shape)).astype(np.float32)
    t0[0] = t[0]
    pts0 = (pts + rng.normal(0, 0.05, pts.shape)).astype(np.float32)
    arrs = (R, t0, np.zeros(C, bool), pts0, np.ones(P, bool), obs_cam, obs_lm, obs,
            rng.integers(0, 4, O).astype(np.int32), np.ones(O, bool))

    def solve(d, iters1=12):
        res = bundle_adjust_cg(*(torch.from_numpy(a).to(d) for a in arrs), cam, iters1=iters1, iters2=0,
                               fix_first=True, cg_iters=64)
        return [x.cpu().numpy() for x in res]

    chi2_0 = float(solve("cuda", iters1=0)[4])
    _, t2, p2, _, chi2_2 = solve("cuda", iters1=2)
    t_s = time.perf_counter()
    _, tc, pc, _, chi2c = solve("cpu", iters1=2)
    cpu_ms = (time.perf_counter() - t_s) * 1e3
    dt, dp = float(np.abs(t2 - tc).max()), float(np.abs(p2 - pc).max())
    check(float(chi2_2) < chi2_0, f"CG global BA did not reduce chi2 in two iterations: {chi2_0:.1f} -> {float(chi2_2):.1f}")
    check(abs(float(chi2_2) - float(chi2c)) <= 0.01 * float(chi2c), f"CG global BA chi2 {float(chi2_2):.1f} vs CPU {float(chi2c):.1f}")
    check(dt < 1e-3, f"CG global BA cameras differ from the CPU's by {dt:.2e} m")
    t_s = time.perf_counter()
    Rg, tg, pg, inl, chi2 = solve("cuda")
    first_ms = (time.perf_counter() - t_s) * 1e3
    check(np.isfinite(tg).all() and np.isfinite(pg).all(), "CG global BA: non-finite result")
    check(float(chi2) < float(chi2_2), f"CG global BA did not go on reducing chi2: {float(chi2_2):.1f} -> {float(chi2):.1f}")
    check(float(np.abs(tg - t).max()) < float(np.abs(t0 - t).max()), "CG global BA did not bring the cameras closer to truth")
    ms = host_times_ms(lambda: solve("cuda"), n=3)
    busy, n_k = device_ms(lambda: solve("cuda", iters1=2))          # 2 of the 12 LM iterations under the profiler
    # Per CG iteration the solver streams the per-observation coupling
    # blocks twice (bt_x and b_z: [O, 6, 3] float32 and the int64 index
    # of each sweep): a floor on its memory traffic.
    sweep_bytes = 2 * (O * 18 * 4 + O * 8)
    print(f"loop global BA (CG): C={C} P={P} O={O}: after 2 LM x 64 CG iterations chi2 {chi2_0:.0f} -> {float(chi2_2):.0f} "
          f"(CPU {float(chi2c):.0f}), cameras within {dt:.1e} m and points within {dp:.1e} m of the CPU's "
          f"({cpu_ms:.0f} ms on this host's CPU); after 12: chi2 {float(chi2):.0f}, worst camera error "
          f"{float(np.abs(t0 - t).max()):.4f} -> {float(np.abs(tg - t).max()):.4f} m; {ms:.1f} ms per solve, "
          f"{ms / 12:.2f} ms per LM iteration (host clock, result fetched, median of 3; {busy / 2:.1f} ms of device time in "
          f"{n_k // 2} kernels per LM iteration; first full solve {first_ms:.0f} ms); "
          f"the two observation sweeps of one CG iteration move "
          f">= {sweep_bytes / 1e6:.1f} MB, {sweep_bytes / H100_BYTES_PER_S * 1e3 * 64 * 12:.1f} ms per solve at the HBM rate")
    return ms


def render_loop_sequence(cfg):
    from orb_line_slam_tpu_torch.data.synthetic import SyntheticScene, loop_circuit_trajectory

    scene = SyntheticScene(cfg.camera, **LOOP_SCENE)
    scene.noise_sigma = LOOP_NOISE_SIGMA
    poses = loop_circuit_trajectory(LOOP_FRAMES, radius=LOOP_RADIUS, laps=LOOP_LAPS)
    return poses, [scene.render_stereo(R, t) for R, t in poses]


def closure_gap_error(store, poses, kf_id, cand):
    """Error (m) of the closing keyframe's position as seen from the
    loop candidate's camera frame, against the ground truth: the drift
    accumulated around the circuit, which the closure is there to remove.
    It needs no alignment, since both keyframes are in one map."""
    def centre_in(Ra, ta, Rb, tb):
        return Ra @ (-Rb.T @ tb) + ta

    est = centre_in(store.kf_R[cand], store.kf_t[cand], store.kf_R[kf_id], store.kf_t[kf_id])
    (Rg, tg), (Rh, th) = poses[int(store.kf_frame_id[cand])], poses[int(store.kf_frame_id[kf_id])]
    return float(np.linalg.norm(est - centre_in(Rg, tg, Rh, th)))


def phase_loop_slice(cfg, poses, frames):
    """The closed circuit with loop closing on, then without."""
    from orb_line_slam_tpu_torch.loop import loop_closing

    gaps = []
    correct = loop_closing.LoopCloser._correct

    def recorded_correct(self, kf_id, cand, sim, run_gba=True):
        before = closure_gap_error(self.map, poses, kf_id, cand)
        correct(self, kf_id, cand, sim, run_gba)
        gaps.append((before, closure_gap_error(self.map, poses, kf_id, cand)))

    loop_closing.LoopCloser._correct = recorded_correct
    try:
        slam, launches, fps, ate = run_slice(cfg, poses, frames, "loop slice", 0.1, use_loop_closing=True)
    finally:
        loop_closing.LoopCloser._correct = correct
    lc = slam.loop_closer
    check(lc is not None, "loop slice: no LoopCloser was made")
    check(slam.n_loops_closed >= 1 and len(gaps) == slam.n_loops_closed, "loop slice: no loop closed")
    check(lc.n_gba_applied >= 1, "loop slice: no global BA applied")
    check(lc.last_gba_solver == "dense+lines", f"loop slice: global BA ran as {lc.last_gba_solver}, want the joint point+line solve")
    n_kf = int(slam.map.n_keyframes())
    tt = slam.tracker.timing.table()
    lc_ms = tt["loop_closing"]["ms_per_call"]
    slam_off, launches_off, fps_off, ate_off = run_slice(cfg, poses, frames, "loop slice, loop closing off", 0.1)
    check(slam_off.n_loops_closed == 0, "loop closing off, yet a loop closed")
    closure = lc.closure_ms[0]
    gap_before, gap_after = gaps[0]
    print(f"loop slice: {slam.n_loops_closed} loop(s) closed at keyframe(s) {[c['kf'] for c in lc.closure_ms]}, "
          f"{lc.n_gba_applied} global BA ({lc.last_gba_solver}), {n_kf} keyframes, {fps:.2f} frames/s "
          f"(frames {WARMUP_FRAMES}-{len(frames) - 1}, closing event included; {fps_off:.2f} with loop closing off), "
          f"ATE {ate:.5f} m (JAX CPU reference {JAX_CPU_REFERENCE_ATE_LOOP_M:.5f} m; loop closing off {ate_off:.5f} m); "
          f"the closing keyframe's position error seen from the loop keyframe {gap_before:.4f} -> {gap_after:.4f} m "
          f"over the correction, essential graph and global BA")
    print("loop closer stages: " + json.dumps(lc.timing.table()))
    check_ate("loop slice", ate, JAX_CPU_REFERENCE_ATE_LOOP_M)
    # The closure must do its work, not merely do no harm: the drift
    # across the loop shrinks, and the whole trajectory is better than
    # the same frames tracked without loop closing.
    check(gap_after < gap_before, f"loop slice: the closure did not reduce the drift across the loop: "
                                  f"{gap_before:.4f} -> {gap_after:.4f} m")
    check(ate < ate_off, f"loop slice: ATE {ate:.5f} m with loop closing is not below {ate_off:.5f} m without")
    print(json.dumps({
        "ate_rmse_loop_m": ate, "ate_synth_noloop_m": ate_off, "ate_synth_loops": slam.n_loops_closed,
        "ate_synth_keyframes": n_kf, "loop_pipeline_fps": fps, "noloop_pipeline_fps": fps_off,
        "loop_closing_ms_per_keyframe": lc_ms, "closure_gap_error_m": [gap_before, gap_after],
        "closing_event_ms": {k: closure.get(k) for k in ("detect", "sim3", "correct", "essential_graph", "gba")},
    }))
    return launches + launches_off, fps, ate


PROFILE_START, PROFILE_FRAMES = 33, 3
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
    ("loop.vocabulary", "descend_words", "loop_word_descent"),
    ("loop.loop_closing", "match_descriptors", "loop_bow_match"),
    ("loop.loop_closing", "solve_sim3_ransac", "loop_sim3_ransac"),
    ("loop.loop_closing", "search_by_sim3_dir", "loop_guided_search"),
    ("loop.loop_closing", "optimize_sim3", "loop_sim3_refine"),
)


def phase_profile(cfg, frames, cell="point+line slice", start=PROFILE_START, dt=0.05, use_loop_closing=False):
    """torch.profiler over PROFILE_FRAMES frames from `start` of a
    slice's sequence (phase 7's by default: keyframe 34 and its joint BA
    fall inside), after the earlier frames unprofiled, on a fresh System.
    Device time per range is the sum of the device kernels that start
    inside the range's device interval."""
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
        slam = System(cfg, use_loop_closing=use_loop_closing, device="cuda")
        for i in range(start):
            slam.track_stereo(*frames[i], timestamp=dt * i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(start, start + PROFILE_FRAMES):
                slam.track_stereo(*frames[i], timestamp=dt * i)
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
        "cell": cell, "frames": f"{start}-{start + n - 1}", "wall_ms_per_frame_profiled": wall * 1e3 / n,
        "device_busy_ms_per_frame": busy_us / 1e3 / n, "kernels_per_frame": len(kern) / n,
        "kernel_launch_calls_per_frame": launches / n, "device_idle_share_profiled": 1 - busy_us / 1e6 / wall,
        "range_device_ms_per_frame": {k: v / 1e3 / n for k, v in per.items()},
        "range_device_ms_per_call": {k: (per[k] / 1e3 / calls[k] if calls[k] else None) for k in tags},
        "range_calls": calls,
        "range_share_of_busy": {k: v / busy_us for k, v in per.items()},
    }}))
    for name, (d, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"profile top kernel ({cell}): {d / 1e3 / n:8.3f} ms/frame {c / n:8.1f} calls/frame  {name[:110]}")


def main():
    if not os.path.isdir(os.path.join(ROOT, "orb_line_slam_tpu_torch")):
        fail("orb_line_slam_tpu_torch/ not found beside chip_smoke.py: run from a checkout of the repo")
    sys.path.insert(0, ROOT)
    import torch

    t_start = time.perf_counter()

    def done(phase):
        print(f"[{time.perf_counter() - t_start:6.1f} s] {phase} done", flush=True)

    phase_device()
    import orb_line_slam_tpu_torch  # noqa: F401  (sets the fp32 policy)

    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
          "TF32 is enabled")
    phase_build()
    metrics, launches = {}, 0
    cfg, lcfg, ccfg = kitti_config(), euroc_config(), loop_config()
    kern = phase_kernel((("point cell", cfg), ("point+line cell", lcfg), ("loop cell", ccfg)))
    done("phases 1-3")
    t0 = time.perf_counter()
    poses, frames = render_sequence(cfg, N_FRAMES)
    print(f"rendered {len(frames)} stereo pairs in {time.perf_counter() - t0:.1f} s (host, set-up)")
    metrics["stereo_frontend_fps"] = phase_frame(cfg, frames[0])
    metrics["local_ba_iter_ms"] = phase_bench_ba(cfg)
    n, metrics["full_pipeline_fps"], metrics["local_ba_ms_per_solve"], metrics["ate_rmse_synth_m"] = \
        phase_slice(cfg, poses, frames)
    launches += n
    done("phases 4-5")
    t0 = time.perf_counter()
    lposes, lframes = render_sequence(lcfg, N_FRAMES, LINE_SCENE, LINE_STEP)
    print(f"rendered {N_FRAMES} EuRoC-size stereo pairs with lines in {time.perf_counter() - t0:.1f} s (host, set-up)")
    metrics["line_frontend_ms"] = phase_line_frame(lcfg, lframes[0])
    n, metrics["lines_pipeline_fps"], metrics["joint_ba_ms_per_solve"], metrics["ate_rmse_lines_m"] = \
        phase_line_slice(lcfg, lposes, lframes)
    launches += n
    done("phases 6-7")
    phase_profile(lcfg, lframes)
    done("phase 8")
    from orb_line_slam_tpu_torch.frontend.frame import build_stereo_frame

    frame = build_stereo_frame(*(torch.from_numpy(x).cuda() for x in frames[0]), cfg)
    metrics["bow_descent_ms"] = phase_loop_words(frame)
    metrics["sim3_ransac_ms"], metrics["sim3_refine_ms"] = phase_loop_sim3(ccfg.camera)
    metrics["pose_graph_ms_per_solve"] = phase_loop_pose_graph()
    metrics["gba_cg_ms_per_solve"] = phase_loop_gba_cg(cfg.camera)
    host_probe("after the loop components")
    done("phase 9")
    t0 = time.perf_counter()
    cposes, cframes = render_loop_sequence(ccfg)
    print(f"rendered {len(cframes)} stereo pairs of the loop circuit in {time.perf_counter() - t0:.1f} s (host, set-up)")
    n, metrics["loop_pipeline_fps"], metrics["ate_rmse_loop_m"] = phase_loop_slice(ccfg, cposes, cframes)
    launches += n
    done("phase 10, both runs of the circuit")
    # A steady window of the circuit (keyframes every third frame, the
    # loop closer's per-keyframe work inside), before the closure.
    phase_profile(ccfg, cframes, cell="loop slice", start=30, dt=0.1, use_loop_closing=True)
    done("phase 10, profile")
    print(json.dumps(metrics))
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
