#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one GPU.

Drives the port's paths — stereo point-only tracking on a synthetic
KITTI-size sequence, stereo point+line tracking with joint point+line
local BA on a synthetic EuRoC-size sequence, and a closed circuit with
loop closing on (detection, Sim3, correction, essential graph, global
BA), all on the pinned schedule that the JAX references were computed
on (synchronous mapping, loop closing and global BA on the tracking
thread), then bench.py's pipeline and the circuit again on the System's
default schedule (deferred local mapping, loop detection and global BA
on worker threads) — through ``System.track_stereo``, and monocular and
RGB-D tracking at TUM fr1's size through ``System.track_monocular`` and
``System.track_rgbd``, and B stereo sequences at once through
``MultiSequenceTracker.process_stereo`` (one batched step per time step,
each sequence a System), and the distributed global BA (landmark-sharded
over a shard mesh, in one process and across processes through
``torch.distributed``, and the LoopCloser's route to it), and
eval/endurance.py's run (a sensor dropout recovered by relocalization,
keyframe culling under capacity pressure), after building
the hand-written CUDA kernels from the sources in this checkout and
holding each to its plain PyTorch version: the detection, describe and
stereo-SAD kernels of the front end and the pose solve (every tracking
step's three LM solves and each relocalization's, one launch each).  Run from the root of a
checkout:

    python3 chip_smoke.py

Phases (each fails loudly, and the script exits non-zero):
  1. device: a CUDA card is required; prints its name and power limit;
  2. build: nvcc builds csrc/patch_tiles.cu, orb_describe.cu,
     stereo_sad.cu, pose_solve.cu and orb_detect.cu for sm_90a, one
     process each, started together;
  3. kernels vs plain, at each of the three stereo cells' atlas shapes
     and feature budgets (8, 8 and 4 pyramid levels), and for
     orb_describe also at the TUM cell's batch of one ([1, 2210, 640],
     N = 1000, the mono and RGB-D frames' shape) and at a batched
     multi-sequence step's shapes (orb_describe over [8, 1731, 1241],
     N = 8 x 2000; stereo_sad over 4 pairs, N = 4 x 2000, one launch),
     with border and clamped keypoints among the inputs: patch tiles, exact equality;
     orb_describe, angles within 1e-4 rad on >= 99.5% of keypoints,
     >= 99% of descriptors bit-identical, median 0 bits, none above 8;
     stereo_sad, within 1e-5 relative + 1e-2 and the same best slide on
     >= 99.9% of rows.  At each, CUDA-event times of the kernel and the
     plain version (and of one indexing call for patch tiles), the
     kernel's own device time, the plain version's device time and
     kernel count, and the bound from the bytes and operations that
     input needs; at the first shape the host time of each wrapper when
     it launches nothing; pose_solve at each cell's M points and L lines
     (2000 / 1200 / 1000 and 0 / 128 / 64), 10 seeded problems at 4x10
     with the lines and 10 at 2x8 without, and 5 launches of a batch of 4
     (M = 2000, L = 128, 4x10): on every problem within 1e-3 rad and
     5e-3 m of the plain version, n_inliers within 3, the inlier masks
     equal on >= 99.5% of rows; the median pose difference and the
     accept/reject decisions that differ are printed; times, own device
     time, plain version and bound as above, with each shape's cluster
     size and own us per LM iteration; orb_detect (phase_detect) on
     rendered frames as the front end runs them: a KITTI-size pair, a
     EuRoC-size pair, one TUM-size image and a batched step's 4 KITTI-size
     pairs, all six outputs equal to detect_reference's on the same card
     tensors (torch.equal), LAUNCHES_PER_CALL launches a call, times, own
     device time a call and a pass, plain version and bound (level pixels
     read once, FAST_FLOP a pixel) as above;
  4. one frame: build_stereo_frame on the card vs its plain path on the
     CPU, held to the frame contract of tests/test_torch_frontend.py;
     on the card it must launch exactly one orb_describe and one
     stereo_sad kernel and one detection call's orb_detect kernels, and
     make no [N, 32, 32] tensor; device time and kernel count of the
     frame and of its detection, describe and SAD stages;
     stereo_match through the stereo_sad kernel vs through its plain
     version;
     extract_orb_with_tiles (the single-image path that returns tiles and
     keeps the patch-tile gather: one launch per image) on five images vs
     the CPU; build_mono_frame and build_rgbd_frame on one TUM-size image
     vs their CPU plain paths, each launching exactly one orb_describe,
     one detection call's orb_detect kernels and no patch_tiles and
     making no [N, 32, 32] tensor;
  5. the slice: 40 frames, state OK, >= 3 keyframes, >= 1 local BA, one
     detection call (LAUNCHES_PER_CALL orb_detect launches), one
     orb_describe and one stereo_sad launch per frame and no patch-tile
     launch, three pose-solve launches per frame after the first (one
     tracking step each) and no other, ATE no more than 10% + 1 cm above
     the JAX package's ATE on the same frames and schedule;
  6. one line frame: build_line_features on the card vs its plain path
     on the CPU, on a EuRoC-size pair, held to the line contract of
     tests/test_tpu_parity.py, and its time per stereo pair;
  7. the point+line slice: 40 EuRoC-size frames (BASELINE config #2's
     camera and budgets), state OK, >= 3 keyframes, >= 1 joint
     point+line BA with line observations, >= 10 map lines, line
     inliers on most frames, the same launches per frame, ATE no more
     than 10% + 1 cm above the JAX package's;
  8. profile: a torch.profiler window of frames 33-35 of phase 7's own
     run (left out of its frames/s), with record_function ranges around
     the stages: kernels and device ms per frame, device ms and kernels
     per range (the tracking step's kernels per frame and its pose
     solves' on a line of their own), the top device kernels (printed as
     a JSON line and a table);
  9. loop components on the card vs the same code on CPU tensors, at
     real sizes, with CUDA-event or host-clock times and the device time
     of one call under torch.profiler: the word descent
     of 2000 descriptors through a 10^5-word vocabulary (identical
     words), Sim3 RANSAC (N = 256, 256 hypotheses) and refinement
     (N = 512) on a pair with 30% outliers, the pose graph at K = 128
     on a drifted 100-keyframe ring with one loop edge, and the
     matrix-free CG global BA at the default map capacity (512 cameras,
     65,536 points, 524,288 observations; held to the CPU over its
     first LM iteration, to the truth over all twelve);
 10. the loop slice: bench.py's 170-frame closed circuit with
     use_loop_closing=True, state OK, >= 1 loop closed, >= 1 global BA
     applied (the dense joint point+line solve), the same launches per
     frame, ATE no more than 10% + 1 cm above the JAX package's and
     below that of the port's own run without loop closing, and the
     closing keyframe's position error seen from the loop keyframe
     smaller after the closure than before it; a torch.profiler window
     of frames 30-32 of the run with loop closing on, as in phase 8
     (kernels, device ms and idle share per frame, device ms of the loop
     closer's per-keyframe work);
 11. the shipping schedule, System(cfg, device="cuda") as a user makes
     it: (a) bench.py::_bench_pipeline (the KITTI camera, 2000 features,
     8 levels, lines on, loop closing on; phase 5's 40 frames; frames/s
     over frames 12-39 as full_pipeline_fps), state OK, >= 3 keyframes,
     >= 1 local BA, the same launches per frame, ATE within
     max(1.25 x, + 2 cm) of phase 5's; (b) phase 10's circuit: state OK,
     >= 1 loop detected on the loop-closing worker and corrected on the
     tracking thread, >= 1 global BA solved on the global-BA worker and
     applied by poll_global_ba, ATE within max(1.25 x, + 2 cm) of phase
     10's pinned run (tests/test_loop_closure_e2e.py's bound), frames
     30-32 profiled as in phase 10; for both, the frames from each
     deferred local BA's pack to its apply, and the tracking thread's
     wait for each (ms per frame, p50, max; also in phase 14 a);
 12. the monocular slice: 40 TUM-size frames (tum_config) through
     System.track_monocular, state OK, initialised at the JAX package's
     frame, >= 3 keyframes, >= 1 local BA, > 80 map points, one
     orb_describe and one detection call per frame and nothing else, similarity-aligned ATE no
     more than 10% + 1 cm above the JAX package's;
 13. the RGB-D slice: 40 TUM-size frames of a room through
     System.track_rgbd, state OK, >= 3 keyframes, >= 1 local BA, one
     orb_describe and one detection call per frame and nothing else, ATE no more than 10% + 1 cm
     above the JAX package's;
 14. batched multi-sequence SLAM (BASELINE config #4), each sequence a
     System on its defaults (bench_pipeline_config: lines and loop
     closing on): (a) B = 2, phase 5's 40 frames and the same frames in
     reverse order; on three steady batched steps each sequence's
     TrackOut is held to an unbatched track_step on the same tensors
     (1e-4 rad, 1e-4 m, assoc_gid on >= 99% of rows); >= half the steps
     batched; each ATE within max(1.25 x, + 2 cm) of phase 11 (a)'s;
     the first 30 frames of each direction;
     (b) B = 1, 4, 8, sequence b starting at frame 3b, 10 steps each
     (B = 2 is (a)'s run): multiseq_aggregate_fps (median and spread of
     three windows of the batched steps), host ms per batched step, the
     speedup against B = 1, and the kernels and device ms of one steady
     batched step profiled alone at B = 1 and 4.  In both, every batched step launches
     exactly one orb_describe, one stereo_sad and one detection call (a
     per-sequence step one of each per sequence) and three pose solves per tracking step (the
     vmapped step of all B sequences is one), and a per-sample fallback
     of torch.func.vmap fails the run;
 15. the distributed global BA (BASELINE config #5), S shards sharing
     cuda:0 (the card is one GPU, so every ratio is the sharding overhead
     on one card, not a scaling): (a) the sharded dense LM and CG on 4
     shards at the CPU tests' size (12 cameras, 512 landmarks, 3,072
     observations), held to the same calls on CPU tensors and to the
     single-device solvers on the card under the pose contract; (b)
     dryrun_multichip (256 x 65,536 x 262,144, 2 LM x 12 CG) and the
     loop closer's CG at the default map capacity (phase 9's problem and
     solve) at S = 1 and 4 against bundle_adjust_cg: host and device ms,
     kernels, all-reduces and their bytes, pose agreement, median
     landmark error, dist_gba_efficiency = t_single / t_mesh; (c)
     multihost_worker in a child process, NCCL at world size 1 through
     multihost.initialize, equal to (b)'s S = 1 solve; (d) two
     multihost_worker processes of 2 shards each on the card, gloo with
     CUDA tensors: replicated outputs bit-identical on both ranks, within
     the pose contract of (b)'s S = 4 solve; (e) copies of phase 10's
     final map under LoopClosers at the default map capacity with a
     4-shard mesh: _pack_gba chooses "sharded_cg", and run_global_ba and
     the asynchronous dispatch_global_ba (solved on the global-BA
     worker's stream) + poll_global_ba are held to bundle_adjust_cg on
     the same pack (inlier flags on >= 99% of the rows, the poses written
     to the map).  None of the five kernels is launched on this path.
 16. the endurance run and the host modules: (a)
     eval/endurance.py::run_endurance(n_frames=120, laps=0.45,
     loss_at=0.5, loss_frames=4, lines=True, shipping=True,
     fps_window=30) on the card (the loop circuit's camera and scene,
     96 keyframe slots, a sensor dropout of four noise frames): the
     noise frames LOST and <= loss_frames + 6 frames lost in all,
     tracking recovered, >= 1 Tracker._relocalize that succeeds from
     keyframe-database candidates (the method wrapped here), one
     detection call, one orb_describe and one stereo_sad per frame (noise frames included)
     and no patch tile, three pose solves per tracking step and one per
     relocalization or reference-keyframe solve, ATE within max(1.25 x, + 2 cm) of the JAX
     package's pinned run of the same call on the CPU; prints the
     returned dict, the fps windows, the device's peak allocated memory
     and the tracking thread's host ms per frame; (b) save_map /
     load_map of phase 10's final map, every array and scalar equal;
     (c) make libnative in native/ (host code): if it builds, a
     synthesized 10^4-word vocabulary parsed natively and in Python,
     equal, with both host times; if not, the compiler's reason (the
     Python parse is the reference's own path, so the run goes on).
 17. monocular loop closing (mono_loop_runs, phase_mono_loop_circuit,
     phase_mono_loop_fixture): (a) the loop circuit's left images
     (phase 10's frames) through System.track_monocular, loop closing
     on and off, pinned: the runs the same step by step until the first
     failed tracking step or closure, every 20th tracking step and the
     first 8 failed ones replayed on the CPU from the card's inputs with
     the card's outcome, the frames tracked and the ATE within the
     JAX package's spread over sensor-noise draws 0-8; (b) the same
     under draw MONO_LOOP_CLOSING_DRAW, where the JAX package closes a
     loop: >= 1 loop closed with a free scale and a global BA, no frame
     lost, ATE within 10% + 1 cm of the JAX package's and below the run
     without loop closing; one orb_describe and one detection call per
     frame, no stereo_sad,
     three pose solves per tracking step; (c) the scale-drifted fixture
     closed on the card and on CPU tensors, the two held together.
Phases 5, 7, 8, 10, 12, 13 and 17 pin the schedule the JAX references were
computed on (System(..., async_loop=False), gba_async = False,
tracker.async_mapping = False).  Every slice run prints the tracking thread's per-frame host ms (p50,
p90, max; the tracking thread's stream synchronised after each frame,
not the device, whose other streams carry the workers' solves), the
local BAs applied, skipped and discarded as stale, and each worker's
busy seconds.
A fixed host-CPU probe is timed at the start and after each slice, and
the seconds since the start are printed after each group of phases.
torch.profiler now and then returns a window with device records
missing; such a window is taken again (a bounded number of times, then
the run fails), and a line near the end says how many were.  All six sequences (the circuit under two noise draws) are
rendered once, before phase 4, by worker processes (the frames equal
those of rendering each in order).  The line before the last lists the
five kernels, with their launches over phases 4, 5, 7, 10, 11, 12, 13,
14, 16 and 17; the last line is the JSON
device record.  ``python3 chip_smoke.py --endurance-long`` runs
bench.py:92's run_endurance(n_frames=1500, shipping=True) and the same
run pinned instead (about 13 minutes each on the card).
``python3 chip_smoke.py --compare-parent DIR`` drives phases 5 and 7's
slices through the package of the tree at DIR (an unpacked parent
commit) and of this checkout in turns, parent, this, this, parent, each
in its own process, and prints frames/s, host ms, ATE, keyframes and the
profiled kernels per frame side by side; it also hashes orb_describe's
and stereo_sad's outputs on fixed seeded inputs at phase 3's nine shapes
in each process, fails unless every hash is the same, and prints the
two kernels' own device times side by side.  ``python3 chip_smoke.py
--front-end-split`` prints where a warp's cycles go in each of the two
(their split counters built in).  ``python3 chip_smoke.py
--schedule-probe DIR N OUT`` repeats phases 11 (a) and 14 (a) N times
through the package at DIR and prints how their ATEs and the deferred
BAs' lags repeat.  ``python3 chip_smoke.py --pose-split [DIR]`` splits
an LM iteration of the pose-solve kernel into its parts (and times DIR's
kernel beside it).  ``python3
chip_smoke.py --solver-probe DIR [VARIANT.cu ...]`` drives phases 5, 10
and 11 (a) with this kernel, DIR's, the plain solve and each variant
source in turn, and holds every solve of this kernel's phase 11 (a) to
the plain version on its inputs.  ``python3 chip_smoke.py
--mono-loop-draws 0,1,...`` runs phase 17 (a)'s two runs and step checks
on each sensor-noise draw of the circuit named (the runs may end LOST)
and prints each draw's frames tracked, ATE and loops beside the JAX
package's.
Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import warnings
from typing import NamedTuple

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# ATE (m) of the JAX package (orb_line_slam_tpu) on the same N_FRAMES (40)
# frames, rendered by orb_line_slam_tpu_torch.data.synthetic with the
# phase-5 config, on the same pinned schedule (System(use_loop_closing=
# False), tracker.async_mapping = False, tracker.pipeline_depth = 0), run
# on the CPU with JAX_PLATFORMS=cpu (10 keyframes, final state OK; on the
# earlier 60 frames: 0.01896567472094079 m, 14 keyframes).
JAX_CPU_REFERENCE_ATE_M = 0.024949906114801246
# The same for phase 7: the JAX package on phase 7's 40 frames and
# config, lines on, same schedule, on the CPU (4 keyframes, final state
# OK; on 60 frames 0.005195998586362491 m, 5 keyframes).
JAX_CPU_REFERENCE_ATE_LINES_M = 0.005405505107878567
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

# The monocular slice (phase 12): tests/test_mono_tracking.py's scene seen
# by the TUM fr1 camera (tum_config), moving 0.05 m sideways and 0.02 m
# forward per frame.  ATE (m, similarity-aligned over the tracked frames)
# of the JAX package on these 40 frames, rendered by
# orb_line_slam_tpu_torch.data.synthetic, System(use_loop_closing=False,
# async_loop=False), tracker.async_mapping = False, pipeline_depth = 0,
# track_monocular, on the CPU with JAX_PLATFORMS=cpu: initialised at
# frame 3, 37 frames tracked, 7 keyframes, final state OK (on 60 frames:
# 0.02562366931754967 m).  The slow test
# tests/test_torch_tum_references.py recomputes this and phase 13's.
JAX_CPU_REFERENCE_ATE_MONO_M = 0.029566473558291957
JAX_CPU_MONO_INIT_FRAME = 3
MONO_SCENE = dict(n_points=1000, seed=12, extent=((-10, 10), (-5, 5), (4, 25)))
MONO_STEP = (0.05, 0.0, 0.02)
# The RGB-D slice (phase 13): a room inside a Kinect's range, the camera
# moving 0.015 m per frame (fr1/desk's ~0.4 m/s at 30 Hz) while turning
# 0.005 rad per frame.  The JAX package on these 40 frames, same schedule,
# track_rgbd: 13 keyframes, final state OK (on 60 frames:
# 0.0075543405184823895 m, 16 keyframes).
JAX_CPU_REFERENCE_ATE_RGBD_M = 0.003933490183200496
RGBD_SCENE = dict(n_points=800, seed=13, extent=((-4, 4), (-3, 3), (1, 8)))
RGBD_VELOCITY, RGBD_YAW_RATE = (0.012, 0.0, 0.009), 0.005
TUM_DT = 1.0 / 30.0

# NVIDIA H100 SXM data sheet: HBM3 bandwidth (bytes/s), float32 rate
# outside the tensor cores (FLOP/s).
H100_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS = 67e12

# Frames of the point, point+line, mono and RGB-D slices (60 before phase
# 15 was added: cut to pay for its time).
N_FRAMES = 40
WARMUP_FRAMES = 10
# Phase 14: pairs of the batched kernel rows of phase 3; the batch sizes of
# the scaling run, its steps per sequence (bootstrap included) and the
# stagger of sequence b's first frame (b * MULTISEQ_STAGGER), so that the
# sequences' keyframe events do not coincide (tools/bench_multiseq.py:65-72).
MULTISEQ_KERNEL_PAIRS = 4
MULTISEQ_PAIR_FRAMES = 30         # phase 14 (a): the first 30 of each direction
MULTISEQ_BATCHES = (1, 4, 8)      # B = 2 is phase 14 (a)'s run
MULTISEQ_FRAMES = 10
MULTISEQ_KEEP_STEP = 6            # the batched step profiled alone
MULTISEQ_STAGGER = 3
# Phase 16: eval/endurance.py::run_endurance on the card at 0.188 m per
# frame (2 pi 8 m x 0.45 laps / 120), inside the 0.275 m of the JAX
# package's own 420-frame test (tests/test_endurance.py:19); noise frames
# 60-63.  ATE (m) of the JAX package's run_endurance on the same call with
# shipping=False (its own renderer), on the CPU with JAX_PLATFORMS=cpu, on a
# schedule that does not follow the host (one second of its tracking clock
# per frame, its device work awaited after each frame): 4 frames lost,
# recovered_at 66 (the port's 64: JAX's tracking_state lags its
# pipeline_depth of 2), 26 keyframes created, 27 alive, 2841 points, no loop
# closed.  The slow test
# tests/test_torch_endurance.py::test_jax_endurance_reference recomputes it.
ENDURANCE = dict(n_frames=120, laps=0.45, loss_at=0.5, loss_frames=4, lines=True, fps_window=30)
JAX_CPU_REFERENCE_ATE_ENDURANCE_M = 0.0379
# bench.py:92's long run (run_endurance's defaults: 8 m radius, 2.3 laps),
# outside the smoke (chip_smoke.py --endurance-long).
ENDURANCE_LONG = dict(n_frames=1500, radius=8.0, laps=2.3)
# Phase 17: the loop cell's circuit seen by one camera, the left images of
# phase 10's stereo pairs through track_monocular, loop closing on (the loop
# Sim3 then estimates its scale: fix_scale = not is_mono) and off.  Monocular
# tracking on this circuit runs near its gates (the median tracking step keeps
# 55 inliers in either package), so which frames it loses is a float draw in
# either package; the same circuit under other sensor-noise draws (loop_job's
# `draw`) shows the spread.  The JAX package on the same 170 images under
# draws 0-8 (draw 0 is phase 10's), System(use_loop_closing=True or False,
# async_loop=False), gba_async = False, tracker.async_mapping = False,
# pipeline_depth = 0, on the CPU with JAX_PLATFORMS=cpu: per draw and loop
# closing on / off, (first tracked frame, frames tracked, similarity-aligned
# ATE (m) over them, loops closed).  The slow test
# tests/test_torch_mono_loop.py::test_chip_smoke_mono_loop_jax_cpu_reference
# recomputes them.  Draw MONO_LOOP_CLOSING_DRAW is one on which the JAX
# package closes a loop; on draw 0 it closes none.
NOISE_DRAW_STRIDE = 100000
JAX_CPU_MONO_LOOP = {
    0: {"on": (2, 168, 0.6482609673881481, 0), "off": (2, 168, 0.6482609673881481, 0)},
    1: {"on": (2, 67, 0.6500950786872739, 0), "off": (2, 57, 0.107370733388417, 0)},
    2: {"on": (2, 51, 0.50611186943958, 0), "off": (2, 167, 0.9663859244287274, 0)},
    3: {"on": (2, 95, 0.42768990064632445, 0), "off": (2, 67, 0.47010180841631455, 0)},
    4: {"on": (2, 168, 0.33461628827264506, 0), "off": (2, 152, 0.340291913461615, 0)},
    5: {"on": (2, 168, 0.12227496123989115, 1), "off": (2, 168, 0.15820382646081496, 0)},
    6: {"on": (2, 83, 0.13008262015878955, 0), "off": (2, 62, 0.12064469755488229, 0)},
    7: {"on": (2, 166, 1.1228160145008748, 0), "off": (2, 140, 1.1245608985592541, 0)},
    8: {"on": (2, 160, 0.3866244688066021, 0), "off": (2, 130, 0.3944644419954981, 0)},
}
MONO_LOOP_CLOSING_DRAW = 5
# Phase 17 replays every 20th tracking step of a run with loop closing, and
# its first 8 failed ones, on the CPU from the card's inputs.
MONO_REPLAY_EVERY, MONO_REPLAY_FAILED = 20, 8
# Phase 17 (c): the scale the fixture's return leg grows to, less one.
FIXTURE_SCALE_DRIFT = 0.1


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


def bench_pipeline_config():
    """bench.py::_bench_pipeline's configuration: the KITTI camera,
    OrbConfig(2000, 8), the default LineConfig (lines on) and MapConfig."""
    from orb_line_slam_tpu_torch.config import OrbConfig, SlamConfig

    return SlamConfig(camera=kitti_config().camera, orb=OrbConfig(n_features=2000, n_levels=8))


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


def tum_config():
    """What examples/mono_tum.py and rgbd_tum.py run on TUM fr1
    (examples/configs/TUM1.yaml): its camera with the distortion zeroed
    (the synthetic renderer draws a pinhole image), bf 40, ThDepth 40,
    30 frames/s, DepthMapFactor 5000; OrbConfig(1000, 8 levels, scale 1.2);
    the default LineConfig and MapConfig."""
    from orb_line_slam_tpu_torch.config import CameraIntrinsics, OrbConfig, SlamConfig, TrackingConfig

    cam = CameraIntrinsics(fx=517.306408, fy=516.469215, cx=318.643040, cy=255.313989, bf=40.0, width=640, height=480)
    return SlamConfig(camera=cam, orb=OrbConfig(n_features=1000, n_levels=8, scale_factor=1.2),
                      tracking=TrackingConfig(th_depth=40.0, max_frames_between_kf=30), fps=30.0, rgb=True,
                      depth_map_factor=5000.0)


def tum_jobs(cfg, n_frames):
    """Render jobs (render_jobs) of phase 12's monocular images and phase
    13's (image, depth) pairs."""
    from orb_line_slam_tpu_torch.data.synthetic import SyntheticScene

    mono_poses = [(np.eye(3), -np.array(MONO_STEP) * i) for i in range(n_frames)]
    rgbd_poses = []
    for i in range(n_frames):
        a = RGBD_YAW_RATE * i
        R = np.array([[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0], [-np.sin(a), 0.0, np.cos(a)]])
        rgbd_poses.append((R, -R @ (np.array(RGBD_VELOCITY) * i)))
    return [(SyntheticScene(cfg.camera, **MONO_SCENE), mono_poses, "mono"),
            (SyntheticScene(cfg.camera, **RGBD_SCENE), rgbd_poses, "rgbd")]


def render_tum_sequences(cfg, n_frames):
    """Phase 12's monocular images and phase 13's (image, depth) pairs,
    with their ground-truth poses."""
    jobs = tum_jobs(cfg, n_frames)
    mframes, rframes = render_jobs(jobs)
    return jobs[0][1], mframes, jobs[1][1], rframes


# Frames a render worker takes at a time.
RENDER_CHUNK = 10
NOISE_CALLS = {"stereo": 2, "mono": 1, "rgbd": 1}


def render_chunk(scene, poses, kind, noise_calls):
    """Render poses in order on scene, its sensor-noise draws numbered from
    noise_calls (SyntheticScene numbers them per render call)."""
    scene._noise_calls = noise_calls
    fn = {"stereo": scene.render_stereo, "mono": scene.render, "rgbd": scene.render_rgbd}[kind]
    return [fn(R, t) for R, t in poses]


def render_jobs(jobs, processes=1):
    """Render jobs of (SyntheticScene, poses, "stereo" | "mono" | "rgbd")
    and return one list of frames per job, the frames of each job identical
    to those of rendering its poses in order on its scene.  The renderer
    is a Python loop over landmarks, so with processes > 1 the chunks of
    RENDER_CHUNK frames go to that many forked workers: call it so only
    before anything touches the card and before any thread starts, as
    main() does first (a forked worker skips the imports a spawned one
    repeats)."""
    import concurrent.futures
    import multiprocessing

    chunks = [(j, scene, poses[f0:f0 + RENDER_CHUNK], kind, scene._noise_calls + f0 * NOISE_CALLS[kind])
              for j, (scene, poses, kind) in enumerate(jobs) for f0 in range(0, len(poses), RENDER_CHUNK)]
    if processes == 1:
        done = [render_chunk(*c[1:]) for c in chunks]
    else:
        context = multiprocessing.get_context("fork")
        with concurrent.futures.ProcessPoolExecutor(processes, mp_context=context) as pool:
            done = [f.result() for f in [pool.submit(render_chunk, *c[1:]) for c in chunks]]
    out = [[] for _ in jobs]
    for c, frames in zip(chunks, done):
        out[c[0]].extend(frames)
    return out


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


def print_card():
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])


def phase_device():
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False: this smoke test needs a CUDA card")
    print_card()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    host_probe("start")


def phase_build():
    """nvcc on every kernel source, one process each, all started together."""
    from orb_line_slam_tpu_torch.ops import _build

    built = _build.build(extra_flags=("-Xptxas", "-v"))
    for name, (seconds, output) in built.items():
        usage = [ln.split(":", 1)[-1].strip() for ln in output.splitlines() if "Used" in ln or "spill" in ln]
        print(f"build: {os.path.relpath(_build.library_path(name), ROOT)} finished {seconds:.2f} s after the common start"
              f" (ptxas: {'; '.join(usage) or 'no report'})")
        check(_build.library_path(name).exists(), f"{name}: no library after the build")


def cell_atlas_shape(cfg):
    from orb_line_slam_tpu_torch.ops.image import pyramid_shapes

    w = cfg.camera.width
    return sum(s[0] for s in pyramid_shapes(cfg.camera.height, w, cfg.orb.n_levels, cfg.orb.scale_factor)), w


def border_keypoints(h, w):
    return np.array([[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1], [-7, 5], [5, -7],
                     [w + 3, h + 3], [w // 2, h - 3], [w - 1, h // 2], [15, 15], [16, 16], [w - 17, h - 17]])


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

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    records = []
    for name, cfg in cells:
        (h, w), n, levels = cell_atlas_shape(cfg), cfg.orb.n_features, cfg.orb.n_levels
        img = torch.from_numpy((rng.random((h, w)) * 255).astype(np.float32)).to(dev)
        xy = np.stack([rng.integers(-20, w + 20, n), rng.integers(-20, h + 20, n)], -1)
        border = border_keypoints(h, w)
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
        own = own_device_ms(lambda: patches.gather_patch_tiles(img, xy), "patch_tiles_kernel", patches)
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
              f"plain, kernel, library, library, kernel, plain); kernel's own device time {own * 1e3:.2f} us "
              f"(torch.profiler, mean of 20); bound {bound_ms * 1e3:.2f} us ({n_read} bytes read: "
              f"{int(covered.sum())} of {h * w} atlas pixels lie under a tile; {n_written} bytes written; "
              f"at {H100_BYTES_PER_S / 1e12:.2f} TB/s)")
        records.append({"shape": f"{name}: atlas [{h}x{w}], N={n}", "max_abs_err": err, "ms": min(ms, ms2),
                        "plain_ms": min(plain_ms, plain_ms2), "bound_ms": bound_ms, "bound_by": "bytes",
                        "library_ms": min(lib_ms, lib_ms2), "device_ms": own})
    return {**records[0], "max_abs_err": max(r["max_abs_err"] for r in records), "by_shape": records}


def covered_pixels(h, w, x0, y0, rows, cols):
    """Number of [h, w] pixels under some rows x cols window with top-left
    corner (x0[i], y0[i]) (int64 tensors on the card)."""
    import torch

    dev = x0.device
    covered = torch.zeros((h, w), dtype=torch.bool, device=dev)
    ys = y0[:, None, None] + torch.arange(rows, device=dev)[None, :, None]
    xs = x0[:, None, None] + torch.arange(cols, device=dev)[None, None, :]
    covered[ys.expand(-1, rows, cols), xs.expand(-1, rows, cols)] = True
    return int(covered.sum())


def interleaved_times(kernel_fn, plain_fn):
    """Plain, kernel, kernel, plain: each a median over 20 CUDA-event
    windows of 50 (kernel) or 10 (plain) calls.  Returns (ms, ms2, plain_ms,
    plain_ms2)."""
    plain_ms = cuda_times_ms(plain_fn, reps=10)
    ms = cuda_times_ms(kernel_fn, reps=50)
    ms2 = cuda_times_ms(kernel_fn, reps=50)
    plain_ms2 = cuda_times_ms(plain_fn, reps=10)
    return ms, ms2, plain_ms, plain_ms2


def wrapper_host_us(fn, calls=2000):
    """Host time (us) of one call of fn, which must launch nothing: median
    of 5 runs of `calls` calls."""
    import torch

    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    return statistics.median(times)


def phase_fused_kernels(cells, mono_cells=()):
    """The fused describe and stereo-SAD kernels on the card at every
    cell's atlas shape and feature budget vs their plain versions, with
    border and clamped keypoints among the inputs (a stereo cell's atlas
    holds both images; a mono cell's, for orb_describe alone, one).
    orb_describe: angles within 1e-4 rad on >= 99.5% of keypoints, >= 99%
    of descriptors bit-identical, median Hamming distance 0, none above 8
    bits (its blurred tile is a float32 sum in another order than the
    matrix-product library's).  stereo_sad: |sad - plain| <= 1e-5 plain +
    1e-2 and the same best slide on >= 99.9% of rows, at the whole-number
    centres the matcher gives it and at fractional ones.  Then CUDA-event
    times, own device time and kernel count under torch.profiler of kernel
    and plain version, and the bound: the larger of the needed bytes at the
    HBM rate and the needed operations at the float32 rate.  Returns the
    two kernels-line records."""
    import torch

    from orb_line_slam_tpu_torch.ops import describe, patches, stereo_sad

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    d_records, s_records = [], []
    # The float operations one keypoint needs: the shift+blur is
    # A(dy) T A(dx)^T with A(d) = wm Am + w0 A0 + wp Ap, one 9-tap band per
    # axis.  Building the two bands (32 rows x 9 taps, 3 products and 2
    # sums each), then two passes of 1024 outputs x 9 multiply-adds.  (The
    # plain version and the kernel do more: three products per axis, so as
    # to round alike.)  The quantisation, moments and comparisons are
    # integer work beside it.
    describe_flop = 2 * (describe.PATCH * describe.BAND_TAPS * 5) + 2 * (describe.PATCH ** 2 * describe.BAND_TAPS * 2)
    sad_flop = 231 * 7 + 121 + 11 * (121 * 4 + 11)

    def inputs(b, h, w, n):
        """An image-like [b, h, w] atlas (noise low-passed by a 5x5 box, so
        that intensity centroids and SAD valleys are not pure noise), int32
        [b, n, 2] keypoints with border and out-of-range ones among them,
        and float32 [b, n, 2] sub-pixel offsets."""
        noise = torch.from_numpy((rng.random((b, 1, h, w)) * 255).astype(np.float32)).to(dev)
        atlas = torch.nn.functional.avg_pool2d(noise, 5, 1, 2, count_include_pad=False)[:, 0] * 0.7 + noise[:, 0] * 0.3
        xy = np.stack([rng.integers(-20, w + 20, (b, n)), rng.integers(-20, h + 20, (b, n))], -1)
        border = border_keypoints(h, w)
        xy[:, : len(border)] = border
        delta = torch.from_numpy(rng.uniform(-0.5, 0.5, (b, n, 2)).astype(np.float32)).to(dev)
        delta[:, :3] = torch.tensor([[0.0, 0.0], [0.5, -0.5], [-0.5, 0.5]], device=dev)
        return atlas.contiguous(), torch.from_numpy(xy.astype(np.int32)).to(dev), delta

    def describe_record(name, atlas, axy, delta):
        b, h, w = atlas.shape
        n = axy.shape[1]
        ang, desc = describe.describe_keypoints(atlas, axy, delta)
        ang_p, desc_p = describe.describe_reference(atlas, axy, delta)
        torch.cuda.synchronize()
        check(ang.shape == (b * n,) and desc.shape == (b * n, 32) and desc.dtype == torch.uint8
              and bool(torch.isfinite(ang).all()), "orb_describe: wrong shapes or non-finite angles")
        d_ang = (ang - ang_p).abs()
        d_ang = torch.minimum(d_ang, 2 * np.pi - d_ang)
        bits = np.unpackbits((desc ^ desc_p).cpu().numpy(), axis=1).sum(1)
        ang_ok, same = float((d_ang < 1e-4).float().mean()), float((bits == 0).mean())
        exact = bool(torch.equal(ang, ang_p) and torch.equal(desc, desc_p))
        check(ang_ok >= 0.995 and same >= 0.99 and np.median(bits) == 0 and bits.max() <= 8,
              f"orb_describe at {name} disagrees with the plain version: angles within 1e-4 rad {ang_ok:.4f}, "
              f"descriptors identical {same:.4f}, median {np.median(bits)} bits, max {bits.max()} bits")
        ms, ms2, plain_ms, plain_ms2 = interleaved_times(
            lambda: describe.describe_keypoints(atlas, axy, delta), lambda: describe.describe_reference(atlas, axy, delta))
        own = own_device_ms(lambda: describe.describe_keypoints(atlas, axy, delta), "orb_describe_kernel", describe)
        plain_own, plain_k = device_ms(lambda: describe.describe_reference(atlas, axy, delta))
        x0 = torch.clamp(axy[..., 0] - 15, 0, w - 32).long()
        y0 = torch.clamp(axy[..., 1] - 15, 0, h - 32).long()
        n_pix = sum(covered_pixels(h, w, x0[i], y0[i], 32, 32) for i in range(b))
        bands, rot = describe._kernel_tables_on(dev)
        n_read = n_pix * 4 + axy.numel() * 4 + delta.numel() * 4 + bands.numel() * 4 + rot.numel() * 2
        n_written = b * n * 36
        bytes_ms = (n_read + n_written) / H100_BYTES_PER_S * 1e3
        ops_ms = b * n * describe_flop / H100_FP32_FLOPS * 1e3
        shape = f"{name}: atlas [{b}x{h}x{w}], N={b}x{n}" if b > 1 else f"{name}: atlas [1x{h}x{w}], N={n}"
        print(f"orb_describe ({shape}): angles within 1e-4 rad {ang_ok:.4f} (max diff "
              f"{float(d_ang.max()):.2e}), descriptors identical {same:.4f}, median {np.median(bits):.0f} bits, max "
              f"{bits.max()} bits, {'EXACTLY equal' if exact else 'not exactly equal'} to the plain version; kernel "
              f"{ms * 1e3:.2f}/{ms2 * 1e3:.2f} us, plain {plain_ms * 1e3:.1f}/{plain_ms2 * 1e3:.1f} us per call (CUDA events; "
              f"plain, kernel, kernel, plain); own device time {own * 1e3:.2f} us in 1 kernel (plain: "
              f"{plain_own * 1e3:.1f} us in {plain_k} kernels); bound {max(bytes_ms, ops_ms) * 1e3:.2f} us: "
              f"{n_read + n_written} bytes ({n_pix} atlas pixels under a tile) = {bytes_ms * 1e3:.2f} us at "
              f"{H100_BYTES_PER_S / 1e12:.2f} TB/s, {b * n * describe_flop} float32 operations = {ops_ms * 1e3:.2f} us at "
              f"{H100_FP32_FLOPS / 1e12:.0f} TFLOP/s")
        d_records.append({"shape": shape, "max_abs_err": float(d_ang.max()),
                          "descriptors_identical": same, "max_bits": int(bits.max()), "exact": exact,
                          "ms": min(ms, ms2), "plain_ms": min(plain_ms, plain_ms2),
                          "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                          "library_ms": None, "device_ms": own, "plain_device_ms": plain_own, "plain_kernels": plain_k})

    def sad_record(name, atlas_l, axy_l, atlas_r):
        """stereo_sad on one pair ([h, w] atlases, [n, 2] keypoints) or on
        a batch of pairs ([b, h, w], [b, n, 2]), whose one launch own_device_ms
        checks."""
        h, w = atlas_l.shape[-2:]
        n = axy_l.shape[-2]
        lead = tuple(axy_l.shape[:-2])
        b = int(np.prod(lead)) if lead else 1
        # Whole-number centres as stereo_match gives them (a right column up
        # to 100 px left of the keypoint, the same row), then fractional
        # ones for the blend.
        cx = torch.floor(axy_l[..., 0].float() - torch.from_numpy(
            rng.uniform(0, 100, (*lead, n)).astype(np.float32)).to(dev))
        cy = axy_l[..., 1].float().clone()
        frac = torch.from_numpy(rng.uniform(0, 1, (2, *lead, n)).astype(np.float32)).to(dev)
        worst = 0.0
        for tag, (ccx, ccy) in (("whole", (cx, cy)), ("fractional", (cx + frac[0], cy + frac[1]))):
            sad = stereo_sad.stereo_sad(atlas_l, axy_l, atlas_r, ccx.contiguous(), ccy.contiguous())
            sad_p = stereo_sad.stereo_sad_reference(atlas_l, axy_l, atlas_r, ccx, ccy)
            torch.cuda.synchronize()
            check(sad.shape == (*lead, n, 11) and bool(torch.isfinite(sad).all()),
                  "stereo_sad: wrong shape or non-finite")
            err = (sad - sad_p).abs()
            arg_ok = float((sad.argmin(-1) == sad_p.argmin(-1)).float().mean())
            check(bool((err <= 1e-5 * sad_p + 1e-2).all()) and arg_ok >= 0.999,
                  f"stereo_sad at {name} ({tag} centres) disagrees with the plain version: max abs err "
                  f"{float(err.max()):.3e}, same best slide {arg_ok:.4f}")
            worst = max(worst, float(err.max()))
            print(f"stereo_sad ({name}, {tag} centres): max abs err {float(err.max()):.2e} on SADs up to "
                  f"{float(sad_p.max()):.0f}, same best slide {arg_ok:.4f}, "
                  f"{'EXACTLY equal' if torch.equal(sad, sad_p) else 'not exactly equal'}")
        ms, ms2, plain_ms, plain_ms2 = interleaved_times(
            lambda: stereo_sad.stereo_sad(atlas_l, axy_l, atlas_r, cx, cy),
            lambda: stereo_sad.stereo_sad_reference(atlas_l, axy_l, atlas_r, cx, cy))
        own = own_device_ms(lambda: stereo_sad.stereo_sad(atlas_l, axy_l, atlas_r, cx, cy), "stereo_sad_kernel",
                            stereo_sad)
        plain_own, plain_k = device_ms(lambda: stereo_sad.stereo_sad_reference(atlas_l, axy_l, atlas_r, cx, cy))
        # Needed pixels: the 11x11 left windows, and with whole-number
        # centres (all four blend weights but the first are 0) the 11x21
        # right windows, counted per pair.
        kl, kx, ky = axy_l.reshape(b, n, 2), cx.reshape(b, n), cy.reshape(b, n)
        n_pix = 0
        for i in range(b):
            x0 = torch.clamp(kl[i, :, 0] - 15, 0, w - 32).long()
            y0 = torch.clamp(kl[i, :, 1] - 15, 0, h - 32).long()
            xr = torch.clamp(kx[i].long() - 15, 0, w - 32) + 5
            yr = torch.clamp(ky[i].long() - 15, 0, h - 32) + 10
            n_pix += covered_pixels(h, w, x0 + 10, y0 + 10, 11, 11) + covered_pixels(h, w, xr, yr, 11, 21)
        n_bytes = n_pix * 4 + b * n * (8 + 4 + 4) + b * n * 44
        bytes_ms = n_bytes / H100_BYTES_PER_S * 1e3
        ops_ms = b * n * sad_flop / H100_FP32_FLOPS * 1e3
        shape = f"{name}: atlas [{h}x{w}], N={n}" if not lead else f"{name}: atlases 2 x [{b}x{h}x{w}], N={b}x{n}"
        print(f"stereo_sad ({shape}): kernel {ms * 1e3:.2f}/{ms2 * 1e3:.2f} us, plain "
              f"{plain_ms * 1e3:.1f}/{plain_ms2 * 1e3:.1f} us per call (CUDA events; plain, kernel, kernel, plain); own "
              f"device time {own * 1e3:.2f} us in 1 kernel (plain: {plain_own * 1e3:.1f} us in {plain_k} kernels); "
              f"bound {max(bytes_ms, ops_ms) * 1e3:.2f} us: {n_bytes} bytes ({n_pix} atlas pixels under a window) = "
              f"{bytes_ms * 1e3:.2f} us, {b * n * sad_flop} float32 operations = {ops_ms * 1e3:.2f} us")
        s_records.append({"shape": shape, "max_abs_err": worst,
                          "ms": min(ms, ms2), "plain_ms": min(plain_ms, plain_ms2),
                          "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                          "library_ms": None, "device_ms": own, "plain_device_ms": plain_own, "plain_kernels": plain_k})

    for name, cfg in cells:
        (h, w), n = cell_atlas_shape(cfg), cfg.orb.n_features
        atlas, axy, delta = inputs(2, h, w, n)
        describe_record(name, atlas, axy, delta)
        sad_record(name, atlas[0], axy[0], atlas[1])

        if name == cells[0][0]:
            # What a wrapper costs on the host when it launches nothing
            # (no keypoints): argument checks, output allocation, the
            # stream lookup and the ctypes call.
            img0 = atlas[0]
            none2 = torch.zeros((0, 2), dtype=torch.int32, device=dev)
            none3 = torch.zeros((2, 0, 2), dtype=torch.int32, device=dev)
            nof = torch.zeros((2, 0, 2), device=dev)
            no1 = torch.zeros((0,), device=dev)
            host = {
                "patch_tiles": wrapper_host_us(lambda: patches.gather_patch_tiles(img0, none2)),
                "orb_describe": wrapper_host_us(lambda: describe.describe_keypoints(atlas, none3, nof)),
                "stereo_sad": wrapper_host_us(lambda: stereo_sad.stereo_sad(img0, none2, atlas[1], no1, no1)),
            }
            print("wrapper host time with no keypoints (nothing launched), us per call: "
                  + json.dumps({k: round(v, 2) for k, v in host.items()}))

    # A mono or RGB-D frame describes its keypoints on a batch of one.
    for name, cfg in mono_cells:
        (h, w), n = cell_atlas_shape(cfg), cfg.orb.n_features
        describe_record(name, *inputs(1, h, w, n))

    # A batched multi-sequence frame (phase 14) of B pairs at the first
    # cell's shape: one orb_describe over the 2B images (lefts first) and
    # one stereo_sad over the B pairs.
    name, cfg = cells[0]
    (h, w), n, b = cell_atlas_shape(cfg), cfg.orb.n_features, MULTISEQ_KERNEL_PAIRS
    atlas, axy, delta = inputs(2 * b, h, w, n)
    describe_record(f"{name}, {b} pairs", atlas, axy, delta)
    sad_record(f"{name}, {b} pairs", atlas[:b], axy[:b], atlas[b:])

    def summary(records):
        return {**records[0], "max_abs_err": max(r["max_abs_err"] for r in records), "by_shape": records}

    return summary(d_records), summary(s_records)


# float32 operations one pixel of one level needs for the FAST-9 score and
# the 3x3 NMS: 16 differences from the centre; per sign, the 9-wide
# circular minimum (maximum) of the 16 by windows of 2, 4, 8 and 9 (4 x 16)
# and the best of the 16 (15); the negation and the larger of the two (2);
# 8 comparisons with the neighbours.  The interior mask, the top-k and the
# parabola are integer or per-keypoint work beside it.
FAST_FLOP = 16 + 2 * (4 * 16 + 15) + 2 + 8


def phase_detect(shapes):
    """orb_detect on the card against its plain version (detect_reference)
    on the same card tensors, at the main path's shapes: `shapes` holds
    (name, config, uint8 [b, H, W] images), each run as the front end runs
    it (one image as an [H, W] pyramid, b > 1 as one [b, H, W] batch).  All
    six outputs must be equal (torch.equal) and a call must count
    LAUNCHES_PER_CALL launches.  Then CUDA-event times of kernel and plain
    version (plain, kernel, kernel, plain), the kernel's own device time a
    call and each pass's under torch.profiler, the plain version's device
    time and kernel count, and the bound: the larger of the level pixels
    read once and the outputs written once at the HBM rate, and FAST_FLOP a
    level pixel at the float32 rate.  Returns the kernels-line record."""
    import torch

    from orb_line_slam_tpu_torch.ops import detect
    from orb_line_slam_tpu_torch.ops.image import build_pyramid, pyramid_atlas

    records = []
    for name, cfg, imgs in shapes:
        img = torch.from_numpy(np.ascontiguousarray(imgs)).cuda()
        img = img[0] if img.shape[0] == 1 else img
        levels = build_pyramid(img.to(torch.float32), cfg.orb.n_levels, cfg.orb.scale_factor)
        atlas = pyramid_atlas(levels)[0].contiguous()
        before = detect.launches
        got = detect.detect_keypoints(levels, atlas, cfg.orb)
        ran = detect.launches - before
        want = detect.detect_reference(levels, cfg.orb)
        torch.cuda.synchronize()
        same = [bool(torch.equal(g, w)) for g, w in zip(got, want)]
        err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
        b = imgs.shape[0]
        n_out, n_valid = got[4].numel(), int(want[4].sum())
        check(ran == detect.LAUNCHES_PER_CALL, f"orb_detect at {name}: {ran} launches for one call")
        check(all(same), f"orb_detect at {name} differs from the plain version: (xy, axy, resp, octave, valid, delta) "
                         f"equal {same}, max abs err {err}")

        def kernel():
            return detect.detect_keypoints(levels, atlas, cfg.orb)

        def plain():
            return detect.detect_reference(levels, cfg.orb)

        plain_ms = cuda_times_ms(plain, n=5, reps=2)
        ms = cuda_times_ms(kernel, reps=50)
        ms2 = cuda_times_ms(kernel, reps=50)
        plain_ms2 = cuda_times_ms(plain, n=5, reps=2)
        parts = {}
        own = own_device_ms(kernel, "orb_detect", detect, per_call=detect.LAUNCHES_PER_CALL, parts=parts)
        plain_own, plain_k = device_ms(plain)
        n_pix = b * sum(l.shape[-2] * l.shape[-1] for l in levels)
        n_bytes = n_pix * 4 + n_out * (8 + 8 + 4 + 4 + 1 + 8)
        bytes_ms = n_bytes / H100_BYTES_PER_S * 1e3
        ops_ms = n_pix * FAST_FLOP / H100_FP32_FLOPS * 1e3
        shape = f"{name}: atlas [{b}x{atlas.shape[-2]}x{atlas.shape[-1]}], {len(levels)} levels, N={b}x{n_out // b}"
        print(f"orb_detect ({shape}): all six outputs EXACTLY equal to the plain version ({n_valid} valid keypoints); "
              f"kernel {ms * 1e3:.2f}/{ms2 * 1e3:.2f} us, plain {plain_ms * 1e3:.0f}/{plain_ms2 * 1e3:.0f} us per call "
              f"(CUDA events; plain, kernel, kernel, plain); own device time {own * 1e3:.2f} us in "
              f"{detect.LAUNCHES_PER_CALL} kernels ("
              + ", ".join(f"{k} {v * 1e3:.2f} us" for k, v in sorted(parts.items()))
              + f"; plain: {plain_own * 1e3:.1f} us in {plain_k} kernels); bound {max(bytes_ms, ops_ms) * 1e3:.2f} us: "
              f"{n_bytes} bytes ({n_pix} level pixels read once, {n_out} rows written) = {bytes_ms * 1e3:.2f} us at "
              f"{H100_BYTES_PER_S / 1e12:.2f} TB/s, {n_pix * FAST_FLOP} float32 operations = {ops_ms * 1e3:.2f} us at "
              f"{H100_FP32_FLOPS / 1e12:.0f} TFLOP/s")
        records.append({"shape": shape, "max_abs_err": err, "exact": True, "valid": n_valid,
                        "ms": min(ms, ms2), "plain_ms": min(plain_ms, plain_ms2),
                        "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                        "library_ms": None, "device_ms": own, "pass_device_ms": parts,
                        "plain_device_ms": plain_own, "plain_kernels": plain_k})
    return {**records[0], "max_abs_err": max(r["max_abs_err"] for r in records), "by_shape": records}


# The pose solve's cells (phase 3): the points M the tracking step hands
# it (a frame's feature budget) and the lines L of the final solve (the
# line table's n_lines; 0 with lines off).  Paths A and B run 2x8 without
# lines, the final solve and relocalization 4x10.
POSE_SCHEDULES = ((4, 10), (2, 8))
POSE_PROBLEMS = 10                  # per cell and schedule (20 per cell)
POSE_BATCH = 4                      # a batched multi-sequence step's B
# float32 operations per observation of the function the pose solve
# computes, counted from csrc/pose_solve.cu (a multiply-add 2, a division,
# square root, sine or cosine 1): per LM iteration H, g and the error at
# the pose (residual, Jacobian rows, weight, each row's 21 + 6 products)
# and the error at the candidate (residual, chi2, weight), then one damped
# 6x6 solve and exponential map (~480); per round the gating.  How a
# kernel sums across threads is its own affair and not counted, so every
# version of the kernel is held to one bound.
POSE_FLOP = {"pass1_stereo": 266, "pass1_mono": 189, "pass2_stereo": 45, "pass2_mono": 42, "gate_stereo": 39,
             "gate_mono": 36, "line_pass1": 227, "line_pass2": 65, "line_gate": 65, "iteration": 480}


def pose_cells():
    """The pose solve's cells: (name, config, M, L) of the point,
    point+line and loop cells."""
    return [(name, c, c.orb.n_features, c.lines.n_lines if c.lines.enabled else 0)
            for name, c in (("point cell", kitti_config()), ("point+line cell", euroc_config()),
                            ("loop cell", loop_config()))]


def pose_op_args(cfg, seed, M, L):
    """The operator's arguments for one seeded pose problem, on the card."""
    import torch

    from orb_line_slam_tpu_torch.backend import pose_opt

    t = [torch.from_numpy(a).to("cuda") for a in pose_problem(cfg.camera, seed, M, L)]
    return pose_opt.solve_args(*t[:6], cfg.camera, cfg.orb.scale_factor, *t[6:])


def pose_batch_args(cfg, seed, M, L, B=POSE_BATCH):
    """B seeded problems stacked: a batched step's one launch."""
    import torch

    per = [pose_op_args(cfg, seed + b, M, L) for b in range(B)]
    return (*(torch.stack([p[i] for p in per]) for i in range(11)), *per[0][11:])


def pose_shapes(cells, seed=900):
    """The seven timed shapes of phase 3, one seeded problem each: per cell
    4x10 with its lines and 2x8 without, then a batch of POSE_BATCH at the
    first cell's M with the bench pipeline's lines.  [(label, args,
    rounds, iters)]."""
    shapes = []
    for name, cfg, M, L in cells:
        for rounds, iters in POSE_SCHEDULES:
            lines = L if (rounds, iters) == POSE_SCHEDULES[0] else 0
            shapes.append((f"{name}: M={M}, L={lines}, {rounds}x{iters}", pose_op_args(cfg, seed, M, lines),
                           rounds, iters))
            seed += 1
    name, cfg, M, _ = cells[0]
    L, (rounds, iters) = bench_pipeline_config().lines.n_lines, POSE_SCHEDULES[0]
    shapes.append((f"{name}, a batch of {POSE_BATCH}: M={POSE_BATCH}x{M}, L={POSE_BATCH}x{L}, {rounds}x{iters}",
                   pose_batch_args(cfg, seed, M, L), rounds, iters))
    return shapes


def pose_cluster(args):
    """CTAs in a solve's cluster for these arguments, where the package
    has clusters (None for a kernel of one block a solve)."""
    from orb_line_slam_tpu_torch.backend import pose_opt

    rule = getattr(pose_opt, "cluster_size", None)
    return rule(args[2].shape[-2], args[6].shape[-2]) if rule else None


def pose_shape_times(shapes):
    """Per shape: the kernel's own device time (us, mean of 20 profiled
    launches) and CUDA-event time (us, median of 20 windows of 10), its
    cluster size and own us per LM iteration."""
    from orb_line_slam_tpu_torch.backend import pose_opt

    rows = {}
    for label, args, rounds, iters in shapes:
        kernel = lambda: pose_opt.pose_solve_cuda(*args, rounds, iters)  # noqa: E731
        own = own_device_ms(kernel, "pose_solve_kernel", pose_opt) * 1e3
        rows[label] = {"device_us": own, "events_us": cuda_times_ms(kernel, reps=10) * 1e3,
                       "cluster_ctas": pose_cluster(args), "us_per_lm_iteration": own / (rounds * iters)}
    return rows


def _rodrigues(v):
    th = float(np.linalg.norm(v))
    k = v / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def pose_problem(cam, seed, M, L, mono_frac=0.3, outlier_frac=0.2):
    """A seeded pose problem (numpy, the test generator of
    tests/test_torch_pose_solve.py at a cell's camera): M points seen at a
    true pose with 0.5 px noise per pyramid level, mono_frac of them mono,
    outlier_frac outliers 15-40 px off, 95% valid; L line segments (line
    coefficients through the noisy projected endpoints, outlier_frac of
    them 30 px off); the start pose 0.02 rad and 0.1 m off.  Returns
    pose_optimize's arrays (R0, t0, points, obs, octave, valid[, start,
    end, line obs, line octave, line valid])."""
    rng = np.random.default_rng(seed)
    R_gt, t_gt = _rodrigues(rng.normal(0, 0.3, 3)), rng.normal(0, 1, 3)

    def world(n, z_range):
        uv = np.stack([rng.uniform(0, cam.width, n), rng.uniform(0, cam.height, n)], -1)
        z = rng.uniform(*z_range, n)
        xc = np.stack([(uv[:, 0] - cam.cx) / cam.fx * z, (uv[:, 1] - cam.cy) / cam.fy * z, z], -1)
        return uv, z, (xc - t_gt) @ R_gt

    uv, z, pts = world(M, (2, 30))
    octave = rng.integers(0, 8, M)
    obs = np.concatenate([uv, (uv[:, 0] - cam.bf / z)[:, None]], -1) + rng.normal(0, 1, (M, 3)) * (
        0.5 * 1.2 ** octave)[:, None]
    obs[rng.random(M) < mono_frac, 2] = -1.0
    out = rng.random(M) < outlier_frac
    obs[out, :2] += rng.uniform(15, 40, (out.sum(), 2)) * rng.choice([-1, 1], (out.sum(), 2))
    arrays = [_rodrigues(rng.normal(0, 0.02, 3)) @ R_gt, t_gt + rng.normal(0, 0.1, 3), pts, obs,
              octave.astype(np.int32), rng.random(M) < 0.95]
    if L:
        (a, _, s), (b, _, e) = world(L, (2, 20)), world(L, (2, 20))
        a, b = a + rng.normal(0, 0.5, (L, 2)), b + rng.normal(0, 0.5, (L, 2))
        a[rng.random(L) < outlier_frac] += 30.0
        la, lb, lc = a[:, 1] - b[:, 1], b[:, 0] - a[:, 0], a[:, 0] * b[:, 1] - b[:, 0] * a[:, 1]
        n = np.sqrt(la * la + lb * lb + 1e-12)
        arrays += [s, e, np.stack([la / n, lb / n, lc / n], -1), np.zeros(L, np.int32), rng.random(L) < 0.95]
    return [x.astype(np.float32) if x.dtype.kind == "f" else x for x in arrays]


def pose_solve_need(args, rounds, iters):
    """(bytes, float32 operations) one launch of the pose solve needs on
    these inputs (args: the operator's, one solve or a leading [B]): each
    input read once and each output written once; the operations of
    POSE_FLOP over the rows each round actually visits, read from the
    kernel's own inlier masks after 1 .. rounds - 1 rounds (the schedule's
    prefix: the same launches give the same bits)."""
    from orb_line_slam_tpu_torch.backend import pose_opt

    tensors = args[:11]
    B = tensors[0].shape[0] if tensors[0].dim() == 3 else 1
    M, L = tensors[2].shape[-2], tensors[6].shape[-2]
    n_bytes = sum(x.numel() * x.element_size() for x in tensors) + B * (36 + 12 + M + L + 4 + rounds * iters)
    stereo = tensors[3][..., 2] > 0
    masks = [(tensors[5], tensors[10])]
    for r in range(1, rounds):
        out = pose_opt.pose_solve_cuda(*args, r, iters)
        masks.append((out[2], out[3]))
    f = POSE_FLOP
    ops = 0
    for p_in, l_in in masks:
        n_st, n_mo, n_l = int((p_in & stereo).sum()), int((p_in & ~stereo).sum()), int(l_in.sum())
        ops += iters * (n_st * (f["pass1_stereo"] + f["pass2_stereo"]) + n_mo * (f["pass1_mono"] + f["pass2_mono"])
                        + n_l * (f["line_pass1"] + f["line_pass2"]) + B * f["iteration"])
        ops += int(stereo.sum()) * f["gate_stereo"] + int((~stereo).sum()) * f["gate_mono"] + B * L * f["line_gate"]
    return n_bytes, ops


def phase_pose_solve(cells):
    """The pose-solve kernel on the card vs its plain version (the same
    function on CUDA tensors) at each cell's shapes (cells: (name, cfg, M,
    L)): POSE_PROBLEMS seeded problems per schedule (4x10 with the cell's L
    lines, 2x8 without), then POSE_PROBLEMS // 2 launches of a batch of
    POSE_BATCH at the first cell's M with the bench pipeline's lines.  On
    every problem: rotation within 1e-3 rad, translation within 5e-3 m,
    n_inliers within 3, point and line inlier masks equal on >= 99.5% of
    rows; the accept/reject decisions that differ are counted.  Then, per
    cell and schedule, CUDA-event times of kernel and plain version (plain,
    kernel, kernel, plain), the kernel's own device time and its us per LM
    iteration, the cluster size, the plain version's device time and
    kernel count, and the bound.  Returns the kernels-line record."""
    import torch

    from orb_line_slam_tpu_torch.backend import pose_opt

    records, gaps, flips, flipped_problems, n_problems = [], [], 0, 0, 0

    def hold(got, args, rounds, iters, what):
        """got: the kernel's outputs for args (one solve, or [B])."""
        nonlocal flips, flipped_problems, n_problems
        batched = args[0].dim() == 3
        worst = 0.0
        for b in range(args[0].shape[0] if batched else 1):
            one = [x[b] for x in args[:11]] if batched else list(args[:11])
            k = [x[b] for x in got] if batched else list(got)
            p = pose_opt.pose_solve_plain(*one, *args[11:], rounds, iters)
            rad = rotation_gap(k[0].cpu().numpy()[None], p[0].cpu().numpy()[None])
            dt = float((k[1] - p[1]).abs().max())
            p_agree = float((k[2] == p[2]).float().mean())
            l_agree = float((k[3] == p[3]).float().mean()) if k[3].numel() else 1.0
            n_k, n_p = int(k[4]), int(p[4])
            differ = int((k[5] != p[5]).sum())
            flips += differ
            flipped_problems += differ > 0
            n_problems += 1
            gaps.append((rad, dt))
            worst = max(worst, float((k[0] - p[0]).abs().max()), dt)
            check(bool(torch.isfinite(k[0]).all() and torch.isfinite(k[1]).all()), f"pose_solve {what}: non-finite pose")
            check(rad < 1e-3 and dt < 5e-3 and abs(n_k - n_p) <= 3 and p_agree >= 0.995 and l_agree >= 0.995,
                  f"pose_solve {what}, solve {b}: kernel vs plain {rad:.2e} rad, {dt:.2e} m, inliers {n_k} / {n_p}, "
                  f"masks agree {p_agree:.4f} / {l_agree:.4f}")
        return worst

    def timed(name, args, rounds, iters, worst):
        kernel = lambda: pose_opt.pose_solve_cuda(*args, rounds, iters)  # noqa: E731
        # A batch's plain version: the plain solve under vmap, as the
        # operator runs B solves on the CPU.
        solve = pose_opt.pose_solve_plain if args[0].dim() == 2 else \
            torch.func.vmap(pose_opt.pose_solve_plain, in_dims=(0,) * 11 + (None,) * 7)
        plain = lambda: solve(*args, rounds, iters)  # noqa: E731
        # Its own device time first: a window taken after the batch's
        # vmapped plain version came back one record short six times out
        # of six on the card.
        own = own_device_ms(kernel, "pose_solve_kernel", pose_opt)
        plain_ms = cuda_times_ms(plain, n=3, warmup=1)
        ms = cuda_times_ms(kernel, reps=10)
        ms2 = cuda_times_ms(kernel, reps=10)
        plain_ms2 = cuda_times_ms(plain, n=3, warmup=1)
        plain_own, plain_k = device_ms(plain)
        n_bytes, ops = pose_solve_need(args, rounds, iters)
        bytes_ms, ops_ms = n_bytes / H100_BYTES_PER_S * 1e3, ops / H100_FP32_FLOPS * 1e3
        ctas, per_iter = pose_cluster(args), own * 1e3 / (rounds * iters)
        print(f"pose_solve ({name}, {rounds}x{iters}): a cluster of {ctas} CTAs a solve; kernel {ms * 1e3:.1f}/"
              f"{ms2 * 1e3:.1f} us, plain {plain_ms:.2f}/{plain_ms2:.2f} ms per solve (CUDA events; plain, kernel, "
              f"kernel, plain); own device time {own * 1e3:.1f} us in 1 kernel, {per_iter:.2f} us per LM iteration "
              f"(plain: {plain_own:.2f} ms in {plain_k} kernels); bound {max(bytes_ms, ops_ms) * 1e3:.3f} us: "
              f"{n_bytes} bytes = {bytes_ms * 1e3:.3f} us, {ops} float32 operations = {ops_ms * 1e3:.3f} us")
        records.append({"shape": f"{name}, {rounds}x{iters}", "max_abs_err": worst, "ms": min(ms, ms2),
                        "plain_ms": min(plain_ms, plain_ms2), "bound_ms": max(bytes_ms, ops_ms),
                        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "library_ms": None,
                        "device_ms": own, "plain_device_ms": plain_own, "plain_kernels": plain_k,
                        "cluster_ctas": ctas, "us_per_lm_iteration": per_iter})

    seed = 100
    for name, cfg, M, L in cells:
        for rounds, iters in POSE_SCHEDULES:
            lines = L if (rounds, iters) == POSE_SCHEDULES[0] else 0
            worst, args = 0.0, None
            for _ in range(POSE_PROBLEMS):
                seed += 1
                args = pose_op_args(cfg, seed, M, lines)
                worst = max(worst, hold(pose_opt.pose_solve_cuda(*args, rounds, iters), args, rounds, iters, name))
            timed(f"{name}: M={M}, L={lines}", args, rounds, iters, worst)
    # A batched multi-sequence step: B solves in one launch of B clusters.
    name, cfg, M, _ = cells[0]
    L, (rounds, iters) = bench_pipeline_config().lines.n_lines, POSE_SCHEDULES[0]
    worst = 0.0
    for _ in range(POSE_PROBLEMS // 2):
        args = pose_batch_args(cfg, seed, M, L)
        seed += POSE_BATCH
        before = pose_opt.launches
        got = pose_opt.pose_solve_cuda(*args, rounds, iters)
        check(pose_opt.launches == before + 1 and got[0].shape == (POSE_BATCH, 3, 3),
              "pose_solve: a batch was not one launch")
        worst = max(worst, hold(got, args, rounds, iters, f"{name}, batch of {POSE_BATCH}"))
    timed(f"{name}, a batch of {POSE_BATCH}: M={POSE_BATCH}x{M}, L={POSE_BATCH}x{L}", args, rounds, iters, worst)
    rad = np.array([g[0] for g in gaps])
    dt = np.array([g[1] for g in gaps])
    print(f"pose_solve kernel vs plain over {n_problems} seeded problems: rotation median {np.median(rad):.2e} rad "
          f"(max {rad.max():.2e}), translation median {np.median(dt):.2e} m (max {dt.max():.2e}); accept/reject "
          f"decisions that differ: {flips} in {flipped_problems} of {n_problems} problems")
    return {**records[0], "max_abs_err": max(r["max_abs_err"] for r in records), "by_shape": records,
            "problems": n_problems, "median_rotation_rad": float(np.median(rad)),
            "median_translation_m": float(np.median(dt)), "decisions_differing": flips,
            "problems_with_a_differing_decision": flipped_problems}


def sequence_job(cfg, n_frames, scene_kw=None, step=0.25):
    """The render job of a stereo slice along circular_trajectory."""
    from orb_line_slam_tpu_torch.data.synthetic import SyntheticScene, circular_trajectory

    return SyntheticScene(cfg.camera, **(scene_kw or dict(n_points=700, seed=3))), \
        circular_trajectory(n_frames, step=step), "stereo"


def render_sequence(cfg, n_frames, scene_kw=None, step=0.25):
    job = sequence_job(cfg, n_frames, scene_kw, step)
    return job[1], render_jobs([job])[0]


def tile_watch(n_feat):
    """A TorchDispatchMode class that records every operator output shaped
    [>= n_feat, ..., 32, 32]: a tile tensor of the frame's keypoints."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class TileWatch(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor) and t.dim() >= 3 and tuple(t.shape[-2:]) == (32, 32) \
                        and t.shape[0] >= n_feat:
                    self.seen.append((str(func), tuple(t.shape)))
            return out

    return TileWatch


def phase_frame(cfg, pair):
    """build_stereo_frame on the card vs the plain path on the CPU; on the
    card it launches exactly one orb_describe and one stereo_sad kernel and
    one detection call's orb_detect kernels, and makes no [N, 32, 32] tile
    tensor."""
    import torch

    from orb_line_slam_tpu_torch.frontend.frame import build_stereo_frame

    TileWatch = tile_watch(cfg.orb.n_features)
    l, r = (torch.from_numpy(x) for x in pair)
    fc = build_stereo_frame(l, r, cfg).numpy()
    lg, rg = l.cuda(), r.cuda()
    build_stereo_frame(lg, rg, cfg)
    reset_launches()
    with TileWatch() as watch:
        fg = build_stereo_frame(lg, rg, cfg)
    torch.cuda.synchronize()
    launches = read_launches()
    check(launches == {"patch_tiles": 0, "orb_describe": 1, "stereo_sad": 1, "pose_solve": 0,
                       "orb_detect": detect_launches(1)},
          f"build_stereo_frame on the card launched {launches} (want one orb_describe, one stereo_sad, one "
          "detection call's orb_detect launches, no patch_tiles)")
    check(not watch.seen, f"build_stereo_frame on the card made tile tensors: {watch.seen[:3]}")
    with TileWatch() as watch_cpu:
        build_stereo_frame(l, r, cfg)
    check(len(watch_cpu.seen) > 0, "the tile watch saw no tile tensor on the CPU plain path: it watches nothing")
    stages = frame_stage_profile(cfg, lg, rg)
    check(stages["describe_stage"]["kernels"] == 1 and stages["sad_stage"]["kernels"] == 1,
          f"the describe and SAD stages are not one device kernel each: {stages}")
    check(stages["detect_stage"]["kernels"] == detect_launches(1),
          f"the detection stage is not orb_detect's {detect_launches(1)} device kernels: {stages}")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    build_stereo_frame(lg, rg, cfg)
    torch.cuda.synchronize()
    peak_mb = (torch.cuda.max_memory_allocated() - base) / 1e6
    print(f"frame on the card: kernel launches {json.dumps(launches)}, no [N, 32, 32] tensor among its operator outputs "
          f"(the CPU plain path makes {len(watch_cpu.seen)}); peak device memory of one call {peak_mb:.1f} MB above the "
          f"resident set")
    print("frame stages on the card, device ms and kernels per call (torch.profiler, mean of 5): " + json.dumps(stages))
    fg = fg.numpy()
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


def phase_stereo_match_kernel_vs_plain(cfg, pair):
    """stereo_match on the card through the stereo_sad kernel vs the same
    call through its plain version, on one real frame's features: stereo-hit
    agreement >= 0.99 and depths within 1e-4 relative where both hit (the
    two SADs differ only in the order of a 121-term float32 sum)."""
    import torch

    from orb_line_slam_tpu_torch.frontend import stereo
    from orb_line_slam_tpu_torch.frontend.orb_extractor import extract_orb_stereo
    from orb_line_slam_tpu_torch.ops.stereo_sad import stereo_sad_reference

    l, r = (torch.from_numpy(x).cuda() for x in pair)
    args = extract_orb_stereo(l, r, cfg.orb)
    featL, atlasL, axyL, deltaL, featR, atlasR, offs = args
    got = stereo.stereo_match(featL, featR, atlasL, axyL, deltaL, atlasR, offs, cfg.camera, cfg.orb)
    kernel_fn, stereo.stereo_sad = stereo.stereo_sad, stereo_sad_reference
    try:
        want = stereo.stereo_match(featL, featR, atlasL, axyL, deltaL, atlasR, offs, cfg.camera, cfg.orb)
    finally:
        stereo.stereo_sad = kernel_fn
    dk, dp = got.depth.cpu().numpy(), want.depth.cpu().numpy()
    hit_agree = float(((dk > 0) == (dp > 0)).mean())
    hit = (dk > 0) & (dp > 0)
    rel = np.abs(dk[hit] - dp[hit]) / dp[hit]
    print(f"stereo_match through the stereo_sad kernel vs its plain version: stereo-hit agreement {hit_agree:.4f}, "
          f"{int(hit.sum())} common depths, worst relative difference {rel.max():.2e}")
    check(hit_agree >= 0.99 and hit.sum() > 100 and rel.max() <= 1e-4,
          "stereo_match through the kernel disagrees with the plain version")


def phase_single_image(cfg, frames, n_images=5):
    """extract_orb_with_tiles, the single-image entry point that returns
    sub-pixel-shifted tiles, on the card: it is the path that keeps the
    patch-tile gather (one launch per image, no orb_describe; one
    detection call per image).  Held to the
    CPU plain path under the frame contract's keypoint and descriptor
    terms.  Returns the launches."""
    import torch

    from orb_line_slam_tpu_torch.frontend.orb_extractor import extract_orb_with_tiles

    reset_launches()
    for l, _ in frames[:n_images]:
        fg, tiles = extract_orb_with_tiles(torch.from_numpy(l).cuda(), cfg.orb)
    torch.cuda.synchronize()
    launches = read_launches()
    check(launches == {"patch_tiles": n_images, "orb_describe": 0, "stereo_sad": 0, "pose_solve": 0,
                       "orb_detect": detect_launches(n_images)},
          f"extract_orb_with_tiles on {n_images} images launched {launches} (want one patch_tiles and one detection "
          "call per image)")
    check(tiles.shape == (cfg.orb.n_features, 32, 32) and tiles.is_cuda, f"tiles {tuple(tiles.shape)}")
    fc, _ = extract_orb_with_tiles(torch.from_numpy(frames[n_images - 1][0]), cfg.orb)
    vc, vg = fc.valid.numpy(), fg.valid.cpu().numpy()
    both = vc & vg
    d_xy = float(np.abs(fc.xy.numpy()[both] - fg.xy.cpu().numpy()[both]).max())
    bits = np.unpackbits(fc.desc.numpy()[both] ^ fg.desc.cpu().numpy()[both], axis=1).sum(1)
    print(f"single image with tiles (extract_orb_with_tiles) GPU vs CPU: {n_images} images, "
          f"{launches['patch_tiles']} patch-tile launches, valid agreement {(vc == vg).mean():.4f}, max keypoint diff "
          f"{d_xy:.2e} px, median desc bits {np.median(bits):.0f}")
    check((vc == vg).mean() > 0.98 and d_xy < 0.51 and np.median(bits) <= 1,
          "extract_orb_with_tiles on the card breaks the frame contract against the CPU plain path")
    return launches


def phase_mono_rgbd_frames(cfg, img, depth):
    """build_mono_frame and build_rgbd_frame on one TUM-size image on the
    card: each launches exactly one orb_describe (a batch of one), one
    detection call's orb_detect kernels and no patch_tiles, makes no [N, 32, 32] tensor, and holds to its CPU plain
    path under the frame contract (valid agreement > 0.98, keypoints
    within 0.51 px, median descriptor distance <= 1 bit; RGB-D: depth-hit
    agreement > 0.95, > 95% of depths within 1%).  Returns the CUDA-event
    ms of each frame (median of 20)."""
    import torch

    from orb_line_slam_tpu_torch.frontend.frame import build_mono_frame, build_rgbd_frame

    TileWatch = tile_watch(cfg.orb.n_features)
    times = {}
    for kind, build, args in (("mono", build_mono_frame, (img,)), ("rgbd", build_rgbd_frame, (img, depth))):
        cpu_args = tuple(torch.from_numpy(a) for a in args)
        gpu_args = tuple(a.cuda() for a in cpu_args)
        fc = build(*cpu_args, cfg).numpy()
        build(*gpu_args, cfg)
        reset_launches()
        with TileWatch() as watch:
            fg = build(*gpu_args, cfg)
        torch.cuda.synchronize()
        launches = read_launches()
        check(launches == {"patch_tiles": 0, "orb_describe": 1, "stereo_sad": 0, "pose_solve": 0,
                           "orb_detect": detect_launches(1)},
              f"build_{kind}_frame on the card launched {launches} (want one orb_describe, one detection call's "
              "orb_detect launches and nothing else)")
        check(not watch.seen, f"build_{kind}_frame on the card made tile tensors: {watch.seen[:3]}")
        check(fg.xy.is_cuda and fg.depth.is_cuda, f"build_{kind}_frame left the card")
        fg = fg.numpy()
        agree = float((fc.valid == fg.valid).mean())
        both = fc.valid & fg.valid
        d_xy = float(np.abs(fc.xy[both] - fg.xy[both]).max())
        bits = np.unpackbits(fc.desc[both] ^ fg.desc[both], axis=1).sum(1)
        ok = agree > 0.98 and d_xy < 0.51 and np.median(bits) <= 1
        dc, dg = fc.depth[both], fg.depth[both]
        extra = ""
        if kind == "mono":
            ok = ok and bool((fg.depth == -1).all() and (fg.u_right == -1).all())
        else:
            hit_agree = float(((dc > 0) == (dg > 0)).mean())
            hit = (dc > 0) & (dg > 0)
            frac = float((np.abs(dc[hit] - dg[hit]) / np.maximum(dg[hit], 1e-6) < 0.01).mean())
            ok = ok and hit_agree > 0.95 and frac > 0.95 and hit.sum() > 100
            extra = f", depth-hit agreement {hit_agree:.4f}, depths within 1% {frac:.4f} ({int(hit.sum())} depths)"
        ms = cuda_times_ms(lambda: build(*gpu_args, cfg))
        times[kind] = ms
        print(f"{kind} frame (build_{kind}_frame, 480x640, {cfg.orb.n_features} features, {cfg.orb.n_levels} levels) GPU vs "
              f"CPU: launches {json.dumps(launches)}, no [N, 32, 32] tensor; valid agreement {agree:.4f}, max keypoint "
              f"diff {d_xy:.2e} px, median desc bits {np.median(bits):.0f} ({(bits == 0).mean():.4f} identical){extra}; "
              f"{ms:.2f} ms per frame (CUDA events, median of 20)")
        check(ok, f"the {kind} frame on the card breaks the frame contract against the CPU plain path")
    return times


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


KERNELS = ("patch_tiles", "orb_describe", "stereo_sad", "pose_solve", "orb_detect")
# The function each kernel replaces in the JAX package: the one Pallas
# kernel, and TPU-shaped XLA code (the jitted pose solve; orb_detect
# replaces no Pallas kernel, only the per-level detection XLA fuses).
REPLACES = {"patch_tiles": "orb_line_slam_tpu/ops/pallas_patches.py:99",
            "orb_describe": "orb_line_slam_tpu/ops/pallas_patches.py:99",
            "stereo_sad": "orb_line_slam_tpu/ops/pallas_patches.py:99",
            "pose_solve": "orb_line_slam_tpu/backend/pose_opt.py:57",
            "orb_detect": "orb_line_slam_tpu/frontend/orb_extractor.py:50"}


def kernel_modules():
    from orb_line_slam_tpu_torch.backend import pose_opt
    from orb_line_slam_tpu_torch.ops import describe, detect, patches, stereo_sad

    return dict(zip(KERNELS, (patches, describe, stereo_sad, pose_opt, detect)))


def detect_launches(n_calls):
    """orb_detect's launches for n_calls detection calls (every stereo
    pair, batch of pairs, mono or RGB-D frame, or image with tiles is one)."""
    from orb_line_slam_tpu_torch.ops import detect

    return detect.LAUNCHES_PER_CALL * n_calls


def reset_launches():
    for mod in kernel_modules().values():
        mod.launches = 0


def read_launches():
    return {name: mod.launches for name, mod in kernel_modules().items()}


def add_launches(total, part):
    for name, n in part.items():
        total[name] = total.get(name, 0) + n


class PoseSolveSites:
    """While entered, counts the calls that launch pose solves: the
    tracking step (three solves a call; the batched multi-sequence step of
    B sequences is one call) and Tracker._pose_opt_from_assoc (one solve: a
    reference-keyframe track or a relocalization).  ``expected()`` is the
    pose-solve launches they account for since the last ``reset()``."""

    def __enter__(self):
        from orb_line_slam_tpu_torch.pipeline import track_step as step_mod, tracking

        self._lock = threading.Lock()
        self._saved = [(tracking, "track_step", tracking.track_step), (step_mod, "track_step", step_mod.track_step),
                       (tracking.Tracker, "_pose_opt_from_assoc", tracking.Tracker._pose_opt_from_assoc)]
        self.reset()

        def counted(fn, key):
            def wrapper(*a, **k):
                with self._lock:
                    self.counts[key] += 1
                return fn(*a, **k)
            return wrapper

        for obj, name, fn in self._saved:
            setattr(obj, name, counted(fn, "assoc_solves" if name == "_pose_opt_from_assoc" else "track_steps"))
        return self

    def __exit__(self, *exc):
        for obj, name, fn in self._saved:
            setattr(obj, name, fn)

    def reset(self):
        self.counts = {"track_steps": 0, "assoc_solves": 0}

    def expected(self):
        return 3 * self.counts["track_steps"] + self.counts["assoc_solves"]


def to_cpu(x):
    """CPU copies of the tensors in x (a tensor, or tuples, named or not,
    of them; copies also of CPU tensors, which the tracker may write in
    place later); anything else as it is."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_cpu(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(to_cpu(v) for v in x)
    return x


class TrackStepLog:
    """While entered, records each Tracker step: per consumed tracking step
    (frame id, whether the step itself tracked, its inliers, the state,
    the pose and the keyframe count after the frame), each
    relocalization (frame id, success, the keyframe it ended on, the
    first five keyframe-database candidates where there is a database),
    and CPU copies of the inputs and outputs of chosen tracking steps: every
    `every`-th frame and the first `keep_failed` steps that did not
    track.  ``replay()`` runs the kept steps again on the CPU."""

    def __init__(self, every=0, keep_failed=0):
        self.every, self.keep_failed = every, keep_failed

    def __enter__(self):
        from orb_line_slam_tpu_torch.pipeline import tracking

        T = tracking.Tracker
        self._saved = [(tracking, "track_step", tracking.track_step), (T, "_dispatch_track_step", T._dispatch_track_step),
                       (T, "_consume", T._consume), (T, "_relocalize", T._relocalize)]
        step, dispatch, consume, relocalize = (fn for _, _, fn in self._saved)
        self.step_fn = step
        self.steps, self.relocs, self.kept = [], [], []
        self.frame = -1     # the frame of the latest tracking step
        last = {}
        n_failed = [0]

        def captured(*a, **k):
            out = step(*a, **k)
            last["call"] = (a, k)
            return out

        def dispatched(tr, frame, lines):
            self.frame = tr.frame_id
            out = dispatch(tr, frame, lines)
            a, k = last.pop("call")
            ok = bool(out.ok)
            keep = bool(self.every) and tr.frame_id % self.every == 0
            if not ok and n_failed[0] < self.keep_failed:
                n_failed[0] += 1
                keep = True
            if keep:
                self.kept.append((tr.frame_id, to_cpu(a), k, to_cpu(out)))
            return out

        def consumed(tr, e):
            ok = bool(e.out.ok)
            consume(tr, e)
            self.steps.append((e.fid, ok, int(e.out.n_inliers), tr.state, tr.R.copy(), tr.t.copy(),
                               int(tr.map.n_keyframes())))

        def relocalized(tr, frame):
            cands = tr.reloc_candidates_fn(frame)[:5] if tr.reloc_candidates_fn is not None else None
            r = relocalize(tr, frame)
            self.relocs.append({"frame": tr.frame_id, "ok": bool(r[0]), "kf": int(tr.ref_kf),
                                "db_candidates": cands and [int(k) for k in cands]})
            return r

        for (obj, name, _), fn in zip(self._saved, (captured, dispatched, consumed, relocalized)):
            setattr(obj, name, fn)
        return self

    def __exit__(self, *exc):
        for obj, name, fn in self._saved:
            setattr(obj, name, fn)

    def replay(self):
        """Each kept step on the CPU from the card's inputs: a list of
        (frame id, (tracked, inliers) on the card, the same on the CPU,
        the gap between the two poses in rad and in map units)."""
        out = []
        for fid, a, k, card in self.kept:
            cpu = self.step_fn(*a, **k)
            rot = rotation_gap(card.R[None].numpy(), cpu.R[None].numpy())
            out.append((fid, (bool(card.ok), int(card.n_inliers)), (bool(cpu.ok), int(cpu.n_inliers)), rot,
                        float((card.t - cpu.t).abs().max())))
        return out


def run_slice(cfg, poses, frames, name, dt, use_loop_closing=False, shipping=False, warmup=WARMUP_FRAMES,
              window=None, sensor="stereo", check_launches=True, end_tracked=True):
    """Drive the System on the card over the frames (``sensor`` "stereo":
    (left, right) pairs through track_stereo; "mono": images through
    track_monocular; "rgbd": (image, depth) pairs through track_rgbd), with
    every kernel's launch count set to 0 just before and read just after:
    on the pinned schedule, or with shipping=True on the System's defaults.
    The tracking thread's stream is synchronised after each frame (not
    the device: the workers' solves run on their own streams).  A
    ProfileWindow `window` profiles a few frames of the run; they are left
    out of its frames/s and per-frame times.  Returns (System, launches
    per kernel, fps over frames warmup.. (warmup None: the frames after
    the first tracked one), ATE (a monocular run's over its tracked
    frames, similarity-aligned), the per-frame host ms {p50, p90, max}
    over the same frames).  Every pose-solve launch must come from a
    tracking step (three each) or a solve from associations (one each);
    check_launches=False skips the launch checks (another tree's package,
    whose kernels differ); end_tracked=False lets the run end LOST (a
    monocular System without a loop closer has no relocalization
    candidates)."""
    import torch

    from orb_line_slam_tpu_torch.eval.trajectory import ate_rmse
    from orb_line_slam_tpu_torch.pipeline.system import System

    slam = System(cfg, use_loop_closing=use_loop_closing, device="cuda") if shipping else \
        System(cfg, use_loop_closing=use_loop_closing, async_loop=False, device="cuda")
    if not shipping:
        slam.gba_async = False
        slam.tracker.async_mapping = False
    check(slam.tracker.async_mapping == slam.async_loop == slam.gba_async == shipping,
          f"{name}: the System's schedule is not the one asked for")
    track = {"stereo": slam.track_stereo, "mono": slam.track_monocular, "rgbd": slam.track_rgbd}[sensor]
    stream = torch.cuda.current_stream()
    frame_ms = []
    with PoseSolveSites() as sites:
        reset_launches()
        for i, fr in enumerate(frames):
            if window is not None:
                window.before(i)
            t0 = time.perf_counter()
            track(*(fr if isinstance(fr, tuple) else (fr,)), timestamp=dt * i)
            stream.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            if window is not None:
                window.after(i, frame_ms[-1])
        slam.shutdown()
        torch.cuda.synchronize()
        launches = read_launches()
    traj = slam.tracker.final_trajectory()
    est = np.stack([-R.T @ t for (_, _, R, t, _) in traj])
    gt = np.stack([-R.T @ t for (R, t) in poses])
    check(np.isfinite(est).all() and est.shape == gt.shape, f"{name}: trajectory not finite / wrong shape {est.shape}")
    tracked = np.array([not lost for (_, _, _, _, lost) in traj])
    check(tracked.any(), f"{name}: no frame was tracked")
    if warmup is None:
        warmup = int(np.argmax(tracked)) + 1
    if sensor == "mono":    # scale-free: similarity alignment over the tracked frames
        ate = float(ate_rmse(est[tracked], gt[tracked], align=True, with_scale=True))
    else:
        ate = float(ate_rmse(est, gt, align=True))
    profiled_frames = window.frames if window is not None else set()
    steady = np.asarray([ms for i, ms in enumerate(frame_ms) if i >= warmup and i not in profiled_frames])
    fps = len(steady) / (steady.sum() / 1e3)
    per_frame = {"p50": float(np.percentile(steady, 50)), "p90": float(np.percentile(steady, 90)),
                 "max": float(steady.max())}
    n_kf = int(slam.map.n_keyframes())
    tr = slam.tracker
    lags = tr.ba_lag_frames
    lag_hist = {int(k): int(v) for k, v in zip(*np.unique(lags, return_counts=True))}
    host_probe(f"after the {name}")
    print(f"{name}: {len(frames)} frames, state {slam.tracking_state()}, {n_kf} keyframes, "
          f"{tr.n_local_ba} local BAs applied, {tr.n_ba_skipped} skipped, {tr.n_ba_stale} discarded as stale, "
          f"kernel launches {json.dumps(launches)}; {sites.counts['track_steps']} tracking steps and "
          f"{sites.counts['assoc_solves']} solves from associations")
    print(f"{name} ({'shipping' if shipping else 'pinned'} schedule): tracking thread's host ms per frame over frames "
          f"{warmup}-{len(frames) - 1}" + (f" but the {len(profiled_frames)} profiled" if profiled_frames else "")
          + f": p50 {per_frame['p50']:.1f}, p90 {per_frame['p90']:.1f}, max {per_frame['max']:.1f}; worker busy s "
          f"{json.dumps({k: round(v, 3) for k, v in slam.worker_busy_s().items()})}")
    if shipping:
        # The deferred BA's lag: frames from its pack to its apply.  A BA
        # still pending keeps _need_keyframe's mapping-idle clause off, so
        # a lag of 2+ frames thins out keyframes (ROADMAP Queue 3).
        print(f"{name}: {len(lags)} deferred local BAs applied, frames from pack to apply {json.dumps(lag_hist)}, "
              f"max {max(lags, default=0)}, {sum(g <= 1 for g in lags)} of {len(lags)} within one frame")
    print(f"{name} stages: " + json.dumps(tr.timing.table(len(frames))))
    if window is not None:
        window.report()
    check(slam.tracking_state() == "OK" or not end_tracked, f"{name}: final state {slam.tracking_state()}")
    check(n_kf >= 3, f"{name}: only {n_kf} keyframes")
    check(tr.n_local_ba >= 1, f"{name}: no local BA was applied")
    # One detection call (orb_detect's launches) and one orb_describe per
    # frame, one stereo_sad per stereo pair, no tile gather, and three pose
    # solves per tracking step.
    n_sad = len(frames) if sensor == "stereo" else 0
    want = {"patch_tiles": 0, "orb_describe": len(frames), "stereo_sad": n_sad, "pose_solve": sites.expected(),
            "orb_detect": detect_launches(len(frames))}
    check(not check_launches or (launches == want and sites.counts["track_steps"] > 0),
          f"{name}: kernel launches {launches} for {len(frames)} frames, {sites.counts} (want one detection call and "
          "one orb_describe" + (" and one stereo_sad" if n_sad else "") + " per frame, three pose solves per tracking "
          "step and one per solve from associations)")
    slam.pose_solve_sites = dict(sites.counts)
    return slam, launches, fps, ate, per_frame


def check_ate(name, ate, ref):
    """ATE is an error: the port may not be worse than the JAX package by
    more than 10% + 1 cm.  A lower error is not a fault: which frames
    become keyframes moves either package's ATE between a few modes."""
    bound = 1.1 * ref + 0.01
    check(ate <= bound, f"{name}: ATE {ate:.5f} m exceeds {bound:.5f} m (JAX reference {ref:.5f} m + 10% + 1 cm)")


def check_three_solves_per_frame(name, slam, launches, n_frames):
    """A pinned stereo slice: every frame after the first (which
    initialises the map) is one tracking step, three pose-solve launches,
    and no other solve runs."""
    sites = slam.pose_solve_sites
    print(f"{name}: {launches['pose_solve']} pose-solve launches for {sites['track_steps']} tracking steps of "
          f"{n_frames} frames ({launches['pose_solve'] / max(sites['track_steps'], 1):.2f} per tracked frame), "
          f"{sites['assoc_solves']} solves from associations")
    check(sites == {"track_steps": n_frames - 1, "assoc_solves": 0} and launches["pose_solve"] == 3 * (n_frames - 1),
          f"{name}: {launches['pose_solve']} pose-solve launches, {sites}: want 3 per frame after the first")


def phase_slice(cfg, poses, frames):
    slam, launches, fps, ate, _ = run_slice(cfg, poses, frames, "slice", 0.1)
    ba = slam.tracker.timing.table().get("local_ba", {"ms_per_call": float("nan")})
    print(f"slice: {fps:.2f} frames/s steady state (frames {WARMUP_FRAMES}-{len(frames) - 1}), "
          f"{ba['ms_per_call']:.1f} ms per local BA, ATE {ate:.5f} m "
          f"(JAX CPU reference {JAX_CPU_REFERENCE_ATE_M:.5f} m)")
    check_ate("slice", ate, JAX_CPU_REFERENCE_ATE_M)
    check_three_solves_per_frame("slice", slam, launches, len(frames))
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
    """Phase 7, and phase 8: its profile window (frames 33-35: keyframe 34
    and its joint BA fall inside)."""
    slam, launches, fps, ate, _ = run_slice(cfg, poses, frames, "point+line slice", 0.05,
                                            window=ProfileWindow("point+line slice"))
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
    check_three_solves_per_frame("point+line slice", slam, launches, len(frames))
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


# Profiler windows taken again because device records were missing.
profile_retakes = 0
MAX_RETAKES = 5


class DeviceRecord(NamedTuple):
    name: str
    start: float     # us from the trace's start
    end: float
    stream: int


LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")


def device_records(prof):
    """The device records of a profile (kernels, copies and the device side
    of record_function ranges), read once from the profiler's raw events,
    with the count of kernel-launch calls as ``prof.launch_calls``.
    torch.profiler's own ``events()`` first builds a tree of every host and
    device event, which took about a minute for a window of three tracked
    frames."""
    import torch

    if not hasattr(prof, "device_records"):
        raw = prof.profiler.kineto_results
        t0, cuda = raw.trace_start_ns(), torch.autograd.DeviceType.CUDA
        recs, launches = [], 0
        for e in raw.events():
            if e.device_type() == cuda:
                start = e.start_ns() - t0
                recs.append(DeviceRecord(e.name(), start / 1e3, (start + e.duration_ns()) / 1e3,
                                         e.device_resource_id()))
            elif e.name() in LAUNCH_CALLS:
                launches += 1
        prof.device_records, prof.launch_calls = recs, launches
    return prof.device_records


def profiled(fn, complete, what):
    """Run fn under torch.profiler until complete(device records) holds,
    and return the profile.  torch.profiler now and then returns a window
    with no device records, or with one missing; such a window is taken
    again, at most MAX_RETAKES times, then the run fails."""
    global profile_retakes
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(MAX_RETAKES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = len(device_records(prof))
        if complete(n):
            return prof
        profile_retakes += 1
        print(f"profile {attempt + 1} of {what} came back with {n} device records: taken again", flush=True)
        time.sleep(0.5)
    fail(f"profiler: no complete window of {what} in {MAX_RETAKES + 1} attempts")


def device_kernels(fn):
    """The device kernel records of one call of fn under torch.profiler."""
    fn()
    return device_records(profiled(fn, lambda n: n > 0, "one call"))


def device_ms(fn):
    """(device-busy ms, kernels) of one call of fn under torch.profiler:
    the sum of the device kernels' own times, whatever the host took."""
    kern = device_kernels(fn)
    return sum(e.end - e.start for e in kern) / 1e3, len(kern)


def own_device_ms(fn, name, module, calls=20, per_call=1, parts=None):
    """Mean own device time (ms) of the hand-written kernel `name` over
    `calls` calls of its wrapper fn.  The wrapper's own count (`module`'s
    `launches`) must read exactly `calls` x `per_call` afterwards.  The
    profile must hold exactly that many device records, all of that
    kernel: a window that lost one is taken again, not averaged.  A dict
    `parts` receives the mean ms per call of each device kernel name."""
    fn()
    n = calls * per_call

    def run():
        module.launches = 0
        for _ in range(calls):
            fn()

    prof = profiled(run, lambda k: k >= n, f"{calls} calls of {name}")
    check(module.launches == n, f"{name}'s wrapper counted {module.launches} launches for {calls} calls")
    kern = device_records(prof)
    other = sorted({e.name for e in kern if name not in e.name})
    check(not other, f"{name}'s wrapper launched other device kernels: {other[:3]}")
    check(len(kern) == n, f"{name}: {len(kern)} device kernels recorded for {calls} calls")
    if parts is not None:
        for e in kern:
            parts[e.name] = parts.get(e.name, 0.0) + (e.end - e.start) / 1e3 / calls
    return sum(e.end - e.start for e in kern) / 1e3 / calls


def labelled_ranges(ranges):
    """Context manager: wraps each (module, function, tag) of `ranges` (a
    module path inside the package, the name as that module holds it) in a
    torch.profiler record_function range named tag, and puts the functions
    back on exit."""
    import contextlib
    import importlib

    from torch.profiler import record_function

    def labelled(fn, tag):
        def wrapper(*a, **k):
            with record_function(tag):
                return fn(*a, **k)
        return wrapper

    @contextlib.contextmanager
    def patched():
        saved = []
        try:
            for mod_name, fn_name, tag in ranges:
                mod = importlib.import_module(f"orb_line_slam_tpu_torch.{mod_name}")
                saved.append((mod, fn_name, getattr(mod, fn_name)))
                setattr(mod, fn_name, labelled(getattr(mod, fn_name), tag))
            yield
        finally:
            for mod, fn_name, fn in saved:
                setattr(mod, fn_name, fn)

    return patched()


def range_device_times(prof, tags):
    """From a profile taken inside labelled_ranges: (device kernels sorted
    by start, {tag: [device us, kernels, calls]}).  A range's device time is
    the sum of the device kernels that start inside its device interval."""
    import bisect

    dev = device_records(prof)
    ranges = [e for e in dev if e.name in tags]
    kern = sorted((e for e in dev if e.name not in tags and not e.name.startswith("ProfilerStep")),
                  key=lambda e: e.start)
    starts = [e.start for e in kern]
    csum = [0.0]
    for e in kern:
        csum.append(csum[-1] + e.end - e.start)
    per = {tag: [0.0, 0, 0] for tag in tags}
    for r in ranges:
        i = bisect.bisect_left(starts, r.start)
        j = bisect.bisect_right(starts, r.end)
        per[r.name][0] += csum[j] - csum[i]
        per[r.name][1] += j - i
        per[r.name][2] += 1
    return kern, per


# The stages of build_stereo_frame a profile range is opened around.
FRAME_RANGES = (
    ("frontend.frame", "extract_orb_stereo", "extract_orb_stereo"),
    ("frontend.orb_extractor", "detect_keypoints", "detect_stage"),
    ("frontend.frame", "stereo_match", "stereo_match"),
    ("frontend.orb_extractor", "describe_keypoints", "describe_stage"),
    ("frontend.stereo", "stereo_sad", "sad_stage"),
)


def frame_stage_profile(cfg, lg, rg, ranges=FRAME_RANGES, n_frames=5):
    """Device ms and kernels per build_stereo_frame call on the card (mean
    of n_frames calls in one torch.profiler window), of the whole call
    and of each range of `ranges`.  Another tree of this repository is
    measured by the same function with that tree's package first on
    sys.path and `ranges` naming its stages."""
    import importlib

    frame_mod = importlib.import_module("orb_line_slam_tpu_torch.frontend.frame")
    tags = sorted({tag for _, _, tag in ranges})
    with labelled_ranges(ranges):
        for _ in range(2):
            frame_mod.build_stereo_frame(lg, rg, cfg)
        prof = profiled(lambda: [frame_mod.build_stereo_frame(lg, rg, cfg) for _ in range(n_frames)],
                        lambda n: n > 0, f"{n_frames} build_stereo_frame calls")
    kern, per = range_device_times(prof, tags)
    busy = sum(e.end - e.start for e in kern)
    stages = {"build_stereo_frame": {"device_ms": busy / 1e3 / n_frames, "kernels": len(kern) / n_frames}}
    for tag in tags:
        check(per[tag][2] >= n_frames and per[tag][2] % n_frames == 0,
              f"stage range {tag} was entered {per[tag][2]} times in {n_frames} frames")
        stages[tag] = {"device_ms": per[tag][0] / 1e3 / n_frames, "kernels": per[tag][1] / n_frames}
    return stages


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


def gba_capacity_problem(cam, C=512, P=65536, O=524288):
    """The global BA at the default MapConfig capacity (the size LoopCloser
    gives bundle_adjust_cg there: 512 cameras, 65,536 points, n_cams * 1024
    observations), built as phase_bench_ba builds its own: (the ten solver
    inputs, every camera free, the true translations, the true points)."""
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
    return arrs, t, pts


def phase_loop_gba_cg(cam, C=512, P=65536, O=524288):
    """bundle_adjust_cg at the default MapConfig capacity (the size
    LoopCloser gives it there: 512 cameras, 65,536 points, n_cams * 1024
    observations), single robust stage 12 + 0, 64 CG iterations, on a
    perturbed synthetic problem built as phase_bench_ba builds its own.
    The card is held to the same code on CPU tensors over the first LM
    iteration (the CPU takes ~3 s per iteration); the full solve is held
    to the truth it was perturbed from.  Returns the ms per solve and, for
    phase 15, the problem, its true points, the card's result and the
    device ms and kernels per LM iteration."""
    import torch

    from orb_line_slam_tpu_torch.backend.global_ba import bundle_adjust_cg

    arrs, t, pts_true = gba_capacity_problem(cam, C, P, O)
    t0 = arrs[1]

    def solve(d, iters1=12):
        res = bundle_adjust_cg(*(torch.from_numpy(a).to(d) for a in arrs), cam, iters1=iters1, iters2=0,
                               fix_first=True, cg_iters=64)
        return [x.cpu().numpy() for x in res]

    chi2_0 = float(solve("cuda", iters1=0)[4])
    _, t1, p1, _, chi2_1 = solve("cuda", iters1=1)
    t_s = time.perf_counter()
    _, tc, pc, _, chi2c = solve("cpu", iters1=1)
    cpu_ms = (time.perf_counter() - t_s) * 1e3
    dt, dp = float(np.abs(t1 - tc).max()), float(np.abs(p1 - pc).max())
    check(float(chi2_1) < chi2_0, f"CG global BA did not reduce chi2 in one iteration: {chi2_0:.1f} -> {float(chi2_1):.1f}")
    check(abs(float(chi2_1) - float(chi2c)) <= 0.01 * float(chi2c), f"CG global BA chi2 {float(chi2_1):.1f} vs CPU {float(chi2c):.1f}")
    check(dt < 1e-3, f"CG global BA cameras differ from the CPU's by {dt:.2e} m")
    t_s = time.perf_counter()
    res = solve("cuda")
    first_ms = (time.perf_counter() - t_s) * 1e3
    Rg, tg, pg, inl, chi2 = res
    check(np.isfinite(tg).all() and np.isfinite(pg).all(), "CG global BA: non-finite result")
    check(float(chi2) < float(chi2_1), f"CG global BA did not go on reducing chi2: {float(chi2_1):.1f} -> {float(chi2):.1f}")
    check(float(np.abs(tg - t).max()) < float(np.abs(t0 - t).max()), "CG global BA did not bring the cameras closer to truth")
    times = []
    for _ in range(2):                        # the first full solve warmed up
        t_s = time.perf_counter()
        solve("cuda")
        times.append((time.perf_counter() - t_s) * 1e3)
    ms = statistics.median(times)
    busy, n_k = device_ms(lambda: solve("cuda", iters1=2))          # 2 of the 12 LM iterations under the profiler
    # Per CG iteration the solver streams the per-observation coupling
    # blocks twice (bt_x and b_z: [O, 6, 3] float32 and the int64 index
    # of each sweep): a floor on its memory traffic.
    sweep_bytes = 2 * (O * 18 * 4 + O * 8)
    print(f"loop global BA (CG): C={C} P={P} O={O}: after 1 LM x 64 CG iterations chi2 {chi2_0:.0f} -> {float(chi2_1):.0f} "
          f"(CPU {float(chi2c):.0f}), cameras within {dt:.1e} m and points within {dp:.1e} m of the CPU's "
          f"({cpu_ms:.0f} ms on this host's CPU); after 12: chi2 {float(chi2):.0f}, worst camera error "
          f"{float(np.abs(t0 - t).max()):.4f} -> {float(np.abs(tg - t).max()):.4f} m; {ms:.1f} ms per solve, "
          f"{ms / 12:.2f} ms per LM iteration (host clock, result fetched, median of 2; {busy / 2:.1f} ms of device time in "
          f"{n_k // 2} kernels per LM iteration; first full solve {first_ms:.0f} ms); "
          f"the two observation sweeps of one CG iteration move "
          f">= {sweep_bytes / 1e6:.1f} MB, {sweep_bytes / H100_BYTES_PER_S * 1e3 * 64 * 12:.1f} ms per solve at the HBM rate")
    return ms, {"arrs": arrs, "pts_true": pts_true, "result": res, "ms": ms, "device_ms_per_lm_iteration": busy / 2,
                "kernels_per_lm_iteration": n_k // 2}


def loop_job(cfg, draw=0):
    """The render job of the loop circuit (sensor noise on).  Draw 0 is
    phase 10's; draw d numbers its sensor-noise draws from
    NOISE_DRAW_STRIDE * d: the same circuit under other noise."""
    from orb_line_slam_tpu_torch.data.synthetic import SyntheticScene, loop_circuit_trajectory

    scene = SyntheticScene(cfg.camera, **LOOP_SCENE)
    scene.noise_sigma = LOOP_NOISE_SIGMA
    scene._noise_calls = NOISE_DRAW_STRIDE * draw
    return scene, loop_circuit_trajectory(LOOP_FRAMES, radius=LOOP_RADIUS, laps=LOOP_LAPS), "stereo"


def render_loop_sequence(cfg):
    job = loop_job(cfg)
    return job[1], render_jobs([job])[0]


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
        # A steady window of the circuit (keyframes every third frame, the
        # loop closer's per-keyframe work inside), before the closure.
        slam, launches, fps, ate, per_frame = run_slice(cfg, poses, frames, "loop slice", 0.1, use_loop_closing=True,
                                                        window=ProfileWindow("loop slice", start=30))
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
    slam_off, launches_off, fps_off, ate_off, _ = run_slice(cfg, poses, frames, "loop slice, loop closing off", 0.1)
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
        "loop_frame_host_ms": per_frame,
        "closing_event_ms": {k: closure.get(k) for k in ("detect", "sim3", "correct", "essential_graph", "gba")},
    }))
    add_launches(launches, launches_off)
    return launches, fps, ate, slam


def check_ba_lag(name, lags):
    """Tracker.poll_mapping joins each deferred local BA one frame after
    its pack (a final flush in its own frame), whatever the host's speed."""
    check(max(lags, default=0) <= 1, f"{name}: deferred local BAs landed {lags} frames after their pack")


def print_ba_wait(name, tracker, n_frames):
    """The tracking thread's waits for a deferred local BA's solve
    (Tracker.ba_waits, the timing stage "ba_wait"): ms per frame over the
    run's n_frames (0 where a frame did not wait), p50 and max over those
    frames, and the p50 of the waits themselves."""
    per = np.zeros(n_frames)
    for frame, seconds in tracker.ba_waits:
        per[min(frame, n_frames - 1)] += seconds * 1e3
    waits = [seconds * 1e3 for _, seconds in tracker.ba_waits]
    row = {"waits": len(waits), "ms_per_frame": float(per.mean()), "p50_ms": float(np.percentile(per, 50)),
           "max_ms": float(per.max()), "p50_ms_of_the_waits": float(np.median(waits)) if waits else 0.0}
    print(f"{name}: the tracking thread waited for {len(waits)} deferred local BAs (ba_wait): "
          f"{row['ms_per_frame']:.3f} ms per frame over {n_frames} frames, p50 {row['p50_ms']:.3f}, max "
          f"{row['max_ms']:.3f} ms; p50 of the waits {row['p50_ms_of_the_waits']:.3f} ms")
    return row


def phase_shipping_pipeline(poses, frames, pinned_ate):
    """Phase 11 (a): bench.py::_bench_pipeline on the card: System(cfg,
    device="cuda") with bench.py's configuration over phase 5's N_FRAMES
    frames, frames/s from frame 12 on (bench.py's 12 warm-up frames).
    Its ATE is held to phase 5's pinned point-only run of the same frames
    by tests/test_loop_closure_e2e.py's inequality."""
    slam, launches, fps, ate, per_frame = run_slice(bench_pipeline_config(), poses, frames, "shipping pipeline",
                                                    0.1, use_loop_closing=True, shipping=True, warmup=12)
    bound = max(1.25 * pinned_ate, pinned_ate + 0.02)
    print(f"shipping pipeline (bench.py's full_pipeline_fps): {fps:.2f} frames/s over frames 12-{len(frames) - 1}, "
          f"ATE {ate:.5f} m (bound {bound:.5f} m from phase 5's {pinned_ate:.5f} m), "
          f"{slam.n_loops_closed} loops, map lines {int(slam.map.ln_valid.sum())}")
    check(ate <= bound, f"shipping pipeline: ATE {ate:.5f} m above {bound:.5f} m")
    check(int(slam.map.ln_valid.sum()) > 0, "shipping pipeline: lines are on, yet the map holds no line")
    check_ba_lag("shipping pipeline", slam.tracker.ba_lag_frames)
    print_ba_wait("shipping pipeline", slam.tracker, len(frames))
    return launches, fps, per_frame, ate


def phase_shipping_circuit(poses, frames, pinned_ate):
    """Phase 11 (b): phase 10's circuit under System(ccfg,
    device="cuda") defaults.  The loop must be detected on the
    loop-closing worker and corrected on the tracking thread, a global BA
    solved on the global-BA worker and applied by poll_global_ba (at a
    keyframe event or at shutdown), and the ATE stay within
    max(1.25 x, + 2 cm) of phase 10's pinned run.  Frames 30-32 are
    profiled, as phase 10's are."""
    import threading

    from orb_line_slam_tpu_torch.loop import loop_closing

    cls = loop_closing.LoopCloser
    seen = {"_compute_sim3": set(), "_correct": set(), "_solve_gba": set(), "_apply_gba": set()}
    saved = {name: getattr(cls, name) for name in seen}

    def on_thread(name, fn):
        def wrapper(self, *a, **k):
            seen[name].add(threading.current_thread().name)
            return fn(self, *a, **k)
        return wrapper

    for name, fn in saved.items():
        setattr(cls, name, on_thread(name, fn))
    try:
        # Frames 30-32 profiled as in phase 10: the pose solves' device
        # time with the workers' BAs sharing the card, beside the pinned.
        slam, launches, fps, ate, per_frame = run_slice(loop_config(), poses, frames, "shipping circuit", 0.1,
                                                        use_loop_closing=True, shipping=True,
                                                        window=ProfileWindow("shipping circuit", start=30))
    finally:
        for name, fn in saved.items():
            setattr(cls, name, fn)
    lc = slam.loop_closer
    bound = max(1.25 * pinned_ate, pinned_ate + 0.02)
    print(f"shipping circuit: {slam.n_loops_closed} loop(s) closed at keyframe(s) {[c['kf'] for c in lc.closure_ms]}, "
          f"{lc.n_gba_applied} global BA applied ({lc.last_gba_solver}; {lc.n_gba_superseded} superseded), "
          f"{int(slam.map.n_keyframes())} keyframes, {fps:.2f} frames/s (frames {WARMUP_FRAMES}-{len(frames) - 1}), "
          f"ATE {ate:.5f} m (bound {bound:.5f} m from phase 10's pinned {pinned_ate:.5f} m); threads: "
          + json.dumps({k: sorted(v) for k, v in seen.items()}))
    print("shipping circuit loop closer stages: " + json.dumps(lc.timing.table()) + "; closures "
          + json.dumps(lc.closure_ms))
    check(slam.n_loops_closed >= 1 and lc.async_detect, "shipping circuit: no loop closed")
    check(seen["_compute_sim3"] == {"loop-closing_0"} and seen["_correct"] == {"MainThread"},
          f"shipping circuit: the loop was not detected on the worker and corrected on the tracking thread: {seen}")
    check(lc.gba_async and lc.n_gba_applied >= 1 and seen["_solve_gba"] == {"global-ba_0"}
          and seen["_apply_gba"] == {"MainThread"},
          f"shipping circuit: no global BA solved on its worker and applied by poll_global_ba: {seen}")
    check(ate <= bound, f"shipping circuit: ATE {ate:.5f} m above {bound:.5f} m")
    check_ba_lag("shipping circuit", slam.tracker.ba_lag_frames)
    print_ba_wait("shipping circuit", slam.tracker, len(frames))
    return launches, fps, per_frame, ate, slam.n_loops_closed


def phase_mono_slice(cfg, poses, frames):
    """Phase 12: System.track_monocular on the card, pinned, over 40
    TUM-size frames: state OK, initialised at the JAX package's frame,
    >= 3 keyframes, >= 1 local BA, > 80 map points, one orb_describe per
    frame and nothing else, and the similarity-aligned ATE no more than
    10% + 1 cm above the JAX package's.  Frames/s and per-frame host ms
    over the frames after initialization."""
    slam, launches, fps, ate, per_frame = run_slice(cfg, poses, frames, "mono slice", TUM_DT, warmup=None,
                                                    sensor="mono")
    traj = slam.tracker.final_trajectory()
    init = next(i for i, e in enumerate(traj) if not e[4])
    n_pts = int(slam.map.pt_valid.sum())
    n_tracked = sum(not e[4] for e in traj)
    print(f"mono slice: initialised at frame {init} (JAX CPU: {JAX_CPU_MONO_INIT_FRAME}), {n_tracked} frames tracked, "
          f"{n_pts} map points, {fps:.2f} frames/s over frames {init + 1}-{len(frames) - 1}, per-frame host ms p50 "
          f"{per_frame['p50']:.1f} p90 {per_frame['p90']:.1f} max {per_frame['max']:.1f}, ATE {ate:.5f} m "
          f"(similarity-aligned; JAX CPU reference {JAX_CPU_REFERENCE_ATE_MONO_M:.5f} m)")
    check(slam.tracker.is_mono, "mono slice: the tracker is not monocular")
    check(init == JAX_CPU_MONO_INIT_FRAME, f"mono slice: initialised at frame {init}, the JAX package at "
                                           f"{JAX_CPU_MONO_INIT_FRAME}")
    check(n_pts > 80, f"mono slice: only {n_pts} map points")
    check_ate("mono slice", ate, JAX_CPU_REFERENCE_ATE_MONO_M)
    return launches, fps, per_frame, ate


def phase_rgbd_slice(cfg, poses, frames):
    """Phase 13: System.track_rgbd on the card, pinned, over 40 TUM-size
    frames of a room: state OK, >= 3 keyframes, >= 1 local BA, one
    orb_describe per frame and nothing else, ATE no more than 10% + 1 cm
    above the JAX package's."""
    slam, launches, fps, ate, per_frame = run_slice(cfg, poses, frames, "rgbd slice", TUM_DT, sensor="rgbd")
    print(f"rgbd slice: {fps:.2f} frames/s over frames {WARMUP_FRAMES}-{len(frames) - 1}, per-frame host ms p50 "
          f"{per_frame['p50']:.1f} p90 {per_frame['p90']:.1f} max {per_frame['max']:.1f}, "
          f"{int(slam.map.pt_valid.sum())} map points, ATE {ate:.5f} m (JAX CPU reference "
          f"{JAX_CPU_REFERENCE_ATE_RGBD_M:.5f} m)")
    check(not slam.tracker.is_mono, "rgbd slice: the tracker is monocular")
    check_ate("rgbd slice", ate, JAX_CPU_REFERENCE_ATE_RGBD_M)
    return launches, fps, per_frame, ate


def mono_loop_runs(cfg, poses, frames, draw, end_tracked=True):
    """One sensor-noise draw of the loop circuit's left images through
    track_monocular on the card, pinned, with loop closing on and then
    off, each under a TrackStepLog (the run with loop closing keeps every
    MONO_REPLAY_EVERY-th tracking step and its first MONO_REPLAY_FAILED
    failed ones for replay on the CPU).  Holds what no draw may break:

    - the loop closer estimates the scale (fix_scale False); it closes at
      least the JAX package's loops, each with s != 1 and a global BA;
    - the tracker initialises at the JAX package's frame, and every frame
      after it is at least one tracking step;
    - the two runs are the same, step by step (inliers, state, the pose
      bit for bit, the keyframe count), until the first failed tracking
      step or the first closure: a loop closer that has closed nothing
      does not change tracking; a first failed step fails in both runs
      (from there on the run with loop closing relocalizes only from its
      keyframe database's candidates, the other from its five newest
      keyframes: ROADMAP Queue 3);
    - each kept step gives on the CPU, from the card's inputs, the card's
      outcome (tracked or not, inliers within 2) and, where it tracked,
      its pose under the pose contract (1e-3 rad, 5e-3 map units).

    end_tracked=False lets the run with loop closing end LOST.  Returns
    the runs' numbers (the ATEs over each run's tracked frames and over
    the frames both tracked) and the launches of both runs."""
    import torch

    from orb_line_slam_tpu_torch.eval.trajectory import ate_rmse
    from orb_line_slam_tpu_torch.loop import loop_closing

    name = f"mono loop slice, draw {draw}"
    jax_on, jax_off = JAX_CPU_MONO_LOOP[draw]["on"], JAX_CPU_MONO_LOOP[draw]["off"]
    lefts = [left for left, _ in frames]
    closures = []
    correct = loop_closing.LoopCloser._correct
    log_on = TrackStepLog(every=MONO_REPLAY_EVERY, keep_failed=MONO_REPLAY_FAILED)

    def recorded_correct(self, kf_id, cand, sim, run_gba=True):
        closures.append({"frame": log_on.frame, "kf": int(kf_id), "cand": int(cand), "s": float(sim[0]),
                         "fix_scale": bool(self.fix_scale)})
        correct(self, kf_id, cand, sim, run_gba)

    loop_closing.LoopCloser._correct = recorded_correct
    try:
        with log_on:
            slam, launches, fps, _, per_frame = run_slice(cfg, poses, lefts, name, 0.1, use_loop_closing=True,
                                                          warmup=None, sensor="mono", end_tracked=end_tracked)
    finally:
        loop_closing.LoopCloser._correct = correct
    sites = slam.pose_solve_sites
    with TrackStepLog() as log_off:
        slam_off, launches_off, fps_off, _, _ = run_slice(cfg, poses, lefts, name + ", loop closing off", 0.1,
                                                          warmup=None, sensor="mono", end_tracked=False)
    t0 = time.perf_counter()
    with torch.inference_mode():
        replays = log_on.replay()
    replay_s = time.perf_counter() - t0
    gt = np.stack([-R.T @ t for (R, t) in poses])
    runs = {}
    for tag, s_ in (("on", slam), ("off", slam_off)):
        traj = s_.tracker.final_trajectory()
        runs[tag] = (np.stack([-R.T @ t for (_, _, R, t, _) in traj]), np.array([not e[4] for e in traj]))
    (est, tracked), (est_off, tracked_off) = runs["on"], runs["off"]
    both = tracked & tracked_off
    ate = float(ate_rmse(est[tracked], gt[tracked], align=True, with_scale=True))
    ate_off = float(ate_rmse(est_off[tracked_off], gt[tracked_off], align=True, with_scale=True))
    ate_both = float(ate_rmse(est[both], gt[both], align=True, with_scale=True))
    ate_off_both = float(ate_rmse(est_off[both], gt[both], align=True, with_scale=True))
    init = int(np.argmax(tracked))
    fail = next((st[0] for st in log_on.steps if not st[1]), None)
    stop = min([f for f in (fail, closures[0]["frame"] if closures else None) if f is not None], default=len(frames))
    before = [[st for st in log.steps if st[0] < stop] for log in (log_on, log_off)]
    same = len(before[0]) == len(before[1]) and all(
        a[:4] == b[:4] and np.array_equal(a[4], b[4]) and np.array_equal(a[5], b[5]) and a[6] == b[6]
        for a, b in zip(*before))
    fail_off = next((st[1] for st in log_off.steps if st[0] == fail), None) if fail == stop else None
    lc = slam.loop_closer
    scales = [c["s"] for c in closures]
    print(f"{name}: initialised at frame {init} (JAX CPU: {jax_on[0]}), {slam.n_loops_closed} loop(s) closed (JAX CPU: "
          f"{jax_on[3]}) at frame(s) {[c['frame'] for c in closures]}, keyframe(s) {[c['kf'] for c in closures]} to "
          f"{[c['cand'] for c in closures]}, estimated scale(s) {scales}, {lc.n_gba_applied} global BA "
          f"({lc.last_gba_solver}), {int(slam.map.n_keyframes())} keyframes; frames tracked {int(tracked.sum())} with "
          f"loop closing and {int(tracked_off.sum())} without (JAX CPU {jax_on[1]} and {jax_off[1]}); the runs are "
          f"the same step by step up to frame {stop} ({'a failed step' if stop == fail else 'a closure' if closures else 'the end'}"
          f"{f', which failed with loop closing off too' if fail_off is False else ''}); ATE {ate:.5f} m over the "
          f"tracked frames ({ate_off:.5f} m without loop closing; JAX CPU {jax_on[2]:.5f} and {jax_off[2]:.5f} m), "
          f"{ate_both:.5f} and {ate_off_both:.5f} m over the {int(both.sum())} frames both tracked; "
          f"{fps:.2f} frames/s over frames {init + 1}-{len(frames) - 1} ({fps_off:.2f} without); "
          f"{launches['pose_solve']} pose-solve launches for {sites['track_steps']} tracking steps and "
          f"{sites['assoc_solves']} solves from associations")
    print(f"{name}: relocalizations with loop closing (first 8 of {len(log_on.relocs)}): "
          f"{json.dumps(log_on.relocs[:8])}; without (first 8 of {len(log_off.relocs)}): {json.dumps(log_off.relocs[:8])}")
    print(f"{name}: {len(replays)} tracking steps replayed on the CPU from the card's inputs in {replay_s:.1f} s "
          "(frame, card (tracked, inliers), CPU (tracked, inliers), rad, map units): " + json.dumps(replays))
    print(f"{name} loop closer stages: " + json.dumps(lc.timing.table()) + "; closures " + json.dumps(lc.closure_ms))
    check(slam.tracker.is_mono and lc is not None and not lc.fix_scale,
          f"{name}: the loop closer of a monocular System does not estimate the scale")
    check(slam.n_loops_closed >= jax_on[3] and len(closures) == slam.n_loops_closed,
          f"{name}: {slam.n_loops_closed} loops closed, the JAX package {jax_on[3]}")
    check(all(not c["fix_scale"] and c["s"] != 1.0 for c in closures) and [float(e.s) for e in lc.loop_edges] == scales,
          f"{name}: a loop closed without a free scale: {closures}")
    check(lc.n_gba_applied >= min(len(closures), 1), f"{name}: a loop closed, yet no global BA was applied")
    check(init == jax_on[0], f"{name}: initialised at frame {init}, the JAX package at {jax_on[0]}")
    check(sites["track_steps"] >= len(frames) - init - 1,
          f"{name}: {sites['track_steps']} tracking steps, want one per frame after frame {init}")
    check(slam_off.n_loops_closed == 0 and slam_off.loop_closer is None, f"{name}: loop closing off, yet a loop closed")
    check(same and len(before[0]) > 0, f"{name}: with loop closing on and off the runs part before frame {stop}, "
                                       "the first failed step or closure")
    check(fail != stop or fail_off is False,
          f"{name}: the tracking step of frame {fail} failed with loop closing on and not off")
    off_card = [r for r in replays if r[1][0] != r[2][0] or abs(r[1][1] - r[2][1]) > 2
                or (r[1][0] and (r[3] > 1e-3 or r[4] > 5e-3))]
    check(replays and not off_card, f"{name}: tracking steps whose CPU replay disagrees with the card: {off_card}")
    add_launches(launches, launches_off)
    return launches, {
        "draw": draw, "fps": fps, "fps_off": fps_off, "per_frame": per_frame, "init": init,
        "tracked": int(tracked.sum()), "tracked_off": int(tracked_off.sum()), "tracked_both": int(both.sum()),
        "ate": ate, "ate_off": ate_off, "ate_both": ate_both, "ate_off_both": ate_off_both,
        "loops": slam.n_loops_closed, "scales": scales, "same_until_frame": stop,
        "first_failed_step": fail, "n_replayed": len(replays), "replay_s": replay_s,
        "closing_event_ms": [{k: c.get(k) for k in ("kf", "detect", "sim3", "correct", "essential_graph", "gba")}
                             for c in lc.closure_ms],
    }


def phase_mono_loop_circuit(cfg, poses, frames, closing_frames):
    """Phase 17 (a) and (b): mono_loop_runs on draw 0 (phase 10's frames)
    and on draw MONO_LOOP_CLOSING_DRAW.

    (a) Draw 0, where the JAX package closes no loop and tracks all 168
    frames after its initialisation: the frames tracked with loop closing
    are no fewer than the fewest the JAX package tracks with loop closing
    over draws 0-8, and the ATE over them no more than 10% + 1 cm above
    the largest it reaches there.  Which frames a monocular run loses on
    this circuit is a float draw in either package; mono_loop_runs holds
    what does not depend on it.

    (b) The closing draw, where the JAX package closes one loop and loses
    no frame: the port closes at least one, loses no frame after its
    initialisation with loop closing (the JAX package's count, no margin)
    nor more than with it off, and its ATE is no more than 10% + 1 cm
    above the JAX package's and below the run without loop closing over
    the frames both runs tracked."""
    launches, a = mono_loop_runs(cfg, poses, frames, 0)
    n, b = mono_loop_runs(cfg, poses, closing_frames, MONO_LOOP_CLOSING_DRAW)
    add_launches(launches, n)
    least = min(v["on"][1] for v in JAX_CPU_MONO_LOOP.values())
    worst = max(v["on"][2] for v in JAX_CPU_MONO_LOOP.values())
    check(a["tracked"] >= least, f"mono loop slice, draw 0: {a['tracked']} frames tracked, fewer than the {least} the "
                                 "JAX package tracks on its worst draw")
    check_ate("mono loop slice, draw 0", a["ate"], worst)
    jax = JAX_CPU_MONO_LOOP[MONO_LOOP_CLOSING_DRAW]["on"]
    name = f"mono loop slice, draw {MONO_LOOP_CLOSING_DRAW}"
    check(b["loops"] >= 1, f"{name}: no loop closed (the JAX package closes {jax[3]})")
    check(b["tracked"] >= jax[1] and b["tracked"] >= b["tracked_off"],
          f"{name}: {b['tracked']} frames tracked with loop closing, {b['tracked_off']} without, the JAX package {jax[1]}")
    check_ate(name, b["ate"], jax[2])
    check(b["ate_both"] < b["ate_off_both"], f"{name}: ATE {b['ate_both']:.5f} m with loop closing is not below "
                                             f"{b['ate_off_both']:.5f} m without, over the frames both tracked")
    print(f"mono loop slice: draw 0 tracks {a['tracked']} frames with loop closing (JAX CPU's fewest over draws 0-8 "
          f"{least}), ATE {a['ate']:.5f} m (its largest {worst:.5f} m); draw {MONO_LOOP_CLOSING_DRAW} closes "
          f"{b['loops']} loop(s) with scale(s) {b['scales']}, tracks {b['tracked']} frames (JAX CPU {jax[1]}), ATE "
          f"{b['ate']:.5f} m (JAX CPU {jax[2]:.5f} m; {b['ate_off_both']:.5f} m without loop closing)")
    return launches, {
        "mono_loop_pipeline_fps": b["fps"], "ate_rmse_mono_loop_m": b["ate"], "ate_mono_loops": b["loops"],
        "mono_loop_scale": b["scales"], "mono_loop_tracked_frames": {d["draw"]: [d["tracked"], d["tracked_off"]]
                                                                     for d in (a, b)},
        "mono_loop_draws": {d["draw"]: d for d in (a, b)},
    }


def scale_drifted_mono_map():
    """tests/test_torch_loop_closer.py::build_drifted_map(scale_drift=
    FIXTURE_SCALE_DRIFT, mono=True) in the port's MapStore (the test
    holds the two equal): 12 keyframes out along z and back over one set
    of places, the return leg drifting up to (1.5, 0.4, 0.8) m and
    growing in scale to 1 + FIXTURE_SCALE_DRIFT, each keyframe
    re-observing 100 of the previous one's landmarks, the observations
    monocular.  Returns (config, store, the true translations)."""
    from types import SimpleNamespace

    from orb_line_slam_tpu_torch.config import CameraIntrinsics, MapConfig, OrbConfig, SlamConfig
    from orb_line_slam_tpu_torch.slam_map.map_store import MapStore

    cam = CameraIntrinsics(fx=400.0, fy=400.0, cx=320.0, cy=160.0, bf=160.0, width=640, height=320)
    F, n_kf, n_own = 256, 12, 156
    cfg = SlamConfig(camera=cam, orb=OrbConfig(n_features=F, n_levels=4),
                     map=MapConfig(max_keyframes=32, max_points=4096, max_lines=64, local_window=6, local_points=2048))
    store = MapStore(cfg.map, F)
    rng = np.random.default_rng(33)
    n_shared = F - n_own
    drift = np.array([1.5, 0.4, 0.8], np.float32)
    place_desc = {k: rng.integers(0, 256, (F, 32), dtype=np.uint8) for k in range(9)}
    pts_cam = np.stack([rng.uniform(-4, 4, F), rng.uniform(-2, 2, F), rng.uniform(5, 25, F)], -1).astype(np.float32)
    u = cam.fx * pts_cam[:, 0] / pts_cam[:, 2] + cam.cx
    v = cam.fy * pts_cam[:, 1] / pts_cam[:, 2] + cam.cy
    true_t, prev_ids, prev_place = [], None, None
    scale_offset = np.zeros(3, np.float32)
    for k in range(n_kf):
        place = k if k < 9 else 11 - k
        t_true = np.array([0.0, 0.0, 1.0 * place], np.float32)
        frac = max(0, (k - 6) / (n_kf - 7))
        sc = np.float32(1.0 + FIXTURE_SCALE_DRIFT * frac)
        if k:
            scale_offset = scale_offset + (sc - 1) * (t_true - true_t[-1])
        true_t.append(t_true)
        t_est = t_true + drift * frac + scale_offset
        R = np.eye(3, dtype=np.float32)
        descs = place_desc[place].copy()
        if prev_place is not None:
            descs[n_own:] = place_desc[prev_place][:n_shared]
        frame = SimpleNamespace(xy=np.stack([u, v], -1).astype(np.float32), u_right=np.full(F, -1.0, np.float32),
                                depth=np.full(F, -1.0, np.float32), octave=np.zeros(F, np.int32),
                                angle=np.zeros(F, np.float32), desc=descs, valid=np.ones(F, bool))
        kf = store.add_keyframe(frame, R, t_est, frame_id=k, timestamp=k * 0.1)
        ids = store.add_points(pts_cam[:n_own] * sc - t_est, descs[:n_own], np.zeros(n_own, np.int32), kf,
                               np.arange(n_own))
        if prev_ids is not None:
            store.kf_obs_lm[kf, n_own:] = prev_ids[:n_shared]
            p_cam = store.pt_pos[prev_ids[:n_shared]] @ R.T + t_est
            store.kf_xy[kf, n_own:] = np.stack([cam.fx * p_cam[:, 0] / p_cam[:, 2] + cam.cx,
                                                cam.fy * p_cam[:, 1] / p_cam[:, 2] + cam.cy], -1)
        prev_ids, prev_place = ids, place
    return cfg, store, np.stack(true_t)


def fixture_gap(kf_R, kf_t, true_t, kf, cand):
    """Error (m) of the closing keyframe's centre seen from the loop
    keyframe's camera in scale_drifted_mono_map (no camera rotates)."""
    est = kf_R[cand] @ (-kf_R[kf].T @ kf_t[kf]) + kf_t[cand]
    return float(np.linalg.norm(est - (true_t[cand] - true_t[kf])))


def close_fixture(device, fix_scale):
    """The port's LoopCloser on `device` over scale_drifted_mono_map():
    the keyframes in order, then the global BA.  Returns the closer, the
    closing keyframe, each stage's (kf_R, kf_t, pt_pos, pt_valid) and the gap
    across the loop at each stage, and the host ms of the closure."""
    import torch

    from orb_line_slam_tpu_torch.loop.loop_closing import LoopCloser
    from orb_line_slam_tpu_torch.loop.vocabulary import Vocabulary

    cfg, store, true_t = scale_drifted_mono_map()
    voc = Vocabulary.train(store.kf_desc[store.kf_valid].reshape(-1, 32)[:8000], k=8, depth=3)
    lc = LoopCloser(cfg, store, voc, device=device)
    lc.fix_scale = fix_scale
    stages = {}

    def record(tag):
        stages[tag] = (store.kf_R.copy(), store.kf_t.copy(), store.pt_pos.copy(), store.pt_valid.copy())

    graph = lc._optimize_essential_graph

    def recorded_graph(*a, **k):
        record("rewrite_and_fuse")
        graph(*a, **k)
        record("essential_graph")

    lc._optimize_essential_graph = recorded_graph
    record("before")
    t0 = time.perf_counter()
    closed = None
    for k in range(store._next_kf):
        if lc.process_keyframe(k, run_gba=False):
            closed = lc.last_closed_kf
    if closed is None and lc.flush(run_gba=False):
        closed = lc.last_closed_kf
    if closed is not None:
        lc.run_global_ba()
        record("global_ba")
    if device != "cpu":
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    gaps = {}
    if closed is not None:
        edge = lc.loop_edges[0]
        for tag, (R, t, _, _) in stages.items():
            gaps[tag] = fixture_gap(R, t, true_t, edge.kf_a, edge.kf_b)
    return lc, closed, stages, gaps, ms


def phase_mono_loop_fixture():
    """Phase 17 (c): the free-scale closure of a scale-drifted monocular
    map on the card (tests/test_torch_mono_loop.py's fixture), held to the
    same closure on CPU tensors: both close at keyframe 11 with one Sim3
    (scale within 1e-4 of each other and within 5e-3 of the imposed 1.1),
    the group rewrite and fuse and the essential graph agree under the
    pose contract, the gap across the loop shrinks from > 1.5 m to < 0.1 m
    and stays < 0.2 m after the global BA on the mono observations, and
    the same map closed with a fixed scale on the card keeps a gap at
    least five times larger."""
    gpu, closed, stages, gaps, ms = close_fixture("cuda", fix_scale=False)
    cpu, closed_cpu, stages_cpu, _, ms_cpu = close_fixture("cpu", fix_scale=False)
    _, closed_fix, _, gaps_fix, _ = close_fixture("cuda", fix_scale=True)
    check(closed == closed_cpu == 11 and closed_fix == 11,
          f"mono loop fixture: closed at keyframe {closed} on the card, {closed_cpu} on the CPU, {closed_fix} with a "
          "fixed scale; want 11")
    eg, ec = gpu.loop_edges[0], cpu.loop_edges[0]
    scale = float(eg.s)
    check(not gpu.fix_scale and (eg.kf_a, eg.kf_b) == (ec.kf_a, ec.kf_b) and abs(scale - float(ec.s)) < 1e-4
          and abs(scale - (1 + FIXTURE_SCALE_DRIFT)) < 5e-3,
          f"mono loop fixture: Sim3 scale {scale} on the card, {float(ec.s)} on the CPU, imposed "
          f"{1 + FIXTURE_SCALE_DRIFT}")
    check(gpu.n_gba_applied == 1, "mono loop fixture: no global BA applied")
    agree = {}
    for tag in ("before", "rewrite_and_fuse", "essential_graph"):
        (Rg, tg, pg, vg), (Rc, tc, pc, vc) = stages[tag], stages_cpu[tag]
        check(np.array_equal(vg, vc), f"mono loop fixture: the card and the CPU keep other landmarks after {tag}")
        n = 12
        cg = -np.einsum("kji,kj->ki", Rg[:n], tg[:n])
        cc = -np.einsum("kji,kj->ki", Rc[:n], tc[:n])
        agree[tag] = {"rot": rotation_gap(Rg[:n], Rc[:n]),
                      "kf_m": float(np.linalg.norm(cg - cc, axis=1).max()),
                      "pts_median_m": float(np.median(np.linalg.norm(pg[vg] - pc[vc], axis=1)))}
        check(agree[tag]["rot"] < 1e-3 and agree[tag]["kf_m"] < 5e-3 and agree[tag]["pts_median_m"] < 5e-3,
              f"mono loop fixture: the card's map after {tag} is not the CPU's: {agree[tag]}")
    _, tg, pg, vg = stages["global_ba"]
    check(np.isfinite(tg).all() and np.isfinite(pg[vg]).all(), "mono loop fixture: the global BA left a non-finite map")
    check(gaps["before"] > 1.5 and gaps["rewrite_and_fuse"] < 0.1 and gaps["essential_graph"] < 0.1
          and gaps["global_ba"] < 0.2, f"mono loop fixture: gaps across the loop {gaps}")
    check(gaps_fix["essential_graph"] > 5 * gaps["essential_graph"],
          f"mono loop fixture: a fixed scale leaves {gaps_fix['essential_graph']:.4f} m, the free scale "
          f"{gaps['essential_graph']:.4f} m")
    print(f"mono loop fixture: closed at keyframe {closed} to {eg.kf_b} with scale {scale:.6f} on the card "
          f"({float(ec.s):.6f} on the CPU; imposed {1 + FIXTURE_SCALE_DRIFT}), gaps across the loop (m) "
          f"{json.dumps(gaps)} (fixed scale {json.dumps(gaps_fix)}), card against CPU {json.dumps(agree)}; "
          f"the closure took {ms:.1f} host ms on the card ({ms_cpu:.1f} on the CPU)")
    return {"mono_fixture_scale": scale, "mono_fixture_gap_m": gaps, "mono_fixture_fixed_scale_gap_m": gaps_fix,
            "mono_fixture_card_vs_cpu": agree, "mono_fixture_closure_ms": ms}


def phase_mono_loop(cfg, poses, frames, closing_frames):
    """Phase 17: (a, b) the monocular circuit under two sensor-noise draws,
    (c) the scale-drifted fixture."""
    launches, out = phase_mono_loop_circuit(cfg, poses, frames, closing_frames)
    out.update(phase_mono_loop_fixture())
    print_card()        # beside phase 17's numbers
    print(json.dumps(out))
    return launches, out


def mono_loop_draws(draws):
    """chip_smoke.py --mono-loop-draws D,D,...: mono_loop_runs on the loop
    circuit's left images under each sensor-noise draw, on the card (the
    runs may end LOST); prints per draw and loop closing on / off the
    frames tracked, the ATE over them, the loops and the first failed
    tracking step, beside the JAX package's from JAX_CPU_MONO_LOOP."""
    import torch

    ccfg = loop_config()
    jobs = [loop_job(ccfg, d) for d in draws]
    check(threading.active_count() == 1, "a thread runs before the render workers are forked")
    rendered = render_jobs(jobs, min(8, os.cpu_count() or 1))
    phase_device()
    import orb_line_slam_tpu_torch  # noqa: F401  (sets the fp32 policy)

    phase_build()
    rows = {}
    for d, (_, poses, _), frames in zip(draws, jobs, rendered):
        _, r = mono_loop_runs(ccfg, poses, frames, d, end_tracked=False)
        rows[d] = {"on": [r["tracked"], r["ate"], r["loops"]], "off": [r["tracked_off"], r["ate_off"]],
                   "first_failed_step": r["first_failed_step"], "same_until_frame": r["same_until_frame"],
                   "scales": r["scales"],
                   "jax_on": list(JAX_CPU_MONO_LOOP[d]["on"][1:]), "jax_off": list(JAX_CPU_MONO_LOOP[d]["off"][1:3])}
        print(f"mono loop draw {d}: " + json.dumps(rows[d]))
    print_card()
    print("mono loop draws: " + json.dumps(rows))


PROFILE_START, PROFILE_FRAMES = 33, 3
def run_multiseq(cfg, seqs, name, check_steps=(), keep_step=None):
    """Drive MultiSequenceTracker(cfg, B) on the System's defaults on the
    card over B sequences of equal length (seqs: B lists of (left, right)
    pairs), one process_stereo per time step, with every kernel's count
    set to 0 just before each step and read just after: a batched step
    must launch exactly one orb_describe, one stereo_sad and one detection
    call's orb_detect kernels, a per-sequence step (bootstrap, or line
    mirrors of different capacities) those of each per sequence; three pose solves per tracking
    step (a batched step's vmapped one is one launch each for all B) and
    one per solve from associations.  On the batched steps numbered
    in `check_steps` (from 0) each sequence's batched TrackOut is held to
    an unbatched track_step on the same tensors: poses within 1e-4 rad and
    1e-4 m, assoc_gid equal on >= 99% of rows.  The inputs of batched step
    `keep_step` are kept, so that it can be profiled alone afterwards.
    Returns (tracker, launches, per-step host ms, per-step batched flags,
    kept inputs or None)."""
    import torch

    from orb_line_slam_tpu_torch.backend import pose_opt
    from orb_line_slam_tpu_torch.parallel import multi_sequence
    from orb_line_slam_tpu_torch.parallel.multi_sequence import MultiSequenceTracker, _take
    from orb_line_slam_tpu_torch.pipeline.track_step import track_step

    n_seq = len(seqs)
    batched_fn = multi_sequence.batched_frame_track
    state = {"step": 0, "kept": None, "checked": 0}

    def recorded(left, right, stacked, cfg_, has_lines):
        frames, lfs, outs = batched_fn(left, right, stacked, cfg_, has_lines)
        step = state["step"]
        state["step"] += 1
        if step == keep_step:
            state["kept"] = (left, right, stacked, has_lines)
        if step in check_steps:
            # The unbatched comparison's pose solves are not the path's.
            path_launches = pose_opt.launches
            last_frame, mir, *rest = stacked
            carry, table = rest[:15], rest[15:]
            for b in range(n_seq):
                want = track_step(_take(frames, b), _take(last_frame, b), _take(mir, b), *(x[b] for x in carry),
                                  _take(lfs, b) if has_lines else None, *(x[b] for x in table),
                                  cfg=cfg_, has_lines=has_lines)
                got = _take(outs, b)
                d_rot = float(_rot_angle(got.R.cpu().numpy(), want.R.cpu().numpy()))
                d_t = float((got.t - want.t).abs().max())
                same = float((got.assoc_gid == want.assoc_gid).float().mean())
                print(f"{name}: batched step {step}, sequence {b}: batched vs unbatched track_step on the same "
                      f"tensors: rotation {d_rot:.2e} rad, translation {d_t:.2e} m, assoc_gid equal on {same:.4f} "
                      f"of rows, inliers {int(got.n_inliers)} / {int(want.n_inliers)}, has_lines {has_lines}")
                check(d_rot <= 1e-4 and d_t <= 1e-4 and same >= 0.99,
                      f"{name}: sequence {b}'s batched step {step} disagrees with the unbatched track_step")
            pose_opt.launches = path_launches
            state["checked"] += 1
        return frames, lfs, outs

    mst = MultiSequenceTracker(cfg, n_seq, device="cuda")
    check(mst.systems is not None and all(s.async_loop and s.gba_async and s.tracker.async_mapping
                                          for s in mst.systems), f"{name}: not the System's default schedule")
    stream = torch.cuda.current_stream()
    launches, frame_ms, batched = {}, [], []
    multi_sequence.batched_frame_track = recorded
    # functorch warns when an operator has no batching rule and it loops
    # over the batch instead (B times the launches): any such warning fails.
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    pose_per_step = []
    try:
        with warnings.catch_warnings(record=True) as seen, PoseSolveSites() as sites:
            warnings.simplefilter("always")
            for i in range(len(seqs[0])):
                ready = mst._ready()
                reset_launches()
                sites.reset()
                t0 = time.perf_counter()
                mst.process_stereo([s[i][0] for s in seqs], [s[i][1] for s in seqs], [0.1 * i] * n_seq)
                stream.synchronize()
                frame_ms.append((time.perf_counter() - t0) * 1e3)
                n = read_launches()
                was_batched = mst.n_batched_frames == sum(batched) + 1
                batched.append(was_batched)
                per = 1 if was_batched else n_seq
                check(n == {"patch_tiles": 0, "orb_describe": per, "stereo_sad": per, "pose_solve": sites.expected(),
                            "orb_detect": detect_launches(per)}
                      and (not was_batched or sites.counts["track_steps"] >= 1),
                      f"{name}: step {i} ({'batched' if was_batched else 'per sequence'}, ready {ready}) "
                      f"launched {n}, {sites.counts}")
                pose_per_step.append(n["pose_solve"])
                add_launches(launches, n)
            mst.shutdown()
    finally:
        multi_sequence.batched_frame_track = batched_fn
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    torch.cuda.synchronize()
    fallbacks = sorted({str(w.message)[:160] for w in seen if "batching rule" in str(w.message)})
    check(not fallbacks, f"{name}: torch.func.vmap fell back to a per-sample loop: {fallbacks}")
    check(state["checked"] == len(check_steps), f"{name}: only {state['checked']} of the batched steps "
          f"{list(check_steps)} ran ({mst.n_batched_frames} batched)")
    batched_pose = sorted({k for k, was in zip(pose_per_step, batched) if was})
    print(f"{name}: {len(frame_ms)} steps of {n_seq} sequences, {mst.n_batched_frames} batched, "
          f"{mst.n_bootstrap_frames} per sequence while bootstrapping, {mst.n_mixed_line_frames} per sequence for "
          f"line mirrors of different capacities; kernel launches {json.dumps(launches)}; pose-solve launches per "
          f"batched step {batched_pose} (per step: {pose_per_step}); "
          f"{mst.n_loops_closed} loops; stages " + json.dumps(mst.timing.table(len(frame_ms))))
    return mst, launches, frame_ms, batched, state["kept"]


def aggregate_fps(n_seq, frame_ms, batched):
    """multiseq_aggregate_fps of a run: B x batched steps / their seconds
    in each of three consecutive windows of the batched steps, and the host
    ms per batched step.  Returns (median window, the three sorted, {p50,
    p90, max})."""
    steps = np.asarray([ms for ms, was in zip(frame_ms, batched) if was])
    check(len(steps) >= 6, f"only {len(steps)} batched steps")
    fps = sorted(n_seq * len(w) / (w.sum() / 1e3) for w in np.array_split(steps, 3))
    host = {"p50": float(np.percentile(steps, 50)), "p90": float(np.percentile(steps, 90)), "max": float(steps.max())}
    return fps[1], fps, host


def print_aggregate(name, n_seq, frame_ms, batched):
    agg, fps, host = aggregate_fps(n_seq, frame_ms, batched)
    print(f"{name}: multiseq_aggregate_fps {agg:.3f} (windows {', '.join(f'{f:.3f}' for f in fps)}) over "
          f"{sum(batched)} batched steps; host ms per batched step p50 {host['p50']:.1f}, p90 {host['p90']:.1f}, "
          f"max {host['max']:.1f}")
    return {"multiseq_aggregate_fps": agg, "windows_fps": fps, "batched_steps": int(sum(batched)),
            "batched_step_host_ms": host}


def sequence_ate(tracker, poses):
    from orb_line_slam_tpu_torch.eval.trajectory import ate_rmse

    traj = tracker.final_trajectory()
    est = np.stack([-R.T @ t for (_, _, R, t, _) in traj])
    gt = np.stack([-R.T @ t for (R, t) in poses])
    check(np.isfinite(est).all() and est.shape == gt.shape, f"trajectory not finite / wrong shape {est.shape}")
    return float(ate_rmse(est, gt, align=True))


def phase_multiseq_correctness(poses, frames, pipeline_ate):
    """Phase 14 (a): MultiSequenceTracker(bench_pipeline_config(), 2) on
    the System's defaults: sequence 0 is phase 5's frames, sequence 1 the
    same frames in reverse order.  Three steady batched steps are held to
    the unbatched track_step; at least half the steps run batched; each
    sequence's ATE is within max(1.25 x, + 2 cm) of phase 11 (a)'s
    (tests/test_loop_closure_e2e.py's inequality).  Its steps are also
    the scaling run's B = 2 point.  The first MULTISEQ_PAIR_FRAMES frames
    of each direction."""
    n = MULTISEQ_PAIR_FRAMES
    seqs = [frames[:n], frames[::-1][:n]]
    gts = [poses[:n], poses[::-1][:n]]
    mst, launches, frame_ms, batched, _ = run_multiseq(bench_pipeline_config(), seqs, "multi-sequence B=2",
                                                       check_steps=(5, 15, 25))
    n_batched = sum(batched)
    check(n_batched >= n // 2, f"multi-sequence B=2: only {n_batched} of {n} steps batched")
    bound = max(1.25 * pipeline_ate, pipeline_ate + 0.02)
    ates = []
    for b, (t, gt) in enumerate(zip(mst.trackers, gts)):
        ate = sequence_ate(t, gt)
        ates.append(ate)
        print(f"multi-sequence B=2, sequence {b} ({'forward' if b == 0 else 'reversed'}): state {t.state}, "
              f"{int(t.map.n_keyframes())} keyframes, {t.n_local_ba} local BAs, map lines "
              f"{int(t.map.ln_valid.sum())}, ATE {ate:.5f} m (bound {bound:.5f} m from phase 11 (a)'s "
              f"{pipeline_ate:.5f} m)")
        check(t.state == "OK", f"multi-sequence B=2, sequence {b}: final state {t.state}")
        check_ba_lag(f"multi-sequence B=2, sequence {b}", t.ba_lag_frames)
        print_ba_wait(f"multi-sequence B=2, sequence {b}", t, n)
        check(ate <= bound, f"multi-sequence B=2, sequence {b}: ATE {ate:.5f} m above {bound:.5f} m")
    host_probe("after multi-sequence B=2")
    return launches, ates, print_aggregate("multi-sequence B=2", 2, frame_ms, batched)


def phase_multiseq_scaling(frames, rows):
    """Phase 14 (b): B = 1, 4, 8 sequences on the System's defaults (rows
    holds phase 14 (a)'s B = 2 row),
    sequence b starting at phase 5's frame b * MULTISEQ_STAGGER,
    MULTISEQ_FRAMES steps each (bootstrap included).
    multiseq_aggregate_fps = B x batched steps / their seconds, the median
    and spread of three consecutive windows of the batched steps; the host
    ms per batched step; the speedup against B = 1; the device kernels and
    ms of one steady batched step (front end, line front end and the
    vmapped track step) profiled alone at B = 1 and at B = 4."""
    import torch

    from orb_line_slam_tpu_torch.parallel.multi_sequence import batched_frame_track

    cfg = bench_pipeline_config()
    out, launches, kept = dict(rows), {}, {}
    for n_seq in MULTISEQ_BATCHES:
        check(MULTISEQ_STAGGER * (n_seq - 1) + MULTISEQ_FRAMES <= len(frames), "phase 14 (b): too few frames")
        seqs = [frames[MULTISEQ_STAGGER * b: MULTISEQ_STAGGER * b + MULTISEQ_FRAMES] for b in range(n_seq)]
        name = f"multi-sequence scaling B={n_seq}"
        mst, n, frame_ms, batched, kept[n_seq] = run_multiseq(cfg, seqs, name, keep_step=MULTISEQ_KEEP_STEP)
        add_launches(launches, n)
        host_probe(f"after {name}")
        out[n_seq] = print_aggregate(name, n_seq, frame_ms, batched)
        states = [t.state for t in mst.trackers]
        check(all(s == "OK" for s in states), f"{name}: a sequence is not OK: {states}")
    out = dict(sorted(out.items()))
    for n_seq, row in out.items():
        row["speedup_vs_1"] = row["multiseq_aggregate_fps"] / out[1]["multiseq_aggregate_fps"]
    for n_seq in (1, MULTISEQ_KERNEL_PAIRS):
        check(kept.get(n_seq) is not None, f"phase 14 (b): no steady batched step kept at B={n_seq}")
        left, right, stacked, has_lines = kept[n_seq]
        kern = device_kernels(lambda: batched_frame_track(left, right, stacked, cfg, has_lines))
        busy = sum(e.end - e.start for e in kern) / 1e3
        out[n_seq]["step_kernels"] = len(kern)
        out[n_seq]["step_device_ms"] = busy
        print(f"one steady batched step at B={n_seq} (front end, line front end, vmapped track step; has_lines "
              f"{has_lines}) profiled alone: {len(kern)} device kernels, {busy:.2f} ms device busy")
        torch.cuda.synchronize()
    print("multi-sequence scaling: " + json.dumps(out))
    return launches, out


# Phase 15: the shard counts of the production-scale solves on the one
# card, and the shards of each of the two processes that share it.
DIST_SHARDS = (1, 4)
DIST_PROC_SHARDS = 2
DIST_KEYS = ("R", "t", "cam_fixed", "points", "point_valid", "obs_cam", "obs_lm", "obs_uvur", "obs_oct", "obs_valid")


def rotation_gap(Ra, Rb):
    """Largest angle (rad) between matching rotations of two stacks, from
    the skew part of Ra Rb^T (the trace's arccos loses ~1e-3 rad to
    float32 rounding near 0)."""
    d = np.einsum("cij,ckj->cik", np.asarray(Ra, np.float64), np.asarray(Rb, np.float64))
    w = np.stack([d[:, 2, 1] - d[:, 1, 2], d[:, 0, 2] - d[:, 2, 0], d[:, 1, 0] - d[:, 0, 1]], -1)
    return float(np.arcsin(np.clip(np.linalg.norm(w, axis=1) / 2, 0, 1)).max())


def pose_contract(a, b, what, z=None, near_points=True):
    """Hold a result (R, t, points, obs_inlier, chi2; numpy, any of the last
    three None) to another under tests/test_torch_sharded_ba.py's pose
    contract: poses within 1e-3 rad and 5e-3 m; points within 1e-4 m in the
    median and, with near_points, within 1e-3 m nearer than 15 m (all
    points where z is None); inlier counts within 3; chi2 within 1e-3
    relative + 1e-2.  Returns (rad, m, median point m, largest point m)."""
    rad = rotation_gap(a[0], b[0])
    dt = float(np.abs(a[1] - b[1]).max())
    check(rad < 1e-3 and dt < 5e-3, f"{what}: poses differ by {rad:.2e} rad and {dt:.2e} m")
    med = top = None
    if a[2] is not None:
        dp = np.linalg.norm(a[2] - b[2], axis=1)
        near = dp if z is None else dp[z < 15]
        med, top = float(np.median(dp)), float(dp.max())
        check(med < 1e-4 and (not near_points or near.max() < 1e-3),
              f"{what}: points differ by {near.max():.2e} m nearer than 15 m (median {med:.2e})")
    if a[3] is not None:
        n_a, n_b = int(a[3].sum()), int(b[3].sum())
        check(abs(n_a - n_b) <= 3, f"{what}: {n_a} inliers against {n_b}")
        check(abs(float(a[4]) - float(b[4])) < 1e-3 * abs(float(b[4])) + 1e-2,
              f"{what}: chi2 {float(a[4]):.3f} against {float(b[4]):.3f}")
    return rad, dt, med, top


def numpy_result(res):
    return tuple(x.cpu().numpy() for x in res)


def phase_dist_parity():
    """Phase 15 (a): the sharded dense LM (8 iterations) and CG (5 + 10 LM x
    48 CG) on 4 shards of cuda:0, on multihost_worker's problem (12
    cameras, 512 landmarks, 3,072 observations, the size of the CPU
    tests), held to the same call on CPU tensors and to the single-device
    solver on the card: bundle_adjust_cg under the pose contract, and
    bundle_adjust within tests/test_distributed_ba.py's 2e-2 m."""
    import torch

    from orb_line_slam_tpu_torch.backend.global_ba import bundle_adjust_cg
    from orb_line_slam_tpu_torch.backend.local_ba import bundle_adjust
    from orb_line_slam_tpu_torch.parallel.multihost import device_mesh
    from orb_line_slam_tpu_torch.parallel.multihost_worker import SMALL_ITERS, small_problem
    from orb_line_slam_tpu_torch.parallel.sharded_ba import (
        distributed_ba,
        distributed_ba_cg,
        shard_gba_pack,
        unshard_result,
    )

    cam, pack = small_problem()
    i1, i2, ncg = SMALL_ITERS
    args, meta = shard_gba_pack(pack, 4)
    z = pack["points"][:, 2]
    single = [torch.from_numpy(np.array(pack[k])).cuda() for k in DIST_KEYS]

    def sharded_cg(device):
        R, t, pts, inl, chi2 = numpy_result(distributed_ba_cg(device_mesh(device, 4), cam, *args, iters1=i1,
                                                              iters2=i2, cg_iters=ncg))
        return (R, t) + unshard_result(pts, inl, meta, len(pack["obs_cam"])) + (chi2,)

    card, cpu = sharded_cg("cuda"), sharded_cg("cpu")
    ref = numpy_result(bundle_adjust_cg(*single, cam, iters1=i1, iters2=i2, cg_iters=ncg))
    cg_cpu = pose_contract(card, cpu, "sharded CG, card vs CPU", z)
    cg_single = pose_contract(card, ref, "sharded CG vs bundle_adjust_cg on the card", z)
    lm = [numpy_result(distributed_ba(device_mesh(d, 4), cam, *args, n_iters=8)) for d in ("cuda", "cpu")]
    lm = [(R, t, p[: meta["P_tot"]], None, None) for R, t, p in lm]
    lm_cpu = pose_contract(lm[0], lm[1], "sharded dense LM, card vs CPU", z)
    dense = numpy_result(bundle_adjust(*single, cam, iters1=8, iters2=0))
    lm_dt = float(np.abs(lm[0][1] - dense[1]).max())
    check(lm_dt < 2e-2, f"sharded dense LM vs bundle_adjust on the card: cameras differ by {lm_dt:.2e} m")
    print(f"distributed BA parity (4 shards on cuda:0, 12 x 512 x 3072): CG vs CPU {cg_cpu[0]:.1e} rad, "
          f"{cg_cpu[1]:.1e} m, points {cg_cpu[2]:.1e} m median; CG vs bundle_adjust_cg {cg_single[0]:.1e} rad, "
          f"{cg_single[1]:.1e} m, points {cg_single[2]:.1e} m; inliers {int(card[3].sum())} (single "
          f"{int(ref[3].sum())}); dense LM vs CPU {lm_cpu[0]:.1e} rad, {lm_cpu[1]:.1e} m; vs bundle_adjust "
          f"{lm_dt:.1e} m")


def dist_solve_row(name, S, host_ms, busy_ms, n_kernels, red, nbytes, agree, err, per=""):
    print(f"distributed BA {name}, S={S}: {host_ms:.1f} ms per solve (host clock, result fetched), "
          f"{busy_ms:.1f} ms device busy in {n_kernels} kernels{per}; {red} all-reduces of {nbytes} bytes in all; "
          f"pose agreement with bundle_adjust_cg {agree[0]:.1e} rad, {agree[1]:.1e} m, points {agree[2]:.1e} m "
          f"median, {agree[3]:.1e} m at most; median landmark error {err:.4f} m")
    return {"ms": host_ms, "device_ms": busy_ms, "kernels": n_kernels, "allreduces": red, "allreduced_bytes": nbytes,
            "pose_agreement_rad": agree[0], "pose_agreement_m": agree[1], "median_landmark_err_m": err}


def phase_dist_dryrun():
    """Phase 15 (b), first: dryrun_multichip (256 x 65,536 x 262,144, 2 LM
    x 12 CG) at S = 1 and 4 shards on cuda:0, each against
    bundle_adjust_cg on the same problem."""
    from orb_line_slam_tpu_torch.parallel.dryrun import dryrun_multichip

    rows, outs = {}, {}
    for S in DIST_SHARDS:
        out = dryrun_multichip(S, "cuda")
        busy, n_k = device_ms(out["solve_mesh"])
        busy1, n_k1 = device_ms(out["solve_single"])
        ref = numpy_result(out["solve_single"]())
        agree = pose_contract((out["R"], out["t"], out["points"], None, None), (ref[0], ref[1], ref[2], None, None),
                              f"dryrun_multichip S={S} vs bundle_adjust_cg", near_points=False)
        rows[S] = dist_solve_row("dryrun 256 x 65536 x 262144", S, out["t_mesh_s"] * 1e3, busy, n_k,
                                 out["reductions"], out["reduced_bytes"], agree, out["median_landmark_err_m"])
        rows[S].update(single_ms=out["t_single_s"] * 1e3, single_device_ms=busy1, single_kernels=n_k1,
                       dist_gba_efficiency=out["efficiency"])
        print(f"dryrun_multichip S={S}: dist_gba_efficiency = t_single / t_mesh = {out['efficiency']:.3f} "
              f"(bundle_adjust_cg {out['t_single_s'] * 1e3:.1f} ms, {busy1:.1f} ms device busy in {n_k1} kernels): "
              f"the sharding overhead on one card, not a scaling")
        outs[S] = out
    return rows, outs


def phase_dist_capacity(cam, single):
    """Phase 15 (b), second: the loop closer's CG at the default map
    capacity (phase 9's problem, 512 x 65,536 x 524,288, 12 LM x 64 CG),
    landmark-sharded at S = 1 and 4 shards on cuda:0, against phase 9's
    bundle_adjust_cg solve in this run (`single`; the same gauge, camera
    0).  Host ms of one solve (phase 9's warmed the code, the allocator and
    the card); device ms and kernels of 2 of the 12 LM iterations under the
    profiler."""
    import torch

    from orb_line_slam_tpu_torch.loop.loop_closing import sharded_gauge
    from orb_line_slam_tpu_torch.parallel.multihost import device_mesh
    from orb_line_slam_tpu_torch.parallel.sharded_ba import distributed_ba_cg, shard_gba_pack, unshard_result

    pts_true, ref, ms1 = single["pts_true"], single["result"], single["ms"]
    pack = dict(zip(DIST_KEYS, single["arrs"]))
    pack["cam_fixed"] = sharded_gauge(pack["cam_fixed"])
    O = len(pack["obs_cam"])

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3

    err1 = float(np.median(np.linalg.norm(ref[2] - pts_true, axis=1)))
    print(f"distributed BA capacity 512 x 65536 x 524288, bundle_adjust_cg (phase 9): {ms1:.1f} ms per solve, "
          f"{single['device_ms_per_lm_iteration']:.1f} ms device busy in {single['kernels_per_lm_iteration']} kernels "
          f"per LM iteration; median landmark error {err1:.4f} m")
    rows = {"single": {k: single[k] for k in ("ms", "device_ms_per_lm_iteration", "kernels_per_lm_iteration")}}
    for S in DIST_SHARDS:
        mesh = device_mesh("cuda", S)
        args, meta = shard_gba_pack(pack, S)
        margs = [torch.from_numpy(np.array(a)).cuda() for a in args]

        def solve(iters1=12):
            mesh.reset_counts()
            return numpy_result(distributed_ba_cg(mesh, cam, *margs, iters1=iters1, iters2=0, cg_iters=64))

        (R, t, pts, inl, chi2), ms = timed(solve)
        red, nbytes = mesh.n_reductions, mesh.reduced_bytes
        busy, n_k = device_ms(lambda: solve(2))
        pts, inl = unshard_result(pts, inl, meta, O)
        # Landmarks with ~8 observations from random cameras out to 60 m are
        # weakly held: a change of summation order moves them by up to cm
        # (two CPU runs of bundle_adjust_cg differ so), so they are held to
        # the truth as well as the single solver gets them, not to it.
        agree = pose_contract((R, t, None, inl, chi2), ref, f"capacity CG S={S} vs bundle_adjust_cg")
        dp = np.linalg.norm(pts - ref[2], axis=1)
        agree = agree[:2] + (float(np.median(dp)), float(dp.max()))
        err = float(np.median(np.linalg.norm(pts - pts_true, axis=1)))
        check(err <= 1.01 * err1 + 1e-4, f"capacity CG S={S}: median landmark error {err:.5f} m against the single "
                                         f"solver's {err1:.5f} m")
        rows[S] = dist_solve_row("capacity 512 x 65536 x 524288", S, ms, busy / 2, n_k // 2, red, nbytes, agree, err,
                                 per=" per LM iteration")
        rows[S]["dist_gba_efficiency"] = ms1 / ms
        print(f"capacity CG S={S}: dist_gba_efficiency = t_single / t_mesh = {ms1 / ms:.3f} (sharding overhead on one "
              f"card, not a scaling)")
    return rows


def run_gba_workers(nprocs, extra, timeout=300):
    """nprocs multihost_worker processes on one host (a free port on
    localhost), each waited for and killed if it outlasts timeout; returns
    each rank's arrays."""
    import socket
    import tempfile

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "gba")
        procs = [subprocess.Popen([sys.executable, "-m", "orb_line_slam_tpu_torch.parallel.multihost_worker", coord,
                                   str(nprocs), str(pid), out, *extra], cwd=ROOT, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT)
                 for pid in range(nprocs)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0].decode(errors="replace"))
        except subprocess.TimeoutExpired:
            fail(f"a multihost_worker of {nprocs} outlasted {timeout} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for pid, (p, log) in enumerate(zip(procs, logs)):
            check(p.returncode == 0, f"multihost_worker rank {pid} of {nprocs} {extra} failed:\n{log[-3000:]}")
        return [dict(np.load(f"{out}.rank{pid}.npz")) for pid in range(nprocs)]


def phase_dist_processes(dry):
    """Phase 15 (c) and (d): the dryrun problem through multihost_worker in
    child processes.  (c) one process, NCCL at world size 1 through
    multihost.initialize: must equal (b)'s in-process S = 1 solve.  (d) two
    processes with DIST_PROC_SHARDS shards each on cuda:0, gloo with CUDA
    tensors (NCCL refuses two ranks on one card): the replicated outputs
    bit-identical on both ranks, and within the pose contract of (b)'s
    in-process S = 4 solve."""
    flags = ["--device", "cuda", "--problem", "dryrun", "--timed-runs", "2"]
    (nccl,) = run_gba_workers(1, flags + ["--local-shards", "1", "--backend", "nccl"])
    check(np.array_equal(nccl["R"], dry[1]["R"]) and np.array_equal(nccl["t"], dry[1]["t"]),
          f"NCCL world size 1 vs the in-process S=1 solve: cameras differ by "
          f"{float(np.abs(nccl['t'] - dry[1]['t']).max()):.2e} m")
    check(int(nccl["collectives"]) == int(nccl["reductions"]) > 0, "NCCL world size 1: no all_reduce was issued")
    nccl_ms = float(np.median(nccl["solve_s"][1:])) * 1e3
    print(f"distributed BA NCCL world size 1 (dryrun problem, one shard): equal to the in-process S=1 solve; "
          f"{nccl_ms:.1f} ms per solve, {int(nccl['collectives'])} all_reduce calls per solve")
    ranks = run_gba_workers(2, flags + ["--local-shards", str(DIST_PROC_SHARDS), "--backend", "gloo"])
    n = 2 * DIST_PROC_SHARDS
    check(all(int(r["n_shards"]) == n for r in ranks), "two processes: wrong shard count")
    for k in ("R", "t", "chi2"):
        check(np.array_equal(ranks[0][k], ranks[1][k]), f"two processes: {k} differs between the ranks")
    pts = np.concatenate([r["points_local"] for r in ranks])
    agree = pose_contract((ranks[0]["R"], ranks[0]["t"], pts, None, None),
                          (dry[n]["R"], dry[n]["t"], dry[n]["points"], None, None),
                          f"two processes x {DIST_PROC_SHARDS} shards vs in-process S={n}")
    two_ms = [float(np.median(r["solve_s"][1:])) * 1e3 for r in ranks]
    print(f"distributed BA two processes x {DIST_PROC_SHARDS} shards on one card (gloo, CUDA tensors; dryrun "
          f"problem): replicated outputs bit-identical on both ranks; vs the in-process S={n} solve {agree[0]:.1e} "
          f"rad, {agree[1]:.1e} m, points {agree[2]:.1e} m median; {two_ms[0]:.1f} / {two_ms[1]:.1f} ms per solve "
          f"(rank 0 / 1), {int(ranks[0]['collectives'])} all_reduce calls per solve")
    return {"nccl_world1_ms": nccl_ms, "dist_gba_2proc_ms_per_solve": two_ms, "pose_agreement_2proc_m": agree[1]}


def phase_dist_route(slam):
    """Phase 15 (e): the LoopCloser's own route to the sharded solver, on
    copies of phase 10's final map under closers at the default map
    capacity (512 keyframes, 65,536 points: past 256 MB of dense coupling,
    so _pack_gba takes the CG) with a 4-shard cuda:0 mesh.  _pack_gba must
    choose "sharded_cg"; the pinned run_global_ba, and dispatch_global_ba
    solved on the global-BA worker's stream then poll_global_ba(force=True)
    with gba_async, are each held to bundle_adjust_cg on the same pack and
    gauge: inlier flags equal on >= 99% of the rows, the poses each closer
    wrote to its map within the contract."""
    import torch

    from orb_line_slam_tpu_torch.backend.global_ba import bundle_adjust_cg
    from orb_line_slam_tpu_torch.config import MapConfig
    from orb_line_slam_tpu_torch.convert import map_store_from_numpy
    from orb_line_slam_tpu_torch.loop.loop_closing import LoopCloser
    from orb_line_slam_tpu_torch.parallel.multihost import device_mesh

    src = slam.loop_closer
    default = MapConfig()
    cfg = dataclasses.replace(src.cfg, map=dataclasses.replace(src.cfg.map, max_keyframes=default.max_keyframes,
                                                                max_points=default.max_points))

    def closer():
        lc = LoopCloser(cfg, map_store_from_numpy(slam.map), src.voc, device="cuda", mesh=device_mesh("cuda", 4))
        seen = {}
        solve, apply = lc._solve_gba, lc._apply_gba

        def solve_seen(problem):
            seen["thread"] = threading.current_thread().name
            seen["stream"] = torch.cuda.current_stream().cuda_stream
            return solve(problem)

        def apply_seen(pack, res, snap_valid):
            seen["res"] = res
            return apply(pack, res, snap_valid)

        lc._solve_gba, lc._apply_gba = solve_seen, apply_seen
        return lc, seen

    pinned, seen_p = closer()
    pack, problem = pinned._pack_gba(12, 0)
    check(problem["solver"] == pinned.last_gba_solver == "sharded_cg",
          f"route: _pack_gba chose {problem['solver']} on a 4-shard mesh at the default capacity")
    C = len(pack["cam_ids"])
    ref = numpy_result(bundle_adjust_cg(*(torch.from_numpy(np.array(a)).cuda() for a in problem["args"]),
                                        cfg.camera, cfg.orb.scale_factor, iters1=12, iters2=0,
                                        cg_iters=problem["cg_iters"]))
    t0 = time.perf_counter()
    pinned.run_global_ba(12, 0)
    ms_pinned = (time.perf_counter() - t0) * 1e3
    shipped, seen_s = closer()
    shipped.gba_async = True
    t0 = time.perf_counter()
    shipped.dispatch_global_ba(12, 0)
    try:
        check(shipped.poll_global_ba(force=True), "route: the asynchronous global BA was not applied")
    finally:
        shipped.stop()
    ms_async = (time.perf_counter() - t0) * 1e3
    check(seen_s["thread"].startswith("global-ba") and seen_s["stream"] != seen_p["stream"],
          f"route: the asynchronous solve ran on {seen_s['thread']}, not on the global-BA worker's stream")
    out = {}
    for name, lc, seen in (("run_global_ba", pinned, seen_p), ("dispatch_global_ba", shipped, seen_s)):
        check(lc.last_gba_solver == "sharded_cg" and lc.n_gba_applied == 1,
              f"route, {name}: {lc.n_gba_applied} global BA applied as {lc.last_gba_solver}")
        res = seen["res"]
        same = float((res.obs_inlier == ref[3]).mean())
        check(same >= 0.99, f"route, {name}: inlier flags equal on only {same:.4f} of the rows")
        written = (lc.map.kf_R[pack["cam_ids"]], lc.map.kf_t[pack["cam_ids"]])
        agree = pose_contract(written + (None, None, None), ref, f"route, {name}: map poses vs bundle_adjust_cg")
        dp = float(np.median(np.linalg.norm(res.points - ref[2], axis=1)))
        out[name] = {"inlier_agreement": same, "pose_agreement_m": agree[1]}
        print(f"distributed BA route, {name} on phase 10's map ({C} keyframes, {len(pack['lm_ids'])} landmarks, "
              f"{int(pack['n_obs'])} observations; default capacity, 4 shards on cuda:0; solved on "
              f"{seen['thread']}): _pack_gba chose sharded_cg, inlier flags equal on {same:.4f} of the rows, map "
              f"poses within {agree[0]:.1e} rad and {agree[1]:.1e} m of bundle_adjust_cg, landmarks {dp:.1e} m "
              f"median; {ms_pinned if lc is pinned else ms_async:.1f} ms")
    return {"route_inlier_agreement": min(r["inlier_agreement"] for r in out.values()),
            "route_pose_agreement_m": max(r["pose_agreement_m"] for r in out.values()),
            "route_ms": {"run_global_ba": ms_pinned, "dispatch_global_ba": ms_async}}


def phase_distributed(cam, gba_capacity, loop_slam):
    """Phase 15, the distributed global BA (BASELINE config #5): (a) to (e).
    None of the five hand-written kernels is on this path: their counts
    are set to 0 before and must read 0 after."""
    reset_launches()
    phase_dist_parity()
    dry_rows, dry = phase_dist_dryrun()
    cap_rows = phase_dist_capacity(cam, gba_capacity)
    procs = phase_dist_processes(dry)
    route = phase_dist_route(loop_slam)
    launches = read_launches()
    check(not any(launches.values()), f"the distributed BA launched a hand-written kernel: {launches}")
    out = {
        "dist_gba_ms_per_solve": {"dryrun": {S: r["ms"] for S, r in dry_rows.items()},
                                  "capacity": {S: r["ms"] for S, r in cap_rows.items() if S != "single"}},
        "dist_gba_single_ms_per_solve": {"dryrun": {S: r["single_ms"] for S, r in dry_rows.items()},
                                         "capacity": cap_rows["single"]["ms"]},
        "dist_gba_efficiency": {"dryrun": {S: r["dist_gba_efficiency"] for S, r in dry_rows.items()},
                                "capacity": {S: cap_rows[S]["dist_gba_efficiency"] for S in DIST_SHARDS}},
        "dist_gba_allreduces_per_solve": {"dryrun": {S: r["allreduces"] for S, r in dry_rows.items()},
                                          "capacity": {S: cap_rows[S]["allreduces"] for S in DIST_SHARDS}},
        "dist_gba_allreduced_bytes_per_solve": {"dryrun": {S: r["allreduced_bytes"] for S, r in dry_rows.items()},
                                                "capacity": {S: cap_rows[S]["allreduced_bytes"] for S in DIST_SHARDS}},
        "dist_gba_pose_agreement_m": {"dryrun": {S: r["pose_agreement_m"] for S, r in dry_rows.items()},
                                      "capacity": {S: cap_rows[S]["pose_agreement_m"] for S in DIST_SHARDS},
                                      "two_processes": procs["pose_agreement_2proc_m"],
                                      "route": route["route_pose_agreement_m"]},
        "dist_gba_2proc_ms_per_solve": procs["dist_gba_2proc_ms_per_solve"],
        "dist_gba_nccl_world1_ms_per_solve": procs["nccl_world1_ms"],
        "dist_gba_route_inlier_agreement": route["route_inlier_agreement"],
        "dist_gba_route_ms": route["route_ms"],
        "dist_gba_rows": {"dryrun": dry_rows, "capacity": cap_rows},
    }
    print("distributed BA: " + json.dumps(out))
    return out


def run_endurance_on_card(name, progress_every=0, keep_frame=None, **kwargs):
    """eval/endurance.py::run_endurance on the card, every kernel's launch
    count set to 0 just before and read just after, with three probes
    wrapped around the System for the run's length: track_stereo timed per
    frame (the tracking thread's stream synchronised, as every slice run)
    with the state after it, System._reloc_candidates (the keyframe
    database's BoW candidates) and Tracker._relocalize (its result, its
    inliers, the keyframe it found and the database candidates it was
    given).  With ``keep_frame`` = i, frame i's Frame and the System are
    kept.  Returns the run's dict and a record: launches, per_frame (host
    ms p50, p90, max), states, relocs, peak_mb (the device's peak
    allocated), kept ((System, Frame) or None) and centres (the tracked
    camera centre after each frame)."""
    import torch

    from orb_line_slam_tpu_torch.eval.endurance import run_endurance
    from orb_line_slam_tpu_torch.pipeline.system import System
    from orb_line_slam_tpu_torch.pipeline.tracking import Tracker

    frame_ms, states, relocs, db, kept, centres = [], [], [], [], [], []
    saved = System.track_stereo, System._reloc_candidates, Tracker._relocalize, Tracker._consume
    t_start = time.perf_counter()

    def track_stereo(self, *a, **k):
        if len(states) == keep_frame:
            kept.append(self)
        t0 = time.perf_counter()
        out = saved[0](self, *a, **k)
        torch.cuda.current_stream().synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        states.append(self.tracking_state())
        centres.append(-self.tracker.R.T @ self.tracker.t)
        if progress_every and len(states) % progress_every == 0:
            print(f"{name}: {len(states)} frames in {time.perf_counter() - t_start:.1f} s, state {states[-1]}, "
                  f"{int(self.map.n_keyframes())} keyframes, {self.n_loops_closed} loops", flush=True)
        return out

    def reloc_candidates(self, frame):
        cand = saved[1](self, frame)
        db.append([int(c) for c in cand])
        return cand

    def relocalize(self, frame):
        db.clear()
        ok, assoc, n_inl = saved[2](self, frame)
        relocs.append({"frame": len(states), "ok": bool(ok), "inliers": int(n_inl),
                       "kf": int(self.ref_kf) if ok else None, "db_candidates": db[0] if db else None})
        return ok, assoc, n_inl

    def consume(self, e):
        if len(states) == keep_frame:
            kept.append(e.frame)
        return saved[3](self, e)

    System.track_stereo, System._reloc_candidates, Tracker._relocalize, Tracker._consume = \
        track_stereo, reloc_candidates, relocalize, consume
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        with PoseSolveSites() as sites:
            reset_launches()
            m = run_endurance(device="cuda", **kwargs)
            torch.cuda.synchronize()
            launches = read_launches()
    finally:
        System.track_stereo, System._reloc_candidates, Tracker._relocalize, Tracker._consume = saved
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    per_frame = {"p50": float(np.percentile(frame_ms, 50)), "p90": float(np.percentile(frame_ms, 90)),
                 "max": float(max(frame_ms))}
    print(f"{name}: " + json.dumps(m))
    print(f"{name}: fps windows {m['ate_long_fps_windows']} ({kwargs.get('fps_window', 100)} frames each, rendering "
          f"included), tracking thread's host ms per frame p50 {per_frame['p50']:.1f}, p90 {per_frame['p90']:.1f}, "
          f"max {per_frame['max']:.1f}; device peak allocated {peak_mb:.1f} MB (torch.cuda.max_memory_allocated); "
          f"host peak RSS {m['ate_long_peak_rss_mb']} MB; kernel launches {json.dumps(launches)}; "
          f"{sites.counts['track_steps']} tracking steps, {sites.counts['assoc_solves']} solves from associations")
    print(f"{name}: relocalizations {json.dumps(relocs)}")
    return m, {"launches": launches, "per_frame": per_frame, "states": states, "relocs": relocs, "peak_mb": peak_mb,
               "kept": tuple(kept) if len(kept) == 2 else None, "centres": centres, "pose_sites": dict(sites.counts),
               "pose_expected": sites.expected()}


def phase_endurance_run():
    """Phase 16 (a): the endurance run on the card on the System's
    defaults (shipping=True): the noise frames are LOST, tracking recovers
    by a relocalization from keyframe-database candidates, one orb_describe
    and one stereo_sad per frame (noise frames included) and no patch
    tile, ATE within max(1.25 x, + 2 cm) of the JAX package's pinned run."""
    n, loss_frames = ENDURANCE["n_frames"], ENDURANCE["loss_frames"]
    loss_start = int(n * ENDURANCE["loss_at"])
    first_after = loss_start + loss_frames
    m, rec = run_endurance_on_card("endurance", keep_frame=first_after, shipping=True, **ENDURANCE)
    launches, states, relocs, kept = rec["launches"], rec["states"], rec["relocs"], rec["kept"]
    noise = states[loss_start:first_after]
    check(len(states) == n, f"endurance: {len(states)} frames tracked, want {n}")
    check(noise == ["LOST"] * loss_frames, f"endurance: the noise frames' states are {noise}, want LOST")
    check(m["ate_long_lost_frames"] <= loss_frames + 6, f"endurance: {m['ate_long_lost_frames']} frames lost")
    check(m["ate_long_recovered_at"] > 0, "endurance: tracking never recovered after the dropout")
    check(all(r["db_candidates"] for r in relocs if loss_start <= r["frame"] < first_after),
          f"endurance: a noise frame's relocalization had no keyframe-database candidates: {relocs}")
    from_db = [r for r in relocs if r["ok"] and r["db_candidates"] and r["kf"] in r["db_candidates"]]
    if not from_db:
        # The JAX ladder tries the track step before relocalization, and its
        # reference-keyframe rung recovers the first frame after the dropout
        # when the keyframe left by the last failed relocalization is close
        # (which one that is follows the database's ranking for a noise
        # frame, and the card's asynchronous schedule).  Then that frame is
        # relocalized here, after the run, from the database's candidates
        # over the final map.
        check(kept is not None, "endurance: the first frame after the dropout was not kept")
        slam, frame = kept
        cand = [int(k) for k in slam._reloc_candidates(frame)]
        ok, _, n_inl = slam.tracker._relocalize(frame)
        kf = int(slam.tracker.ref_kf)
        print(f"endurance: frame {first_after} was recovered by the track step; relocalized after the run: ok {ok}, "
              f"{n_inl} inliers, keyframe {kf} of the database's candidates {cand}")
        if ok and kf in cand:
            from_db = [{"frame": first_after, "ok": True, "inliers": int(n_inl), "kf": kf, "after_run": True}]
    check(from_db, f"endurance: no relocalization succeeded from keyframe-database candidates: {relocs}")
    check(launches == {"patch_tiles": 0, "orb_describe": n, "stereo_sad": n, "pose_solve": rec["pose_expected"],
                       "orb_detect": detect_launches(n)},
          f"endurance: kernel launches {launches} for {n} frames, {rec['pose_sites']} (want one detection call, one "
          f"orb_describe and one stereo_sad per frame, three pose solves per tracking step and one per "
          f"relocalization solve)")
    print(f"endurance: {launches['pose_solve']} pose-solve launches: 3 x {rec['pose_sites']['track_steps']} tracking "
          f"steps + {rec['pose_sites']['assoc_solves']} from associations (relocalization and reference-keyframe "
          f"tracks) over {n} frames")
    bound = max(1.25 * JAX_CPU_REFERENCE_ATE_ENDURANCE_M, JAX_CPU_REFERENCE_ATE_ENDURANCE_M + 0.02)
    print(f"endurance: ATE {m['ate_long_m']:.4f} m (bound {bound:.5f} m from the JAX package's pinned "
          f"{JAX_CPU_REFERENCE_ATE_ENDURANCE_M:.5f} m), recovered at frame {m['ate_long_recovered_at']}, "
          f"{len(from_db)} relocalization(s) from database candidates (first at frame {from_db[0]['frame']})")
    check(m["ate_long_m"] <= bound, f"endurance: ATE {m['ate_long_m']:.4f} m above {bound:.5f} m")
    return launches, {**m, "ate_long_frame_host_ms": rec["per_frame"], "ate_long_device_peak_mb": rec["peak_mb"],
                      "ate_long_db_relocalizations": len(from_db),
                      "ate_long_relocalized_in_run": not from_db[0].get("after_run", False)}


def phase_checkpoint(slam):
    """Phase 16 (b): save_map / load_map of phase 10's final map; every
    array and every scalar key equal after the round trip."""
    import tempfile

    from orb_line_slam_tpu_torch.slam_map import checkpoint

    store = slam.map
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "map.npz")
        t0 = time.perf_counter()
        checkpoint.save_map(store, path)
        t1 = time.perf_counter()
        back = checkpoint.load_map(path)
        t2 = time.perf_counter()
        size_mb = os.path.getsize(path) / 2**20
    names = checkpoint._ARRAYS + (checkpoint._LINE_ARRAYS if store.Lf else [])
    differ = [k for k in names if not np.array_equal(getattr(store, k), getattr(back, k))]
    scalars = ("_next_kf", "_free_pts", "_free_lines", "_free_kfs", "K", "P", "F", "L", "Lf")
    differ += [k for k in scalars if getattr(store, k) != getattr(back, k)]
    print(f"checkpoint: phase 10's map ({int(store.kf_valid.sum())} keyframes, {int(store.pt_valid.sum())} points, "
          f"{int(store.ln_valid.sum())} lines) saved in {(t1 - t0) * 1e3:.1f} ms ({size_mb:.2f} MB), loaded in "
          f"{(t2 - t1) * 1e3:.1f} ms; {len(names)} arrays and {len(scalars)} scalars compared, differing: {differ}")
    check(not differ, f"checkpoint: {differ} differ after the round trip")


def phase_native():
    """Phase 16 (c): build the native host library (make libnative in
    native/) and, if it built, parse one synthesized vocabulary through
    the native parser and the pure-Python one: equal node lists and
    vocabularies.  A failed build is reported, not a failure: the
    Python parse is the reference's own path."""
    import tempfile

    from orb_line_slam_tpu_torch.loop.vocabulary import Vocabulary
    from orb_line_slam_tpu_torch.utils import native

    t0 = time.perf_counter()
    try:
        mk = subprocess.run(["make", "libnative"], cwd=native._NATIVE_DIR, capture_output=True, text=True,
                            timeout=300)
        reason = "" if mk.returncode == 0 else (mk.stderr or mk.stdout).strip()[-600:]
    except (OSError, subprocess.TimeoutExpired) as e:
        reason = repr(e)
    lib = None if reason else native.get_native_lib()
    if lib is None:
        print(f"native: libnative did not build ({time.perf_counter() - t0:.1f} s): {reason or 'the library did not load'}")
        return {"native_built": False}
    print(f"native: libnative built in {time.perf_counter() - t0:.1f} s")
    voc = Vocabulary.synthesize(k=10, depth=4, seed=0)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "voc.txt")
        voc.save_orbvoc_txt(path)
        t0 = time.perf_counter()
        fast = native.parse_orbvoc_native(path)
        t1 = time.perf_counter()
        slow = Vocabulary.parse_orbvoc_nodes(path)
        t2 = time.perf_counter()
    check(fast is not None, "native: the library built but parse_orbvoc_native returned None")
    same = fast[:2] == slow[:2] and all(np.array_equal(a, b) for a, b in zip(fast[2:], slow[2:]))
    va, vb = Vocabulary._from_node_list(*fast), Vocabulary._from_node_list(*slow)
    same = same and all(np.array_equal(getattr(va, k), getattr(vb, k))
                        for k in ("children", "node_desc", "word_id", "word_weight"))
    print(f"native: a {len(slow[2])}-node vocabulary ({va.n_words} words) parsed natively in {(t1 - t0) * 1e3:.1f} ms "
          f"and in Python in {(t2 - t1) * 1e3:.1f} ms (host); equal: {same}")
    check(same, "native: the native and the Python parse differ")
    return {"native_built": True, "orbvoc_parse_native_ms": (t1 - t0) * 1e3, "orbvoc_parse_python_ms": (t2 - t1) * 1e3}


def phase_endurance(loop_slam):
    """Phase 16: (a) the endurance run, (b) the map checkpoint, (c) the
    native library."""
    launches, out = phase_endurance_run()
    phase_checkpoint(loop_slam)
    out.update(phase_native())
    return launches, out


def endurance_long():
    """bench.py:92's run_endurance(n_frames=1500, shipping=True) on the
    card, then the same run pinned (shipping=False, the JAX package's
    default), kept out of the smoke (``python3 chip_smoke.py
    --endurance-long``): each takes longer than the smoke's whole limit.
    Beside each dict: the tracked pose's error against the truth, frame
    by frame as the tracker reported it (not the final trajectory, which
    later corrections rewrite): how many frames were off by more than
    0.3 m, the first and the worst, and the frames lost."""
    from orb_line_slam_tpu_torch.data.synthetic import loop_circuit_trajectory

    phase_device()
    phase_build()
    import orb_line_slam_tpu_torch  # noqa: F401  (sets the fp32 policy)

    truth = np.stack([-R.T @ t for R, t in loop_circuit_trajectory(**ENDURANCE_LONG)])
    for shipping in (True, False):
        name = f"endurance long ({'shipping' if shipping else 'pinned'})"
        t0 = time.perf_counter()
        m, rec = run_endurance_on_card(name, progress_every=100, shipping=shipping, **ENDURANCE_LONG)
        err = np.linalg.norm(np.stack(rec["centres"]) - truth, axis=1)
        off = np.flatnonzero(err > 0.3)
        print(json.dumps({**m, "shipping": shipping, "ate_long_frame_host_ms": rec["per_frame"],
                          "ate_long_device_peak_mb": rec["peak_mb"], "launches": rec["launches"],
                          "seconds": time.perf_counter() - t0,
                          "lost_at": [i for i, st in enumerate(rec["states"]) if st == "LOST"],
                          "tracked_pose_error_m": {"frames_above_0.3": int(len(off)),
                                                   "first_above_0.3": int(off[0]) if len(off) else None,
                                                   "max": float(err.max()), "max_at": int(err.argmax()),
                                                   "median_per_100_frames": [round(float(np.median(err[i:i + 100])), 3)
                                                                             for i in range(0, len(err), 100)]}}))
        host_probe(f"after the {name} run")


# The two front-end kernels at phase 3's nine shapes, for --tree-probe,
# --compare-parent and --front-end-variants: (kernel, shape name, images
# or pairs b, atlas h, w, keypoints per image or pair n).
FRONT_END_SEED = 4242


def front_end_shapes():
    shapes = []
    cells = (("point cell", kitti_config()), ("point+line cell", euroc_config()), ("loop cell", loop_config()))
    for name, cfg in cells:
        (h, w), n = cell_atlas_shape(cfg), cfg.orb.n_features
        shapes += [("orb_describe", name, 2, h, w, n), ("stereo_sad", name, 1, h, w, n)]
    (h, w), n = cell_atlas_shape(tum_config()), tum_config().orb.n_features
    shapes.append(("orb_describe", "TUM cell", 1, h, w, n))
    (h, w), n, b = cell_atlas_shape(cells[0][1]), cells[0][1].orb.n_features, MULTISEQ_KERNEL_PAIRS
    shapes += [("orb_describe", f"point cell, {b} pairs", 2 * b, h, w, n), ("stereo_sad", f"point cell, {b} pairs", b, h, w, n)]
    return shapes


def front_end_inputs(kernel, b, h, w, n, seed):
    """Fixed seeded inputs on the card, made as phase 3 makes them (a
    low-passed atlas, border and out-of-range keypoints among random ones,
    offsets in [-0.5, 0.5] with exact +-0.5 among them).  orb_describe:
    (atlas [b, h, w], axy [b, n, 2], delta [b, n, 2]); stereo_sad: (atlas_l,
    axy_l, atlas_r, cx, cy) for one pair ([h, w], b = 1) or b pairs, with
    whole-number centres (as stereo_match gives them) in the first half of
    the keypoints and fractional ones in the second."""
    import torch

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    imgs = b if kernel == "orb_describe" else 2 * b
    noise = torch.from_numpy((rng.random((imgs, 1, h, w)) * 255).astype(np.float32)).to(dev)
    atlas = (torch.nn.functional.avg_pool2d(noise, 5, 1, 2, count_include_pad=False)[:, 0] * 0.7 + noise[:, 0] * 0.3)
    xy = np.stack([rng.integers(-20, w + 20, (b, n)), rng.integers(-20, h + 20, (b, n))], -1)
    border = border_keypoints(h, w)
    xy[:, : len(border)] = border
    axy = torch.from_numpy(xy.astype(np.int32)).to(dev)
    if kernel == "orb_describe":
        delta = rng.uniform(-0.5, 0.5, (b, n, 2)).astype(np.float32)
        delta[:, :4] = [[0.0, 0.0], [0.5, -0.5], [-0.5, 0.5], [0.5, 0.5]]
        return atlas.contiguous(), axy, torch.from_numpy(delta).to(dev)
    cx = np.floor(xy[..., 0] - rng.uniform(0, 100, (b, n))).astype(np.float32)
    cy = xy[..., 1].astype(np.float32)
    half = n // 2
    cx[:, half:] += rng.uniform(0, 1, (b, n - half)).astype(np.float32)
    cy[:, half:] += rng.uniform(0, 1, (b, n - half)).astype(np.float32)
    cx, cy = (torch.from_numpy(c).to(dev) for c in (cx, cy))
    if b == 1:
        return atlas[0].contiguous(), axy[0].contiguous(), atlas[1].contiguous(), cx[0].contiguous(), cy[0].contiguous()
    return atlas[:b].contiguous(), axy, atlas[b:].contiguous(), cx, cy


def front_end_call(kernel, args):
    """The wrapper call on these inputs, and its module (for `launches`)."""
    from orb_line_slam_tpu_torch.ops import describe, stereo_sad

    if kernel == "orb_describe":
        return (lambda: describe.describe_keypoints(*args)), describe
    return (lambda: stereo_sad.stereo_sad(*args)), stereo_sad


def outputs_hash(outs):
    """sha256 of the outputs' bytes (on the host), in order."""
    import hashlib

    digest = hashlib.sha256()
    for t in outs if isinstance(outs, tuple) else (outs,):
        digest.update(t.contiguous().cpu().numpy().tobytes())
    return digest.hexdigest()


def front_end_probe():
    """Per shape of front_end_shapes(): the hash of the kernel's outputs
    on front_end_inputs (seed FRONT_END_SEED + index) and its own device
    us (torch.profiler, mean of 20 calls)."""
    import torch

    out = {}
    for i, (kernel, name, b, h, w, n) in enumerate(front_end_shapes()):
        fn, module = front_end_call(kernel, front_end_inputs(kernel, b, h, w, n, FRONT_END_SEED + i))
        res = fn()
        torch.cuda.synchronize()
        out[f"{kernel} ({name}: [{b}x{h}x{w}], N={n})"] = {
            "hash": outputs_hash(res), "device_us": own_device_ms(fn, f"{kernel}_kernel", module) * 1e3}
    return out


# --front-end-split: the parts each source counts when built with
# -D<NAME>_SPLIT=1 (csrc/orb_describe.cu's and csrc/stereo_sad.cu's Split).
FRONT_END_SPLIT_PARTS = {
    "orb_describe": ("tables and first tile", "tile wait", "row pass", "column pass", "moments and angle", "BRIEF"),
    "stereo_sad": ("loads landed", "blend", "slides", "reduction and store"),
}


def front_end_split():
    """``python3 chip_smoke.py --front-end-split``: both front-end sources
    built with their split counters, one launch each at the point cell's
    and the batched step's front_end_inputs after a warm-up: per keypoint,
    lane 0's cycles in each part (summed over warps, over the keypoints);
    per warp, keypoints, cycles and ns from its start to its end; the SM
    clock those give; and the first start to the last end on the device's
    clock beside the shipped build's own device time."""
    import ctypes

    import torch

    from orb_line_slam_tpu_torch.ops import _build, describe, stereo_sad

    phase_device()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for kernel in FRONT_END_SPLIT_PARTS:
        so = _build.BUILD_DIR / f"lib{kernel}_split.so"
        cmd = [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               f"-D{kernel.upper()}_SPLIT=1", "-shared", "-Xcompiler", "-fPIC", "-o", str(so),
               str(_build.CSRC / f"{kernel}.cu")]
        procs[kernel] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), so)
    libs = {}
    for kernel, (proc, so) in procs.items():
        _, stderr = proc.communicate()
        check(proc.returncode == 0, f"nvcc failed on the split build of {kernel}:\n{stderr[-3000:]}")
        lib = ctypes.CDLL(str(so))
        fn = getattr(lib, f"{kernel}_launch")
        fn.argtypes = [*(describe if kernel == "orb_describe" else stereo_sad)._ARGTYPES, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        read = getattr(lib, f"{kernel}_split")
        read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
        libs[kernel] = (fn, read)
    dev = torch.device("cuda")
    bands, rot = describe._kernel_tables_on(dev)
    rows = {}
    for kernel, shape, b, h, w, n in [s for s in front_end_shapes() if s[1].startswith("point cell")]:
        args = front_end_inputs(kernel, b, h, w, n, FRONT_END_SEED)
        fn, read = libs[kernel]
        parts = FRONT_END_SPLIT_PARTS[kernel]
        counts = (ctypes.c_ulonglong * (len(parts) + 6))()

        def call():
            if kernel == "orb_describe":
                atlas, axy, delta = args
                angle = torch.empty((b * n,), dtype=torch.float32, device=dev)
                desc = torch.empty((b * n, 32), dtype=torch.uint8, device=dev)
                _build.launch(fn, kernel, dev, atlas.data_ptr(), b, h, w, axy.data_ptr(), delta.data_ptr(), n,
                              bands.data_ptr(), rot.data_ptr(), describe._INV_BIN, angle.data_ptr(), desc.data_ptr())
                return angle, desc
            atlas_l, axy_l, atlas_r, cx, cy = args
            out = torch.empty((*axy_l.shape[:-1], stereo_sad.N_OFFSETS), dtype=torch.float32, device=dev)
            _build.launch(fn, kernel, dev, atlas_l.data_ptr(), axy_l.data_ptr(), atlas_r.data_ptr(), cx.data_ptr(),
                          cy.data_ptr(), h, w, n, b * n, out.data_ptr())
            return out

        shipped, module = front_end_call(kernel, args)
        check(outputs_hash(call()) == outputs_hash(shipped()),
              f"{kernel}'s split build at {shape} gives other bits than the shipped build")
        torch.cuda.synchronize()
        check(read(counts) == 0, f"{kernel}_split failed")
        call()
        torch.cuda.synchronize()
        check(read(counts) == 0, f"{kernel}_split failed")
        c = list(counts)
        kp, warps, cycles, ns = c[len(parts)], c[len(parts) + 1], c[len(parts) + 2], c[len(parts) + 3]
        span_us = (c[len(parts) + 5] - c[len(parts) + 4]) / 1e3
        own = own_device_ms(shipped, f"{kernel}_kernel", module) * 1e3
        row = {"cycles_per_keypoint": {p: c[i] / kp for i, p in enumerate(parts)}, "keypoints": kp, "warps": warps,
               "keypoints_per_warp": kp / warps, "warp_cycles_mean": cycles / warps, "warp_us_mean": ns / warps / 1e3,
               "sm_ghz": cycles / ns, "span_us": span_us, "own_device_us": own}
        rows[f"{kernel} ({shape}: [{b}x{h}x{w}], N={b}x{n})"] = row
        print(f"{kernel} split at {shape} [{b}x{h}x{w}], N={b}x{n}: lane 0's cycles a keypoint "
              + ", ".join(f"{p} {v:.0f}" for p, v in row["cycles_per_keypoint"].items())
              + f"; {warps} warps, {kp / warps:.2f} keypoints a warp, a warp {cycles / warps:.0f} cycles = "
              f"{ns / warps / 1e3:.2f} us from start to end (SM clock {cycles / ns:.3f} GHz); first start to last end "
              f"{span_us:.2f} us on the device's clock (the counters' own atomics included), shipped build's own "
              f"device time {own:.2f} us")
    print(json.dumps({"front_end_split": rows}))


def tree_probe(tree, out_path):
    """``python3 chip_smoke.py --tree-probe DIR OUT``: phases 5 and 7's
    slices (their frames, configs and pinned schedule, each with phase 8's
    profile window) driven through the package of the tree at DIR by this
    script's functions, the launch checks off (another tree's kernels
    differ).  Writes to OUT one JSON object: the pose-solve kernel's own
    device and event us at phase 3's seven shapes (pose_shapes); the hash
    of orb_describe's and stereo_sad's outputs on fixed seeded inputs and
    their own device us at phase 3's nine shapes (front_end_probe); per
    slice frames/s, the tracking thread's host ms per frame, the tracker's
    track_step host ms per call, ATE, keyframes, launches, and the
    window's kernels and device ms per frame of the whole frame, the
    tracking step and its pose solves."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    cfg, lcfg = kitti_config(), euroc_config()
    jobs = [sequence_job(cfg, N_FRAMES), sequence_job(lcfg, N_FRAMES, LINE_SCENE, LINE_STEP)]
    frames, lframes = render_jobs(jobs, min(8, os.cpu_count() or 1))
    phase_device()
    import orb_line_slam_tpu_torch
    from orb_line_slam_tpu_torch.ops import _build

    pkg = os.path.dirname(os.path.abspath(orb_line_slam_tpu_torch.__file__))
    check(pkg == os.path.join(tree, "orb_line_slam_tpu_torch"), f"--tree-probe {tree} imported the package at {pkg}")
    _build.build()
    out = {"tree": tree, "sources": list(_build.SOURCES), "pose_solve": pose_shape_times(pose_shapes(pose_cells())),
           "front_end": front_end_probe()}
    for key, c, job, fr, dt in (("points", cfg, jobs[0], frames, 0.1), ("lines", lcfg, jobs[1], lframes, 0.05)):
        window = ProfileWindow(f"{key} slice of {tree}")
        slam, launches, fps, ate, per_frame = run_slice(c, job[1], fr, f"{key} slice", dt, window=window,
                                                        check_launches=False)
        out[key] = {"fps": fps, "frame_host_ms": per_frame, "ate_m": ate, "keyframes": int(slam.map.n_keyframes()),
                    "launches": launches,
                    "track_step_host_ms_per_call": slam.tracker.timing.table()["track_step"]["ms_per_call"],
                    **window.summary}
    with open(out_path, "w") as f:
        json.dump(out, f)


def compare_parent(parent):
    """``python3 chip_smoke.py --compare-parent DIR``: --tree-probe of the
    tree at DIR (an unpacked parent commit) and of this checkout in turns,
    parent, this, this, parent, each in a process of its own on the same
    card; prints each probe, the pose-solve kernel's own device time at
    phase 3's seven shapes side by side, the front-end kernels' own device
    time at phase 3's nine shapes side by side (their output hashes must
    be equal in all four probes), each slice's ATE and keyframes, and, per
    slice, this tree's figures beside the parent's (kernels per frame of
    the tracking step as a share of the parent's)."""
    import tempfile

    phase_device()
    rows = []
    with tempfile.TemporaryDirectory() as d:
        for i, tree in enumerate((parent, ROOT, ROOT, parent)):
            path = os.path.join(d, f"probe{i}.json")
            r = subprocess.run([sys.executable, os.path.abspath(__file__), "--tree-probe", tree, path], timeout=900)
            check(r.returncode == 0 and os.path.exists(path), f"--tree-probe {tree} failed ({r.returncode})")
            with open(path) as f:
                rows.append(json.load(f))
            print(json.dumps({"tree_probe": rows[-1]}), flush=True)
    keys = ("fps", "track_step_host_ms_per_call", "kernels_per_frame", "track_step_kernels_per_frame",
            "pose_solve_kernels_per_frame", "device_busy_ms_per_frame", "track_step_device_ms_per_frame")
    summary = {}
    for cell in ("points", "lines"):
        summary[cell] = {k: {"parent": [rows[0][cell][k], rows[3][cell][k]], "this": [rows[1][cell][k], rows[2][cell][k]]}
                         for k in keys}
        summary[cell]["frame_host_ms_p50"] = {"parent": [rows[0][cell]["frame_host_ms"]["p50"],
                                                         rows[3][cell]["frame_host_ms"]["p50"]],
                                              "this": [rows[1][cell]["frame_host_ms"]["p50"],
                                                       rows[2][cell]["frame_host_ms"]["p50"]]}
        tk = summary[cell]["track_step_kernels_per_frame"]
        summary[cell]["track_step_kernels_share_of_parent"] = max(tk["this"]) / min(tk["parent"])
    summary["pose_solve_device_us"] = {
        shape: {"parent": [rows[0]["pose_solve"][shape]["device_us"], rows[3]["pose_solve"][shape]["device_us"]],
                "this": [rows[1]["pose_solve"][shape]["device_us"], rows[2]["pose_solve"][shape]["device_us"]],
                "cluster_ctas": rows[1]["pose_solve"][shape]["cluster_ctas"]}
        for shape in rows[0]["pose_solve"]}
    for shape, row in summary["pose_solve_device_us"].items():
        print(f"compare parent, pose solve {shape}: own device us parent {row['parent'][0]:.1f} / "
              f"{row['parent'][1]:.1f}, this {row['this'][0]:.1f} / {row['this'][1]:.1f} "
              f"({row['cluster_ctas']} CTAs a solve)")
    summary["front_end_device_us"] = {}
    for shape in rows[0]["front_end"]:
        hashes = [r["front_end"][shape]["hash"] for r in rows]
        check(len(set(hashes)) == 1, f"compare parent: {shape} outputs differ between the trees: "
                                     f"parent {hashes[0][:16]}, this {hashes[1][:16]}")
        us = [r["front_end"][shape]["device_us"] for r in rows]
        summary["front_end_device_us"][shape] = {"parent": [us[0], us[3]], "this": [us[1], us[2]], "hash": hashes[0]}
        print(f"compare parent, {shape}: same outputs (sha256 {hashes[0][:16]}); own device us parent {us[0]:.2f} / "
              f"{us[3]:.2f}, this {us[1]:.2f} / {us[2]:.2f}")
    for cell in ("points", "lines"):
        ates, kfs = [r[cell]["ate_m"] for r in rows], [r[cell]["keyframes"] for r in rows]
        summary[cell]["ate_m"] = {"parent": [ates[0], ates[3]], "this": [ates[1], ates[2]]}
        summary[cell]["keyframes"] = {"parent": [kfs[0], kfs[3]], "this": [kfs[1], kfs[2]]}
        print(f"compare parent, {cell} slice: ATE m parent {ates[0]!r} / {ates[3]!r}, this {ates[1]!r} / {ates[2]!r}; "
              f"keyframes parent {kfs[0]} / {kfs[3]}, this {kfs[1]} / {kfs[2]}")
    print(json.dumps({"compare_parent": summary}))


# --pose-split's counters of csrc/pose_solve.cu built with POSE_SOLVE_SPLIT=1:
# five slots of CTA 0's thread 0 (the solving warp, the critical path),
# then two of a worker (thread 32).
POSE_SPLIT_SLOTS = ("speculative step", "cluster barrier", "gather", "serial step", "broadcast")
POSE_WORKER_SLOTS = ("a worker's pass", "a worker's sums")


def pose_split(parent=None):
    """``python3 chip_smoke.py --pose-split [DIR]``: where an LM iteration
    of the pose-solve kernel spends its time.  Builds csrc/pose_solve.cu
    as it is and with POSE_SOLVE_SPLIT=1 and, with DIR (an unpacked
    parent commit), DIR's own pose_solve.cu, all nvcc at once; holds every
    build to the plain version at phase 3's seven shapes (the pose
    contract; it prints whether the split build gives the same bits);
    times the own device time of this build and DIR's there in turns
    (DIR, this, this, DIR); then per shape the split build's cycle
    counters (POSE_SPLIT_SLOTS, POSE_WORKER_SLOTS) as us per pass, from
    the split build's own device time."""
    import ctypes

    import torch

    sys.path.insert(0, ROOT)
    phase_device()
    import orb_line_slam_tpu_torch  # noqa: F401  (sets the fp32 policy)
    from orb_line_slam_tpu_torch.backend import pose_opt
    from orb_line_slam_tpu_torch.ops import _build

    src = str(_build.CSRC / "pose_solve.cu")
    jobs = {"this": (src, ()), "split": (src, ("-DPOSE_SOLVE_SPLIT=1",))}
    if parent is not None:
        jobs["parent"] = (os.path.join(os.path.abspath(parent), "orb_line_slam_tpu_torch", "csrc", "pose_solve.cu"), ())
    t0 = time.perf_counter()
    started = {name: build_pose_solve(name, path, flags) for name, (path, flags) in jobs.items()}
    libs = {}
    for name, job in started.items():
        libs[name], usage = load_pose_solve(name, *job)
        print(f"pose split: {name} built {time.perf_counter() - t0:.1f} s after the start (ptxas: {usage})")
    libs["split"].pose_solve_split.argtypes = [ctypes.c_void_p]
    libs["split"].pose_solve_split.restype = ctypes.c_int

    def use(name):
        _build._FUNCTIONS["pose_solve"] = libs[name].pose_solve_launch

    shapes = pose_shapes(pose_cells())
    for label, args, rounds, iters in shapes:
        outs = {}
        for name in libs:
            use(name)
            outs[name] = pose_opt.pose_solve_cuda(*args, rounds, iters)
        torch.cuda.synchronize()
        batched = args[0].dim() == 3
        for b in range(args[0].shape[0] if batched else 1):
            one = [x[b] for x in args[:11]] if batched else list(args[:11])
            want = pose_opt.pose_solve_plain(*one, *args[11:], rounds, iters)
            for name, got in outs.items():
                k = [x[b] for x in got] if batched else list(got)
                rad = rotation_gap(k[0].cpu().numpy()[None], want[0].cpu().numpy()[None])
                dt = float((k[1] - want[1]).abs().max())
                check(rad < 1e-3 and dt < 5e-3 and abs(int(k[4]) - int(want[4])) <= 3,
                      f"pose split: {name} build at {label}, solve {b}: {rad:.2e} rad, {dt:.2e} m, "
                      f"inliers {int(k[4])} / {int(want[4])}")
        same = all(torch.equal(x, y) for x, y in zip(outs["split"], outs["this"]))
        print(f"pose split, {label}: every build within the pose contract of the plain version; the split build "
              f"{'gives' if same else 'does not give'} this build's bits")

    order = [n for n in ("parent", "this") if n in libs]
    order = order + order[::-1]
    times = {label: {} for label, *_ in shapes}
    for name in order:
        use(name)
        for label, args, rounds, iters in shapes:
            own = own_device_ms(lambda: pose_opt.pose_solve_cuda(*args, rounds, iters), "pose_solve_kernel",
                                pose_opt) * 1e3
            times[label].setdefault(name, []).append(own)
    split = {}
    n_slots = len(POSE_SPLIT_SLOTS) + len(POSE_WORKER_SLOTS)
    counters = (ctypes.c_ulonglong * (n_slots + 1))()
    lib = libs["split"]
    use("split")
    for label, args, rounds, iters in shapes:
        check(lib.pose_solve_split(counters) == 0, "pose split: reading the counters failed")
        own = own_device_ms(lambda: pose_opt.pose_solve_cuda(*args, rounds, iters), "pose_solve_kernel",
                            pose_opt) * 1e3
        torch.cuda.synchronize()
        check(lib.pose_solve_split(counters) == 0, "pose split: reading the counters failed")
        passes = rounds * (iters + 1) + 1
        n_launch = counters[n_slots] / passes       # own_device_ms's calls, a window taken again included
        cyc = [counters[k] / n_launch for k in range(n_slots)]
        main = cyc[:len(POSE_SPLIT_SLOTS)]
        us_per_cycle = own / sum(main)
        split[label] = {
            "device_us": own, "passes": passes, "sm_mhz": sum(main) / own,
            **{f"{slot}_us_per_pass": c * us_per_cycle / passes for slot, c in zip(POSE_SPLIT_SLOTS, main)},
            # the worker's counters leave out the last gating pass
            **{f"{slot}_us_per_pass": c * us_per_cycle / (passes - 1)
               for slot, c in zip(POSE_WORKER_SLOTS, cyc[len(POSE_SPLIT_SLOTS):])}}
    for label, *_ in shapes:
        row = split[label]
        print(f"pose split, {label}: own device us " + ", ".join(
            f"{n} {' / '.join(f'{v:.1f}' for v in times[label][n])}" for n in times[label]))
        print(f"pose split, {label}: {row['passes']:.0f} passes, us per pass "
              + ", ".join(f"{slot} {row[f'{slot}_us_per_pass']:.3f}" for slot in (*POSE_SPLIT_SLOTS, *POSE_WORKER_SLOTS))
              + f" (split build {row['device_us']:.1f} us, {row['sm_mhz']:.0f} MHz)")
    print(json.dumps({"pose_split": {"device_us": times, "split": split}}), flush=True)


def build_pose_solve(name, source, flags=()):
    """nvcc on a pose-solve source (another tree's, or a variant) into
    csrc/build/libpose_solve_<name>.so, started now; returns (process,
    library path)."""
    from orb_line_slam_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / f"libpose_solve_{name}.so"
    cmd = [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xptxas", "-v", *flags,
           "-shared", "-Xcompiler", "-fPIC", "-o", str(out), source]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), out


def load_pose_solve(name, proc, out):
    """Wait for build_pose_solve's nvcc; returns the library (its
    pose_solve_launch typed as the wrapper calls it) and ptxas' report."""
    import ctypes

    from orb_line_slam_tpu_torch.backend import pose_opt

    stdout, stderr = proc.communicate()
    check(proc.returncode == 0, f"nvcc failed on the {name} build of pose_solve:\n{stderr[-3000:]}")
    lib = ctypes.CDLL(str(out))
    lib.pose_solve_launch.argtypes = [*pose_opt._ARGTYPES, ctypes.c_void_p]
    lib.pose_solve_launch.restype = ctypes.c_int
    usage = [ln.split(":", 1)[-1].strip() for ln in (stdout + stderr).splitlines() if "Used" in ln or "spill" in ln]
    return lib, "; ".join(usage)


class PlainAudit:
    """While entered, every launch of the pose-solve kernel is also run
    through the plain version on the same inputs, and the two compared
    (rows of ``self.rows``)."""

    def __init__(self):
        self.rows = []

    def __enter__(self):
        import torch

        from orb_line_slam_tpu_torch.backend import pose_opt

        kernel = pose_opt.pose_solve_cuda

        def audited(*a):
            got = kernel(*a)
            args, rounds, iters = a[:16], a[16], a[17]
            batched = args[0].dim() == 3
            for b in range(args[0].shape[0] if batched else 1):
                one = [x[b] for x in args[:11]] if batched else list(args[:11])
                k = [x[b] for x in got] if batched else list(got)
                p = pose_opt.pose_solve_plain(*one, *args[11:], rounds, iters)
                centre = [-(x[0].T @ x[1]).double().cpu().numpy() for x in (k, p)]
                self.rows.append({"rounds": rounds, "rad": rotation_gap(k[0].cpu().numpy()[None],
                                                                        p[0].cpu().numpy()[None]),
                                  "centre_mm": float(1e3 * np.linalg.norm(centre[0] - centre[1])),
                                  "inliers_gap": abs(int(k[4]) - int(p[4])),
                                  "masks_agree": float((k[2] == p[2]).float().mean()),
                                  "decisions_differing": int((k[5] != p[5]).sum())})
            return got

        self.kernel = kernel
        torch.library.register_kernel("orb_line_slam::pose_solve", "cuda", audited)
        return self

    def __exit__(self, *exc):
        import torch

        torch.library.register_kernel("orb_line_slam::pose_solve", "cuda", self.kernel)

    def summary(self):
        r = self.rows
        return {"solves": len(r), "max_centre_mm": max(x["centre_mm"] for x in r),
                "median_centre_mm": float(np.median([x["centre_mm"] for x in r])),
                "max_rad": max(x["rad"] for x in r), "max_inliers_gap": max(x["inliers_gap"] for x in r),
                "min_masks_agree": min(x["masks_agree"] for x in r),
                "solves_with_a_differing_decision": sum(x["decisions_differing"] > 0 for x in r)}


def solver_probe(parent, variants):
    """``python3 chip_smoke.py --solver-probe DIR [VARIANT.cu ...]``: the
    pinned phases 5 and 10 (loop closing on and off) and the shipping
    phase 11 (a), driven with each pose solver in turn: this checkout's
    kernel, DIR's kernel (an unpacked parent commit), the plain version on
    the card, and a kernel built from each VARIANT source.  Prints their
    ATEs beside the bounds and checks of phases 10 and 11 (a), and the
    keyframes' frames of 11 (a); with this kernel, every solve of phase
    11 (a) is also run through the plain version on its inputs and the
    two compared (PlainAudit).  The schedules are deterministic, so each
    run stands for every run of its solver."""
    sys.path.insert(0, ROOT)
    cfg, ccfg = kitti_config(), loop_config()
    jobs = [sequence_job(cfg, N_FRAMES), loop_job(ccfg)]
    frames, cframes = render_jobs(jobs, min(8, os.cpu_count() or 1))
    poses, cposes = jobs[0][1], jobs[1][1]
    phase_device()
    import orb_line_slam_tpu_torch  # noqa: F401  (sets the fp32 policy)
    from orb_line_slam_tpu_torch.backend import pose_opt
    from orb_line_slam_tpu_torch.ops import _build
    from orb_line_slam_tpu_torch.pipeline import track_step, tracking

    _build.build()
    sources = {"parent": os.path.join(os.path.abspath(parent), "orb_line_slam_tpu_torch", "csrc", "pose_solve.cu")}
    sources.update({os.path.splitext(os.path.basename(v))[0]: os.path.abspath(v) for v in variants})
    started = {name: build_pose_solve(name, src) for name, src in sources.items()}
    fns = {"this": _build.kernel("pose_solve", pose_opt._ARGTYPES)}
    fns.update({name: load_pose_solve(name, *job)[0].pose_solve_launch for name, job in started.items()})
    rows = {}
    for solver in ("this", "parent", "plain", *(n for n in fns if n not in ("this", "parent"))):
        _build._FUNCTIONS["pose_solve"] = fns.get(solver, fns["this"])
        saved = track_step.pose_optimize, tracking.pose_optimize
        if solver == "plain":
            track_step.pose_optimize = tracking.pose_optimize = pose_opt.pose_optimize_reference
        try:
            *_, ate5, _ = run_slice(cfg, poses, frames, f"solver probe {solver}: slice", 0.1, check_launches=False)
            *_, on, _ = run_slice(ccfg, cposes, cframes, f"solver probe {solver}: loop slice", 0.1,
                                  use_loop_closing=True, check_launches=False)
            *_, off, _ = run_slice(ccfg, cposes, cframes, f"solver probe {solver}: loop slice, loop closing off",
                                   0.1, check_launches=False)
            audit = PlainAudit() if solver == "this" else None
            if audit is not None:
                audit.__enter__()
            try:
                slam, *_, ate11, _ = run_slice(bench_pipeline_config(), poses, frames,
                                               f"solver probe {solver}: shipping pipeline", 0.1, use_loop_closing=True,
                                               shipping=True, warmup=12, check_launches=False)
            finally:
                if audit is not None:
                    audit.__exit__()
        finally:
            track_step.pose_optimize, tracking.pose_optimize = saved
        tr = slam.tracker
        bound11 = max(1.25 * ate5, ate5 + 0.02)
        rows[solver] = {"ate_rmse_synth_m": ate5, "ate_rmse_loop_m": on, "ate_synth_noloop_m": off,
                        "phase_10_holds": on <= 1.1 * JAX_CPU_REFERENCE_ATE_LOOP_M + 0.01 and on < off,
                        "ate_rmse_pipeline_m": ate11, "phase_11a_bound_m": bound11, "phase_11a_holds": ate11 <= bound11,
                        "phase_11a_kf_frames": [int(f) for f in tr.map.kf_frame_id[tr.map.kf_valid]]}
        if audit is not None:
            rows[solver]["phase_11a_audit"] = audit.summary()
        print(f"solver probe {solver}: " + json.dumps(rows[solver]), flush=True)
    print(json.dumps({"solver_probe": rows}), flush=True)


SCHEDULE_REPLAY_ABOVE_M = 0.02    # --schedule-probe replays the first B = 2 run above this


def replay_steps(kept, poses):
    """Each kept batched step's sequence 0 through the unbatched
    track_step with the plain pose solve: the gap to the batched kernel's
    pose, and the camera-centre error of the kernel's pose and of the
    plain replay's three solves (path A, path B, final; seed and result)
    against the true pose, with the final solve's inliers' median
    reprojection error at the true pose."""
    from orb_line_slam_tpu_torch.backend.pose_opt import pose_optimize_reference
    from orb_line_slam_tpu_torch.parallel.multi_sequence import _take
    from orb_line_slam_tpu_torch.pipeline import track_step as step_mod

    rows = []
    for fid, frames, lfs, outs, stacked, cfg, has_lines in kept:
        last_frame, mir, *rest = stacked
        carry, table = rest[:15], rest[15:]
        Rg, tg = (np.asarray(x, np.float64) for x in poses[fid])
        true_c = -Rg.T @ tg
        calls = []

        def recorded(*a, **k):
            res = pose_optimize_reference(*a, **k)
            calls.append((a, res))
            return res

        saved = step_mod.pose_optimize
        step_mod.pose_optimize = recorded
        try:
            want = step_mod.track_step(_take(frames, 0), _take(last_frame, 0), _take(mir, 0),
                                       *(x[0] for x in carry), _take(lfs, 0) if has_lines else None,
                                       *(x[0] for x in table), cfg=cfg, has_lines=has_lines)
        finally:
            step_mod.pose_optimize = saved

        def centre(R, t):
            R, t = R.detach().cpu().double().numpy(), t.detach().cpu().double().numpy()
            return -R.T @ t

        got = _take(outs, 0)
        err = lambda c: float(1e3 * np.linalg.norm(c - true_c))  # noqa: E731
        row = {"frame": int(fid), "kernel_vs_plain_mm": float(1e3 * np.linalg.norm(
            centre(got.R, got.t) - centre(want.R, want.t))), "kernel_err_mm": err(centre(got.R, got.t))}
        for stage, (a, res) in zip(("A", "B", "final"), calls):
            row[stage] = {"seed_err_mm": err(centre(a[0], a[1])), "err_mm": err(centre(res.R, res.t)),
                          "inliers": int(res.n_inliers)}
        a, res = calls[-1]
        inl = (res.inliers & a[5]).cpu().numpy()
        pts, obs = a[2].detach().cpu().double().numpy()[inl], a[3].detach().cpu().double().numpy()[inl]
        xc = pts @ Rg.T + tg
        cam = cfg.camera
        px = np.hypot(cam.fx * xc[:, 0] / xc[:, 2] + cam.cx - obs[:, 0],
                      cam.fy * xc[:, 1] / xc[:, 2] + cam.cy - obs[:, 1])
        row["final"]["true_pose_px_median"] = float(np.median(px)) if len(px) else None
        rows.append(row)
    return rows


def schedule_probe(tree, n_runs, out_path):
    """``python3 chip_smoke.py --schedule-probe DIR N OUT``: how the
    shipping schedule repeats, through the package of the tree at DIR
    (``.`` for this checkout).  Phase 11 (a)'s run and phase 14 (a)'s
    B = 2 run, N times each, without their checks: per run the ATEs, the
    keyframes' frames and each deferred local BA's lag.  The first B = 2
    run whose sequence 0 reads above SCHEDULE_REPLAY_ABOVE_M is replayed
    (``replay_steps``), where the tree has ``pose_optimize_reference``.
    Writes the records to OUT as JSON and prints a summary."""
    import torch

    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    cfg = kitti_config()
    job = sequence_job(cfg, N_FRAMES)
    (frames,) = render_jobs([job], min(8, os.cpu_count() or 1))
    poses = job[1]
    phase_device()
    import orb_line_slam_tpu_torch
    from orb_line_slam_tpu_torch.backend import pose_opt
    from orb_line_slam_tpu_torch.ops import _build
    from orb_line_slam_tpu_torch.parallel import multi_sequence
    from orb_line_slam_tpu_torch.parallel.multi_sequence import MultiSequenceTracker

    pkg = os.path.dirname(os.path.abspath(orb_line_slam_tpu_torch.__file__))
    check(pkg == os.path.join(tree, "orb_line_slam_tpu_torch"), f"--schedule-probe {tree} imported {pkg}")
    _build.build()
    out = {"tree": tree, "ship": [], "multiseq": [], "replay": None}
    for run in range(n_runs):
        slam, _, fps, ate, _ = run_slice(bench_pipeline_config(), poses, frames, "shipping pipeline", 0.1,
                                         use_loop_closing=True, shipping=True, warmup=12, check_launches=False)
        tr = slam.tracker
        out["ship"].append({"ate_m": ate, "fps": fps, "lags": [int(g) for g in tr.ba_lag_frames],
                            "kf_frames": [int(f) for f in tr.map.kf_frame_id[tr.map.kf_valid]]})
        print(f"schedule probe {tree}: phase 11 (a) run {run}: ATE {ate:.5f} m, {fps:.2f} frames/s, lags "
              f"{out['ship'][-1]['lags']}", flush=True)
    n = MULTISEQ_PAIR_FRAMES
    seqs, gts = [frames[:n], frames[::-1][:n]], [poses[:n], poses[::-1][:n]]
    batched_fn = multi_sequence.batched_frame_track
    kept = []
    for run in range(n_runs):
        mst = MultiSequenceTracker(bench_pipeline_config(), 2, device="cuda")

        def keeping(left, right, stacked, cfg_, has_lines, mst=mst):
            frames_b, lfs, outs = batched_fn(left, right, stacked, cfg_, has_lines)
            kept.append((mst.trackers[0].frame_id, frames_b, lfs, outs, stacked, cfg_, has_lines))
            return frames_b, lfs, outs

        multi_sequence.batched_frame_track = keeping
        try:
            t0 = time.perf_counter()
            for i in range(n):
                mst.process_stereo([s[i][0] for s in seqs], [s[i][1] for s in seqs], [0.1 * i] * 2)
                torch.cuda.current_stream().synchronize()
            seconds = time.perf_counter() - t0
            mst.shutdown()
        finally:
            multi_sequence.batched_frame_track = batched_fn
        ates = [sequence_ate(t, gt) for t, gt in zip(mst.trackers, gts)]
        out["multiseq"].append({"ate_m": ates, "seconds": seconds, "batched": mst.n_batched_frames,
                                "lags": [[int(g) for g in t.ba_lag_frames] for t in mst.trackers],
                                "kf_frames": [[int(f) for f in t.map.kf_frame_id[t.map.kf_valid]]
                                              for t in mst.trackers]})
        print(f"schedule probe {tree}: phase 14 (a) run {run}: ATE {ates[0]:.5f} / {ates[1]:.5f} m in "
              f"{seconds:.1f} s, keyframes {out['multiseq'][-1]['kf_frames'][0]}, lags "
              f"{out['multiseq'][-1]['lags'][0]}", flush=True)
        if out["replay"] is None and ates[0] > SCHEDULE_REPLAY_ABOVE_M and hasattr(pose_opt, "pose_optimize_reference"):
            out["replay"] = {"run": run, "steps": replay_steps(kept, gts[0])}
            for row in out["replay"]["steps"]:
                print(f"schedule probe replay, frame {row['frame']}: kernel {row['kernel_err_mm']:.1f} mm from the "
                      f"true pose, {row['kernel_vs_plain_mm']:.3f} mm from the plain solve; plain path B seed "
                      f"{row['B']['seed_err_mm']:.1f} -> {row['B']['err_mm']:.1f} mm, final "
                      f"{row['final']['err_mm']:.1f} mm with {row['final']['inliers']} inliers, median "
                      f"{row['final']['true_pose_px_median'] or float('nan'):.2f} px from the true pose", flush=True)
        kept.clear()
    summary = {"ship_ate_m": sorted({round(r["ate_m"], 5) for r in out["ship"]}),
               "multiseq_seq0_ate_m": [round(r["ate_m"][0], 5) for r in out["multiseq"]],
               "multiseq_seq1_ate_m": [round(r["ate_m"][1], 5) for r in out["multiseq"]],
               "max_lag": max((g for r in out["multiseq"] for lag in r["lags"] for g in lag), default=0)}
    out["summary"] = summary
    print(json.dumps({"schedule_probe": summary}), flush=True)
    with open(out_path, "w") as f:
        json.dump(out, f)


# (module, function, range name): the stages a profile range is opened
# around.  Nested ranges (the pose solves and the line search inside the
# tracking step, the segment sums inside the joint BA) count inside their
# parents too.
PROFILE_RANGES = (
    ("pipeline.tracking", "build_stereo_frame", "point_frontend"),
    ("pipeline.tracking", "build_line_features", "line_frontend"),
    ("pipeline.tracking", "track_step", "track_step"),
    ("pipeline.track_step", "search_lines_by_projection", "line_search"),
    ("pipeline.track_step", "pose_optimize", "pose_solves"),
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


class ProfileWindow:
    """A torch.profiler window over PROFILE_FRAMES frames of a slice run,
    from frame `start`, with the PROFILE_RANGES stages labelled:
    ``run_slice(..., window=ProfileWindow(...))`` profiles its own run, so
    no second run repeats the frames before the window.  The window's
    frames are left out of the run's frames/s and per-frame times.  A
    window that comes back without device records is taken again over
    the next frames, at most MAX_RETAKES times.  Device time per range is
    the sum of the device kernels that start inside the range's device
    interval."""

    def __init__(self, cell, start=PROFILE_START):
        self.cell, self.start, self.n = cell, start, PROFILE_FRAMES
        self.frames, self.prof, self.wall_ms, self._open = set(), None, 0.0, None

    def before(self, i):
        """Called before frame i is tracked: opens the window at its start."""
        import contextlib

        import torch
        from torch.profiler import ProfilerActivity, profile

        if self.prof is None and self._open is None and i == self.start:
            torch.cuda.synchronize()
            self._open = contextlib.ExitStack()
            self._open.enter_context(labelled_ranges(PROFILE_RANGES))
            self._prof = self._open.enter_context(profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
            self.wall_ms = 0.0
        if self._open is not None:
            self.frames.add(i)

    def after(self, i, frame_ms):
        """Called after frame i (its host ms): closes the window at its end."""
        global profile_retakes
        import torch

        if self._open is None:
            return
        self.wall_ms += frame_ms
        if i < self.start + self.n - 1:
            return
        torch.cuda.synchronize()
        self._open.close()
        self._open = None
        n = len(device_records(self._prof))
        if n > 0:
            self.prof = self._prof
            return
        profile_retakes += 1
        check(profile_retakes <= MAX_RETAKES, f"profiler: no complete window of the {self.cell}")
        print(f"profile of frames {self.start}-{i} of the {self.cell} came back with {n} device records: "
              f"taken again", flush=True)
        self.start = i + 1

    def report(self):
        check(self.prof is not None, f"profile: the {self.cell} ended before a complete window")
        n, start, prof = self.n, self.start, self.prof
        tags = [tag for _, _, tag in PROFILE_RANGES]
        kern, stage = range_device_times(prof, tags)
        busy_us = sum(e.end - e.start for e in kern)
        per = {k: v[0] for k, v in stage.items()}
        calls = {k: v[2] for k, v in stage.items()}
        check(busy_us > 0 and any(calls.values()), "profile: no device kernels or no device ranges recorded")
        by_name, by_stream = {}, {}
        for e in kern:
            d = by_name.setdefault(e.name, [0.0, 0])
            d[0] += e.end - e.start
            d[1] += 1
            by_stream[str(e.stream)] = by_stream.get(str(e.stream), 0) + 1
        print(json.dumps({"profile": {
            "cell": self.cell, "frames": f"{start}-{start + n - 1}", "wall_ms_per_frame_profiled": self.wall_ms / n,
            "device_busy_ms_per_frame": busy_us / 1e3 / n, "kernels_per_frame": len(kern) / n,
            "kernel_launch_calls_per_frame": prof.launch_calls / n,
            "device_idle_share_profiled": 1 - busy_us / 1e3 / self.wall_ms,
            "kernels_per_frame_by_stream": {k: v / n for k, v in by_stream.items()},
            "range_device_ms_per_frame": {k: v / 1e3 / n for k, v in per.items()},
            "range_kernels_per_frame": {k: v[1] / n for k, v in stage.items()},
            "range_device_ms_per_call": {k: (per[k] / 1e3 / calls[k] if calls[k] else None) for k in tags},
            "range_calls": calls,
            "range_share_of_busy": {k: v / busy_us for k, v in per.items()},
        }}))
        for name, (d, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
            print(f"profile top kernel ({self.cell}): {d / 1e3 / n:8.3f} ms/frame {c / n:8.1f} calls/frame  {name[:110]}")
        print(f"profile ({self.cell}): the tracking step launches {stage['track_step'][1] / n:.1f} device kernels per "
              f"frame ({stage['track_step'][0] / 1e3 / n:.2f} device ms), its pose solves "
              f"{stage['pose_solves'][1] / n:.1f} ({stage['pose_solves'][0] / 1e3 / n:.2f} device ms), of "
              f"{len(kern) / n:.1f} kernels per frame in all")
        self.summary = {"kernels_per_frame": len(kern) / n, "device_busy_ms_per_frame": busy_us / 1e3 / n,
                "track_step_kernels_per_frame": stage["track_step"][1] / n,
                "track_step_device_ms_per_frame": stage["track_step"][0] / 1e3 / n,
                "pose_solve_kernels_per_frame": stage["pose_solves"][1] / n,
                "pose_solve_device_ms_per_frame": stage["pose_solves"][0] / 1e3 / n}
        return self.summary


def main():
    if not os.path.isdir(os.path.join(ROOT, "orb_line_slam_tpu_torch")):
        fail("orb_line_slam_tpu_torch/ not found beside chip_smoke.py: run from a checkout of the repo")
    sys.path.insert(0, ROOT)
    import torch

    t_start = time.perf_counter()

    def done(phase):
        print(f"[{time.perf_counter() - t_start:6.1f} s] {phase} done", flush=True)

    # Every sequence's frames, rendered by forked workers while this
    # process has no thread and has not touched the card.
    cfg, lcfg, ccfg, tcfg = kitti_config(), euroc_config(), loop_config(), tum_config()
    jobs = [sequence_job(cfg, N_FRAMES), *tum_jobs(tcfg, N_FRAMES),
            sequence_job(lcfg, N_FRAMES, LINE_SCENE, LINE_STEP), loop_job(ccfg), loop_job(ccfg, MONO_LOOP_CLOSING_DRAW)]
    check(threading.active_count() == 1, "a thread runs before the render workers are forked")
    n_proc = min(8, os.cpu_count() or 1)
    frames, mframes, rframes, lframes, cframes, closing_frames = render_jobs(jobs, n_proc)
    poses, mposes, rposes, lposes, cposes, _ = (job[1] for job in jobs)
    print(f"rendered {len(frames)} KITTI-size stereo pairs, {len(mframes)} TUM-size mono images and {len(rframes)} "
          f"RGB-D pairs, {len(lframes)} EuRoC-size stereo pairs with lines and {len(cframes)} stereo pairs of the loop "
          f"circuit under each of two sensor-noise draws in {time.perf_counter() - t_start:.1f} s ({n_proc} processes; host, set-up)")
    phase_device()
    import orb_line_slam_tpu_torch  # noqa: F401  (sets the fp32 policy)

    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
          "TF32 is enabled")
    phase_build()
    metrics, launches = {}, {}
    cells = (("point cell", cfg), ("point+line cell", lcfg), ("loop cell", ccfg))
    kern = {"patch_tiles": phase_kernel(cells)}
    kern["orb_describe"], kern["stereo_sad"] = phase_fused_kernels(cells, (("TUM cell", tcfg),))
    pairs = MULTISEQ_KERNEL_PAIRS
    kern["orb_detect"] = phase_detect([
        ("point cell", cfg, np.stack(frames[0])), ("point+line cell", lcfg, np.stack(lframes[0])),
        ("TUM cell", tcfg, mframes[0][None]),
        (f"point cell, {pairs} pairs", cfg, np.stack([f[0] for f in frames[:pairs]] + [f[1] for f in frames[:pairs]])),
    ])
    kern["pose_solve"] = phase_pose_solve(pose_cells())
    done("phases 1-3")
    metrics["stereo_frontend_fps"] = phase_frame(cfg, frames[0])
    phase_stereo_match_kernel_vs_plain(cfg, frames[0])
    add_launches(launches, phase_single_image(cfg, frames))
    tum_ms = phase_mono_rgbd_frames(tcfg, *rframes[0])
    metrics["mono_frontend_ms"], metrics["rgbd_frontend_ms"] = tum_ms["mono"], tum_ms["rgbd"]
    metrics["local_ba_iter_ms"] = phase_bench_ba(cfg)
    n, metrics["points_pipeline_fps"], metrics["local_ba_ms_per_solve"], metrics["ate_rmse_synth_m"] = \
        phase_slice(cfg, poses, frames)
    add_launches(launches, n)
    done("phases 4-5")
    metrics["line_frontend_ms"] = phase_line_frame(lcfg, lframes[0])
    n, metrics["lines_pipeline_fps"], metrics["joint_ba_ms_per_solve"], metrics["ate_rmse_lines_m"] = \
        phase_line_slice(lcfg, lposes, lframes)
    add_launches(launches, n)
    done("phases 6-8")
    from orb_line_slam_tpu_torch.frontend.frame import build_stereo_frame

    frame = build_stereo_frame(*(torch.from_numpy(x).cuda() for x in frames[0]), cfg)
    metrics["bow_descent_ms"] = phase_loop_words(frame)
    metrics["sim3_ransac_ms"], metrics["sim3_refine_ms"] = phase_loop_sim3(ccfg.camera)
    metrics["pose_graph_ms_per_solve"] = phase_loop_pose_graph()
    metrics["gba_cg_ms_per_solve"], gba_capacity = phase_loop_gba_cg(cfg.camera)
    host_probe("after the loop components")
    done("phase 9")
    n, metrics["loop_pipeline_fps"], metrics["ate_rmse_loop_m"], loop_slam = phase_loop_slice(ccfg, cposes, cframes)
    add_launches(launches, n)
    done("phase 10")
    n, metrics["full_pipeline_fps"], metrics["full_pipeline_frame_host_ms"], metrics["ate_rmse_pipeline_m"] = \
        phase_shipping_pipeline(poses, frames, metrics["ate_rmse_synth_m"])
    add_launches(launches, n)
    n, metrics["ship_loop_pipeline_fps"], metrics["ship_loop_frame_host_ms"], metrics["ate_rmse_ship_m"], \
        metrics["ate_ship_loops"] = phase_shipping_circuit(cposes, cframes, metrics["ate_rmse_loop_m"])
    add_launches(launches, n)
    done("phase 11")
    n, metrics["mono_pipeline_fps"], metrics["mono_frame_host_ms"], metrics["ate_rmse_mono_m"] = \
        phase_mono_slice(tcfg, mposes, mframes)
    add_launches(launches, n)
    n, metrics["rgbd_pipeline_fps"], metrics["rgbd_frame_host_ms"], metrics["ate_rmse_rgbd_m"] = \
        phase_rgbd_slice(tcfg, rposes, rframes)
    add_launches(launches, n)
    done("phases 12-13")
    n, metrics["multiseq_ate_m"], row2 = phase_multiseq_correctness(poses, frames, metrics["ate_rmse_pipeline_m"])
    add_launches(launches, n)
    n, scaling = phase_multiseq_scaling(frames, {2: row2})
    add_launches(launches, n)
    metrics["multiseq_aggregate_fps"] = {b: row["multiseq_aggregate_fps"] for b, row in scaling.items()}
    metrics["multiseq_batched_step_host_ms"] = {b: row["batched_step_host_ms"] for b, row in scaling.items()}
    done("phase 14")
    metrics["distributed_ba"] = phase_distributed(cfg.camera, gba_capacity, loop_slam)
    done("phase 15")
    n, metrics["endurance"] = phase_endurance(loop_slam)
    add_launches(launches, n)
    done("phase 16")
    n, mono_loop = phase_mono_loop(ccfg, cposes, cframes, closing_frames)
    add_launches(launches, n)
    metrics.update({k: mono_loop[k] for k in ("mono_loop_pipeline_fps", "ate_rmse_mono_loop_m", "ate_mono_loops",
                                              "mono_loop_scale", "mono_loop_tracked_frames", "mono_fixture_scale")})
    done("phase 17")
    print(json.dumps(metrics))
    print(json.dumps({"profiler_windows_taken_again": profile_retakes, "at_most_per_window": MAX_RETAKES}))
    # launches: orb_describe and stereo_sad over the slices' stereo frames
    # (phases 5, 7, 10 and 11), the multi-sequence steps (phase 14) and
    # the endurance run (phase 16),
    # orb_describe over the mono and RGB-D frames (phases 12, 13 and 17),
    # patch_tiles over the single-image path with tiles (phase 4),
    # orb_detect over every frame, step and image of those paths,
    # pose_solve over every tracking step and relocalization of phases 5,
    # 7, 10-14, 16 and 17, each read just after its path with the counts set
    # to 0 just before it.
    check(all(launches.get(name, 0) > 0 for name in KERNELS), f"a kernel was never launched on its path: {launches}")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"orb_line_slam_tpu_torch/csrc/{name}.cu",
        "replaces": REPLACES[name],
        "launches": launches[name], **kern[name],
    } for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    if sys.argv[1:] == ["--endurance-long"]:
        sys.path.insert(0, ROOT)
        endurance_long()
    elif sys.argv[1:2] == ["--compare-parent"] and len(sys.argv) == 3:
        compare_parent(sys.argv[2])
    elif sys.argv[1:] == ["--front-end-split"]:
        sys.path.insert(0, ROOT)
        front_end_split()
    elif sys.argv[1:2] == ["--tree-probe"] and len(sys.argv) == 4:
        tree_probe(sys.argv[2], sys.argv[3])
    elif sys.argv[1:2] == ["--schedule-probe"] and len(sys.argv) == 5:
        schedule_probe(sys.argv[2], int(sys.argv[3]), sys.argv[4])
    elif sys.argv[1:2] == ["--pose-split"] and len(sys.argv) in (2, 3):
        pose_split(sys.argv[2] if len(sys.argv) == 3 else None)
    elif sys.argv[1:2] == ["--mono-loop-draws"] and len(sys.argv) == 3:
        sys.path.insert(0, ROOT)
        mono_loop_draws([int(d) for d in sys.argv[2].split(",")])
    elif sys.argv[1:2] == ["--solver-probe"] and len(sys.argv) >= 3:
        solver_probe(sys.argv[2], sys.argv[3:])
    else:
        main()
