"""Long-horizon endurance run: the full-sequence validation proxy.

Port of ``orb_line_slam_tpu/eval/endurance.py:27-143``: the same
signature, defaults, scene, trajectory, noise frames, ``MapConfig``,
schedule flags and returned keys, plus the keyword-only ``device``
(the CUDA card unless the caller asks for the CPU).

The reference validates on full KITTI/EuRoC sequences (KITTI 00 is 4,541
frames with several genuine loop closures).  With no dataset at hand,
this drives the same machinery over a long synthetic circuit:

- laps > 2 of a closed circuit give >= 2 genuine revisits through the
  starting keyframes (several loop-closure stimuli);
- the map grows through keyframe and landmark culling and slot reuse
  under capacity pressure (the ``MapConfig`` caps sit far below
  frames / 10);
- a burst of pure-noise frames mid-run forces LOST and exercises the
  BoW/EPnP relocalization ladder (keyframe-database candidates, then
  ``Tracker._relocalize``);
- frames/s is recorded over windows, the host's peak RSS at the end.

``ate_long_recovered_at`` is the first frame after the dropout whose
``tracking_state()`` reads OK.  The JAX ``System`` sets
``tracker.pipeline_depth = 2`` and ``run_endurance`` keeps it, so the
JAX state is that of the frame consumed two frames earlier and its
``recovered_at`` reads two frames later than the port's, which has no
depth-2 pipelining: the same recovery gives the port's value = JAX's - 2.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def run_endurance(
    n_frames: int = 1500,
    radius: float = 8.0,
    laps: float = 2.3,
    loss_at: float = 0.62,
    loss_frames: int = 4,
    lines: bool = True,
    seed: int = 5,
    fps_window: int = 100,
    use_loop_closing: bool = True,
    shipping: bool = False,
    *,
    device: str | torch.device = "cuda",
) -> dict:
    """Run the full System over a long revisiting circuit; returns a
    metrics dict (ate, loops, relocalization, fps-over-time, memory)."""
    from ..config import CameraIntrinsics, LineConfig, MapConfig, OrbConfig, SlamConfig
    from ..data.synthetic import SyntheticScene, loop_circuit_trajectory
    from ..eval.trajectory import ate_rmse
    from ..pipeline.system import System

    vcam = CameraIntrinsics(
        fx=320.0, fy=320.0, cx=320.0, cy=160.0, bf=160.0,
        width=640, height=320,
    )
    # Capacity pressure by design: ~n_frames/6 keyframe events against a
    # 96-slot table forces culling + slot reuse; 12288 points likewise.
    cfg = SlamConfig(
        camera=vcam, orb=OrbConfig(n_features=1000, n_levels=4),
        lines=LineConfig(enabled=lines, n_lines=64),
        map=MapConfig(max_keyframes=96, max_points=12288, max_lines=1024,
                      local_window=8, local_points=4096),
    )
    poses = loop_circuit_trajectory(n_frames, radius=radius, laps=laps)
    scene = SyntheticScene(
        vcam, n_points=1600, seed=seed, extent=((-24, 40), (-4, 4), (-32, 32))
    )
    scene.noise_sigma = 6.0
    rng = np.random.default_rng(seed + 1)

    # shipping=True runs the System as the drivers do (the loop-detection
    # worker and asynchronous global BA): the fps windows then measure
    # sustained throughput, where the pinned schedule's synchronous loop
    # corrections (Sim3, CorrectLoop and global BA on the tracking
    # thread) stall their window.  Tests pin shipping=False.
    sysm = System(cfg, use_loop_closing=use_loop_closing,
                  async_loop=shipping, device=device)
    if not shipping:
        sysm.gba_async = False

    loss_start = int(n_frames * loss_at)
    lost_frames = []
    recovered_at = None
    fps_windows = []
    t_win = time.perf_counter()
    track_time = 0.0
    for i, (R, t) in enumerate(poses):
        if loss_start <= i < loss_start + loss_frames:
            # Sensor dropout: pure noise kills every match.
            l = rng.integers(0, 255, (vcam.height, vcam.width), np.uint8)
            r = rng.integers(0, 255, (vcam.height, vcam.width), np.uint8)
        else:
            l, r = scene.render_stereo(R, t)
        t0 = time.perf_counter()
        sysm.track_stereo(l, r, timestamp=0.1 * i)
        track_time += time.perf_counter() - t0
        state = sysm.tracking_state()
        if state == "LOST":
            lost_frames.append(i)
        elif lost_frames and recovered_at is None and i > loss_start:
            recovered_at = i
        if (i + 1) % fps_window == 0:
            dt = time.perf_counter() - t_win
            fps_windows.append(round(fps_window / dt, 2))
            t_win = time.perf_counter()
    sysm.shutdown()

    # ATE over the non-dropout frames (the noise frames have no ground
    # truth pose to speak of; the reference's evaluators likewise skip
    # untracked frames).
    traj = sysm.tracker.final_trajectory()
    est, gt = [], []
    for (fid, ts, R, t, lost) in traj:
        idx = int(round(ts / 0.1))
        if lost or loss_start <= idx < loss_start + loss_frames:
            continue
        if 0 <= idx < n_frames:
            est.append(-R.T @ t)
            Rg, tg = poses[idx]
            gt.append(-Rg.T @ tg)
    est = np.stack(est)
    gt = np.stack(gt)
    ate = float(ate_rmse(est, gt, align=True))

    try:
        import resource

        peak_rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    except Exception:
        peak_rss_mb = -1.0  # pragma: no cover
    store = sysm.map
    return {
        "ate_long_m": round(ate, 4),
        "ate_long_frames": n_frames,
        "ate_long_path_m": round(2 * np.pi * radius * laps, 1),
        "ate_long_loops": int(sysm.n_loops_closed),
        "ate_long_keyframes": int(store.kf_valid.sum()),
        "ate_long_kf_created": sum(
            1 for s in sysm.tracker.stats if s.get("is_kf")
        ),
        "ate_long_points": int(store.pt_valid.sum()),
        "ate_long_lost_frames": len(lost_frames),
        "ate_long_recovered_at": recovered_at if recovered_at is not None else -1,
        "ate_long_fps_windows": fps_windows,
        "ate_long_track_fps": round((n_frames) / max(track_time, 1e-9), 2),
        "ate_long_peak_rss_mb": round(peak_rss_mb, 1),
    }
