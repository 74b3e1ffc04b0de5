"""The stereo point+line slice as a whole: the JAX System and the port's
System on the CPU, lines on, on the pinned schedule (loop closing off,
pipeline depth 0, synchronous mapping), on the same frames rendered once
by the port's renderer."""

import numpy as np
import torch

from orb_line_slam_tpu.config import LineConfig, MapConfig, OrbConfig, SlamConfig
from orb_line_slam_tpu.geometry.camera import CameraIntrinsics
from orb_line_slam_tpu.pipeline.system import System as JaxSystem
from orb_line_slam_tpu_torch.convert import config_from_jax
from orb_line_slam_tpu_torch.data.synthetic import SyntheticScene, circular_trajectory
from orb_line_slam_tpu_torch.eval.trajectory import ate_rmse
from orb_line_slam_tpu_torch.pipeline.system import System

torch.set_num_threads(1)

# The configuration of tests/test_tracking_with_lines.py:12-21.
CAM = CameraIntrinsics(fx=400.0, fy=400.0, cx=320.0, cy=160.0, bf=160.0, width=640, height=320)
CFG = SlamConfig(
    camera=CAM,
    orb=OrbConfig(n_features=768, n_levels=4),
    lines=LineConfig(enabled=True, n_lines=64),
    map=MapConfig(max_keyframes=64, max_points=8192, max_lines=512, local_window=8, local_points=2048),
)
N_FRAMES = 12


def _centres(traj):
    return np.stack([-R.T @ t for (_, _, R, t, _) in traj])


def test_point_line_slice_matches_jax_system():
    """Both OK; keyframe counts within 1; >= 5 map lines each; per-frame
    camera centres within 2 cm; the port's ATE within 10% + 5 mm of
    JAX's; the port ran a joint point+line BA with line observations and
    used line inliers in its pose solves."""
    scene = SyntheticScene(CFG.camera, n_points=500, n_lines=40, seed=9, extent=((-14, 14), (-6, 6), (6, 60)))
    poses = circular_trajectory(N_FRAMES, step=0.3)
    frames = [scene.render_stereo(R, t) for R, t in poses]
    gt = np.stack([-R.T @ t for (R, t) in poses])

    jsys = JaxSystem(CFG, use_loop_closing=False, async_loop=False)
    jsys.tracker.async_mapping = False
    jsys.tracker.pipeline_depth = 0
    tsys = System(config_from_jax(CFG), use_loop_closing=False, device="cpu")
    for i, (l, r) in enumerate(frames):
        jsys.track_stereo(l, r, timestamp=0.1 * i)
        tsys.track_stereo(l, r, timestamp=0.1 * i)
    jsys.shutdown()
    tsys.shutdown()

    assert jsys.tracking_state() == "OK" and tsys.tracking_state() == "OK"
    assert abs(jsys.map.n_keyframes() - tsys.map.n_keyframes()) <= 1
    assert jsys.map.ln_valid.sum() >= 5 and tsys.map.ln_valid.sum() >= 5
    cj, ct = _centres(jsys.tracker.final_trajectory()), _centres(tsys.tracker.final_trajectory())
    assert np.linalg.norm(ct - cj, axis=1).max() < 0.02
    ate_j, ate_t = ate_rmse(cj, gt, align=True), ate_rmse(ct, gt, align=True)
    assert abs(ate_t - ate_j) <= 0.1 * ate_j + 0.005, (ate_t, ate_j)
    tr = tsys.tracker
    assert len(tr.joint_ba_lobs) >= 1 and min(tr.joint_ba_lobs) >= 1
    assert sum(s["line_inliers"] > 0 for s in tr.stats) >= 0.5 * len(tr.stats)
