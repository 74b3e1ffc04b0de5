"""The RGB-D path as a whole: the JAX System and the port's on
tests/test_datasets_examples.py::test_rgbd_tracking_synthetic's 6 frames
(slow-marked there; run live here, pinned: synchronous mapping, pipeline
depth 0), the port's default schedule on the same frames, and the port's
copy of the TUM loader on sequence folders the tests write themselves."""

import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from orb_line_slam_tpu.config import LineConfig, MapConfig, OrbConfig, SlamConfig
from orb_line_slam_tpu.geometry.camera import CameraIntrinsics
from orb_line_slam_tpu.pipeline.system import System as JaxSystem
from orb_line_slam_tpu_torch.convert import config_from_jax
from orb_line_slam_tpu_torch.data.synthetic import SyntheticScene
from orb_line_slam_tpu_torch.data.tum import TumMonoSequence, TumRgbdSequence, associate, load_tum_gt
from orb_line_slam_tpu_torch.pipeline.system import System

torch.set_num_threads(1)

# tests/test_datasets_examples.py's camera and configuration.
CAM = CameraIntrinsics(fx=400.0, fy=400.0, cx=320.0, cy=160.0, bf=160.0, width=640, height=320)
CFG = SlamConfig(
    camera=CAM,
    orb=OrbConfig(n_features=768, n_levels=4),
    lines=LineConfig(enabled=False),
    map=MapConfig(max_keyframes=64, max_points=8192, max_lines=64, local_window=8, local_points=2048),
)
TCFG = config_from_jax(CFG)


def _frames():
    scene = SyntheticScene(TCFG.camera, n_points=600, seed=11, extent=((-14, 14), (-6, 6), (6, 60)))
    poses = [(np.eye(3), -np.array([0.0, 0.0, 0.3 * i])) for i in range(6)]
    return poses, [scene.render_rgbd(R, t) for R, t in poses]


def _rot_angle(Ra, Rb):
    d = np.asarray(Ra, np.float64) @ np.asarray(Rb, np.float64).T
    return float(np.arccos(np.clip((np.trace(d) - 1) / 2, -1, 1)))


def _position_rmse(traj, poses):
    errs = [np.linalg.norm(-Rc.T @ tc - (-Rg.T @ tg))
            for (_, _, Rc, tc, lost), (Rg, tg) in zip(traj, poses) if not lost]
    return len(errs), float(np.sqrt(np.mean(np.square(errs))))


def test_rgbd_matches_jax_system():
    """Both reach OK on every frame; per-frame poses within 1e-3 rad and
    5e-3 m of JAX's; the same keyframes; the port's position RMSE below
    0.1 m (the JAX test's bound) on >= 5 tracked frames."""
    poses, frames = _frames()
    js = JaxSystem(CFG, use_loop_closing=False, async_loop=False)
    js.tracker.async_mapping = False
    js.tracker.pipeline_depth = 0
    ts = System(TCFG, use_loop_closing=False, async_loop=False, device="cpu")
    ts.gba_async = False
    ts.tracker.async_mapping = False
    for i, (img, depth) in enumerate(frames):
        js.track_rgbd(img, depth, timestamp=0.1 * i)
        ts.track_rgbd(img, depth, timestamp=0.1 * i)
        assert js.tracking_state() == ts.tracking_state() == "OK"
        assert _rot_angle(ts.tracker.R, js.tracker.R) < 1e-3
        assert np.abs(ts.tracker.t - js.tracker.t).max() < 5e-3
    js.shutdown()
    ts.shutdown()
    assert not ts.tracker.is_mono and ts.map.n_keyframes() == js.map.n_keyframes() >= 2
    for (_, _, Rj, tj, lj), (_, _, Rt, tt, lt) in zip(js.tracker.final_trajectory(), ts.tracker.final_trajectory()):
        assert lj == lt
        assert _rot_angle(Rt, Rj) < 1e-3 and np.abs(tt - tj).max() < 5e-3
    n, rmse = _position_rmse(ts.tracker.final_trajectory(), poses)
    assert n >= 5 and rmse < 0.1


def test_rgbd_on_the_default_schedule():
    """System(cfg) defaults (deferred mapping, workers), loop closing off:
    OK on every frame, every deferred BA applied, RMSE below 0.1 m."""
    poses, frames = _frames()
    s = System(TCFG, use_loop_closing=False, device="cpu")
    try:
        for i, (img, depth) in enumerate(frames):
            s.track_rgbd(img, depth, timestamp=0.1 * i)
            assert s.tracking_state() == "OK"
        s.shutdown()
    finally:
        s.tracker.stop()
    assert s.tracker._pending_ba is None and not s.tracker._map_jobs
    n, rmse = _position_rmse(s.tracker.final_trajectory(), poses)
    assert n == 6 and rmse < 0.1


def _write_tum_sequence(d: Path, frames, factor=5000.0):
    """tests/test_datasets_examples.py's TUM folder writer: rgb/ and depth/
    PNGs (uint16 depth at `factor` per metre, stamps 4 ms late) and the two
    index files."""
    import cv2

    (d / "rgb").mkdir(parents=True)
    (d / "depth").mkdir(parents=True)
    rgb_lines, depth_lines = ["# rgb"], ["# depth"]
    for img, depth, ts in frames:
        rgb_name, dts = f"rgb/{ts:.6f}.png", ts + 0.004
        d_name = f"depth/{dts:.6f}.png"
        cv2.imwrite(str(d / rgb_name), img)
        cv2.imwrite(str(d / d_name), (depth * factor).astype(np.uint16))
        rgb_lines.append(f"{ts:.6f} {rgb_name}")
        depth_lines.append(f"{dts:.6f} {d_name}")
    (d / "rgb.txt").write_text("\n".join(rgb_lines))
    (d / "depth.txt").write_text("\n".join(depth_lines))


def test_tum_rgbd_loader_roundtrip():
    """tests/test_datasets_examples.py::test_tum_rgbd_loader_roundtrip on
    the port's loader: the image back unchanged, depths within the uint16
    quantisation, timestamps associated."""
    pytest.importorskip("cv2")
    scene = SyntheticScene(TCFG.camera, n_points=200, seed=3, extent=((-6, 6), (-3, 3), (2, 12)))
    img, depth = scene.render_rgbd(np.eye(3), np.zeros(3))
    with tempfile.TemporaryDirectory() as d:
        _write_tum_sequence(Path(d), [(img, depth, 100.0), (img, depth, 100.05)])
        seq = TumRgbdSequence(d, depth_map_factor=5000.0)
        assert len(seq) == 2
        im2, dp2, ts = seq[0]
        assert ts == pytest.approx(100.0) and seq[1][2] == pytest.approx(100.05)
        np.testing.assert_array_equal(im2, img)
        assert dp2.dtype == np.float32 and np.abs(dp2 - depth).max() < 1e-3
        mono = TumMonoSequence(d)
        assert len(mono) == 2
        np.testing.assert_array_equal(mono[1][0], img)
        assert mono[1][1] == pytest.approx(100.05)


def test_tum_association_and_ground_truth(tmp_path):
    """associate pairs each stamp with its nearest unused partner within
    0.02 s; load_tum_gt reads stamps and positions past comment lines."""
    pairs = associate(np.array([0.0, 0.1, 0.2, 0.3]), np.array([0.005, 0.11, 0.35, 0.50]), max_offset=0.02)
    assert pairs == [(0, 0), (1, 1)]
    assert associate(np.array([0.0, 0.001]), np.array([0.0005])) == [(0, 0)]
    (tmp_path / "groundtruth.txt").write_text(
        "# ground truth\n# timestamp tx ty tz qx qy qz qw\n"
        "1.0 0.1 0.2 0.3 0 0 0 1\n\n1.5 0.4 0.5 0.6 0 0 0 1\n")
    ts, pos = load_tum_gt(tmp_path)
    np.testing.assert_allclose(ts, [1.0, 1.5])
    np.testing.assert_allclose(pos, [[0.1, 0.2, 0.3], [0.4, 0.5, 0.6]])
