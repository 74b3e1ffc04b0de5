"""The monocular path as a whole: the JAX Tracker and the port's on
tests/test_mono_tracking.py's 10 frames (that JAX test is slow-marked;
this one runs both packages live, pinned: synchronous mapping, pipeline
depth 0), a pure rotation that must not initialise, the loop closer's
free scale on a monocular map, and a few monocular frames on the
System's default schedule with the deferred local BA applied."""

import numpy as np
import torch

from orb_line_slam_tpu.config import LineConfig, MapConfig, OrbConfig, SlamConfig
from orb_line_slam_tpu.geometry.camera import CameraIntrinsics
from orb_line_slam_tpu.pipeline.tracking import Tracker as JaxTracker
from orb_line_slam_tpu_torch.convert import config_from_jax
from orb_line_slam_tpu_torch.data.synthetic import SyntheticScene, circular_trajectory
from orb_line_slam_tpu_torch.eval.trajectory import ate_rmse
from orb_line_slam_tpu_torch.pipeline.system import System
from orb_line_slam_tpu_torch.pipeline.tracking import Tracker

torch.set_num_threads(1)

# tests/test_mono_tracking.py's camera, configuration, scene and path.
CAM = CameraIntrinsics(fx=400.0, fy=400.0, cx=320.0, cy=160.0, bf=160.0, width=640, height=320)
CFG = SlamConfig(
    camera=CAM,
    orb=OrbConfig(n_features=1280, n_levels=4),
    lines=LineConfig(enabled=False),
    map=MapConfig(max_keyframes=64, max_points=8192, max_lines=64, local_window=8, local_points=2048),
)
TCFG = config_from_jax(CFG)
N_FRAMES = 10


def _sequence():
    scene = SyntheticScene(TCFG.camera, n_points=1000, seed=12, extent=((-10, 10), (-5, 5), (4, 25)))
    # Sideways-dominant motion gives the initializer its parallax.
    poses = [(np.eye(3), -np.array([0.2 * i, 0.0, 0.08 * i])) for i in range(N_FRAMES)]
    return poses, [scene.render(R, t) for R, t in poses]


def _mono_ate(traj, poses):
    tracked = [(e, p) for e, p in zip(traj, poses) if not e[4]]
    est = np.array([-e[2].T @ e[3] for e, _ in tracked])
    gt = np.array([-R.T @ t for _, (R, t) in tracked])
    return len(tracked), float(ate_rmse(est, gt, align=True, with_scale=True))


def _rot_angle(Ra, Rb):
    d = np.asarray(Ra, np.float64) @ np.asarray(Rb, np.float64).T
    return float(np.arccos(np.clip((np.trace(d) - 1) / 2, -1, 1)))


def test_mono_sequence_matches_jax():
    """The same initialization frame, the pose right after initialization
    within 1e-3 rad and 5e-3 (the map's median depth is 1), the
    similarity-aligned ATE within 1.1 x + 1 cm of JAX's, and
    tests/test_mono_tracking.py's own bounds on the port."""
    poses, imgs = _sequence()
    jt = JaxTracker(CFG)
    jt.async_mapping = False
    jt.pipeline_depth = 0
    tt = Tracker(TCFG, device="cpu")
    tt.async_mapping = False
    after = {}
    for name, tr in (("jax", jt), ("port", tt)):
        for i, img in enumerate(imgs):
            state = tr.state
            tr.process_mono(img, timestamp=0.1 * i)
            if state == "NOT_INITIALIZED" and tr.state == "OK":
                after[name] = (i, tr.R.copy(), tr.t.copy(), int(tr.map.pt_valid.sum()))
    assert jt.is_mono and tt.is_mono
    (ij, Rj, tj, nj), (it, Rt, tt_, nt) = after["jax"], after["port"]
    assert it == ij
    assert _rot_angle(Rt, Rj) < 1e-3 and np.abs(tt_ - tj).max() < 5e-3
    assert abs(nt - nj) <= 3
    n_j, ate_j = _mono_ate(jt.final_trajectory(), poses)
    n_t, ate_t = _mono_ate(tt.final_trajectory(), poses)
    assert n_t == n_j and n_t >= 4
    assert ate_t <= 1.1 * ate_j + 0.01, (ate_t, ate_j)
    assert ate_t < 0.08 and tt.map.pt_valid.sum() > 80
    assert tt.state == "OK" and tt.map.n_keyframes() >= 3 and tt.n_local_ba >= 2


def test_pure_rotation_stays_uninitialized():
    """A camera turning about its own centre gives no parallax: the
    tracker never initialises and reports the identity pose."""
    scene = SyntheticScene(TCFG.camera, n_points=1000, seed=12, extent=((-10, 10), (-5, 5), (4, 25)))
    tr = Tracker(TCFG, device="cpu")
    for i in range(6):
        a = 0.02 * i
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        pose = tr.process_mono(scene.render(R, np.zeros(3)), timestamp=0.1 * i)
        assert tr.state == "NOT_INITIALIZED"
        np.testing.assert_array_equal(pose, np.eye(4))
    assert tr._init_ref is not None and tr.map.n_keyframes() == 0
    assert all(e[4] for e in tr.final_trajectory())


def test_mono_system_defaults_free_scale_and_deferred_ba():
    """System(cfg) defaults on the CPU (deferred local mapping, loop
    detection and global BA on workers), monocular: the loop closer
    estimates scale (fix_scale False), the initialization's local BA and
    at least one deferred one are applied, and no worker failed."""
    _, imgs = _sequence()
    s = System(TCFG, device="cpu")
    assert s.tracker.async_mapping and s.async_loop and s.gba_async
    try:
        for i, img in enumerate(imgs):
            s.track_monocular(img, timestamp=0.1 * i)
        s.shutdown()
    finally:
        s.tracker.stop()
        if s.loop_closer is not None:
            s.loop_closer.stop()
    assert s.tracking_state() == "OK" and s.tracker.is_mono
    assert s.loop_closer is not None and s.loop_closer.fix_scale is False
    assert s.tracker.n_local_ba >= 2 and len(s.tracker.ba_lag_frames) >= 1
    assert s.tracker.n_ba_stale == 0
    assert s.map.n_keyframes() >= 3


def test_stereo_system_keeps_fixed_scale():
    """A stereo System with loop closing on keeps the scale fixed."""
    cam = TCFG.camera
    scene = SyntheticScene(cam, n_points=700, seed=21, extent=((-14, 14), (-6, 6), (8, 60)))
    s = System(TCFG, async_loop=False, device="cpu")
    s.gba_async = False
    s.tracker.async_mapping = False
    for i, (R, t) in enumerate(circular_trajectory(5, step=0.3)):
        s.track_stereo(*scene.render_stereo(R, t), timestamp=0.1 * i)
    s.shutdown()
    assert not s.tracker.is_mono
    assert s.loop_closer is not None and s.loop_closer.fix_scale is True


def test_mono_loop_closer_leaves_tracking_alone():
    """A loop closer that closes nothing does not change monocular
    tracking: the pinned System over the 10 frames with loop closing on
    (the vocabulary trained at the first keyframe, every keyframe through
    the database and the detection) and off gives the same per-frame
    records, the same trajectory bit for bit and the same map.
    chip_smoke.py's phase 17 holds the same on the card, up to a circuit's
    first failed tracking step or closure."""
    _, imgs = _sequence()
    runs = []
    for use_loop in (True, False):
        s = System(TCFG, use_loop_closing=use_loop, async_loop=False, device="cpu")
        s.gba_async = False
        s.tracker.async_mapping = False
        for i, img in enumerate(imgs):
            s.track_monocular(img, timestamp=0.1 * i)
        s.shutdown()
        runs.append(s)
    on, off = runs
    assert on.loop_closer is not None and len(on.loop_closer.db.bow) >= 2 and off.loop_closer is None
    assert on.n_loops_closed == 0 and on.tracking_state() == off.tracking_state() == "OK"
    assert on.tracker.stats == off.tracker.stats
    for a, b in zip(on.tracker.final_trajectory(), off.tracker.final_trajectory(), strict=True):
        assert a[0] == b[0] and a[4] == b[4] and np.array_equal(a[2], b[2]) and np.array_equal(a[3], b[3])
    for name in ("kf_valid", "kf_R", "kf_t", "pt_valid", "pt_pos"):
        assert np.array_equal(getattr(on.map, name), getattr(off.map, name)), name
