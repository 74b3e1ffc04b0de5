"""The stereo point-only slice as a whole: the JAX System and the port's
System on the CPU, on the pinned schedule (lines off, loop closing off,
pipeline depth 0, synchronous mapping), on the same rendered frames;
plus the package-level rules (never jax, fp32 policy, the card and the
shipping schedule by default)."""

import os
import subprocess
import sys
import textwrap

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
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CAM = CameraIntrinsics(fx=400.0, fy=400.0, cx=320.0, cy=160.0, bf=160.0, width=640, height=320)
# The configuration of tests/test_system_e2e.py:18-27, lines off.
CFG = SlamConfig(
    camera=CAM,
    orb=OrbConfig(n_features=768, n_levels=4),
    lines=LineConfig(enabled=False),
    map=MapConfig(max_keyframes=96, max_points=16384, max_lines=64, local_window=8, local_points=2048),
)
N_FRAMES = 20


def _centres(traj):
    return np.stack([-R.T @ t for (_, _, R, t, _) in traj])


def test_slice_matches_jax_system():
    """Both reach OK with >= 3 keyframes and >= 1 local BA; keyframe
    counts within 1; the port's ATE within 10% + 5 mm of JAX's; per-frame
    camera centres within 2 cm."""
    scene = SyntheticScene(CFG.camera, n_points=700, seed=21, extent=((-14, 14), (-6, 6), (8, 60)))
    poses = circular_trajectory(N_FRAMES, step=0.3)
    frames = [scene.render_stereo(R, t) for R, t in poses]
    gt = np.stack([-R.T @ t for (R, t) in poses])

    jsys = JaxSystem(CFG, use_loop_closing=False, async_loop=False)
    jsys.tracker.async_mapping = False
    jsys.tracker.pipeline_depth = 0
    n_ba_jax = []
    orig = jsys.tracker._local_ba
    jsys.tracker._local_ba = lambda *a, **k: (n_ba_jax.append(1), orig(*a, **k))[1]
    tsys = System(config_from_jax(CFG), use_loop_closing=False, async_loop=False, device="cpu")
    tsys.gba_async = False
    tsys.tracker.async_mapping = False
    for i, (l, r) in enumerate(frames):
        jsys.track_stereo(l, r, timestamp=0.1 * i)
        tsys.track_stereo(l, r, timestamp=0.1 * i)
    jsys.shutdown()
    tsys.shutdown()

    assert jsys.tracking_state() == "OK" and tsys.tracking_state() == "OK"
    n_kf_j, n_kf_t = jsys.map.n_keyframes(), tsys.map.n_keyframes()
    assert n_kf_j >= 3 and n_kf_t >= 3 and abs(n_kf_j - n_kf_t) <= 1
    assert len(n_ba_jax) >= 1 and tsys.tracker.n_local_ba >= 1
    cj, ct = _centres(jsys.tracker.final_trajectory()), _centres(tsys.tracker.final_trajectory())
    ate_j = ate_rmse(cj, gt, align=True)
    ate_t = ate_rmse(ct, gt, align=True)
    assert abs(ate_t - ate_j) <= 0.1 * ate_j + 0.005, (ate_t, ate_j)
    assert np.linalg.norm(ct - cj, axis=1).max() < 0.02


def test_package_never_imports_jax(tmp_path):
    """The port imports (the distributed BA's modules, the endurance run,
    checkpoints, loaders, native bridge, viewer and example drivers
    included) and tracks frames, lines on, with `import jax` made to fail."""
    script = textwrap.dedent(f"""
        import sys
        class _Block:
            def find_spec(self, name, path=None, target=None):
                if name == "jax" or name.startswith(("jax.", "jaxlib", "orb_line_slam_tpu.")) \\
                        or name == "orb_line_slam_tpu":
                    raise ImportError("blocked: " + name)
                return None
        sys.meta_path.insert(0, _Block())
        sys.path.insert(0, {ROOT!r})
        import numpy as np, torch
        torch.set_num_threads(1)
        from orb_line_slam_tpu_torch.config import CameraIntrinsics, LineConfig, OrbConfig, SlamConfig
        from orb_line_slam_tpu_torch.data.synthetic import SyntheticScene
        from orb_line_slam_tpu_torch.pipeline.system import System
        import orb_line_slam_tpu_torch.convert
        import orb_line_slam_tpu_torch.parallel.dryrun
        import orb_line_slam_tpu_torch.parallel.multihost
        import orb_line_slam_tpu_torch.parallel.multihost_worker
        import orb_line_slam_tpu_torch.parallel.sharded_ba
        import orb_line_slam_tpu_torch.eval.endurance
        import orb_line_slam_tpu_torch.eval.viewer
        import orb_line_slam_tpu_torch.slam_map.checkpoint
        import orb_line_slam_tpu_torch.data.euroc
        import orb_line_slam_tpu_torch.data.kitti
        import orb_line_slam_tpu_torch.data.tum
        import orb_line_slam_tpu_torch.utils.native
        import orb_line_slam_tpu_torch.examples._common
        for name in ("stereo_kitti", "stereo_euroc", "mono_kitti", "mono_euroc", "mono_tum", "rgbd_tum"):
            __import__("orb_line_slam_tpu_torch.examples." + name)
        cam = CameraIntrinsics(fx=400.0, fy=400.0, cx=320.0, cy=160.0, bf=160.0, width=640, height=320)
        cfg = SlamConfig(camera=cam, orb=OrbConfig(n_features=512, n_levels=3), lines=LineConfig(n_lines=32))
        scene = SyntheticScene(cam, n_points=300, n_lines=30, seed=4, extent=((-14, 14), (-6, 6), (6, 60)))
        s = System(cfg, device="cpu")
        for z in (0.0, 0.2):
            s.track_stereo(*scene.render_stereo(np.eye(3), np.array([0.0, 0.0, -z])))
        assert s.tracking_state() == "OK", s.tracking_state()
        assert s.map.ln_valid.sum() > 0 and s.tracker._mir["has_lines"]
        assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules)
        print("ok")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=300,
                          cwd=str(tmp_path), env=env)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-3000:]


def test_system_requires_explicit_device_and_no_loop_closing(monkeypatch):
    """The card is the default device: with no CUDA, System(cfg) raises a
    RuntimeError that names CUDA (nothing falls back to the CPU), and
    the CPU must be asked for explicitly.  The schedule defaults are the
    JAX System's (async loop detection, asynchronous global BA, deferred
    local mapping); with use_loop_closing=False no loop closer is ever
    made."""
    import pytest

    from orb_line_slam_tpu_torch.pipeline import tracking

    cfg = config_from_jax(CFG)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: System(cfg), lambda: System(cfg, device="cuda"), lambda: tracking.Tracker(cfg)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    jsys = JaxSystem(CFG)
    slam = System(cfg, device="cpu")
    assert (slam.use_loop_closing, slam.async_loop, slam.gba_async, slam.tracker.async_mapping) == (
        jsys.use_loop_closing, jsys.async_loop, jsys.gba_async, jsys.tracker.async_mapping) == (True, True, True, True)
    assert tracking.BA_SKIP_LIMIT == getattr(jsys.tracker, "ba_skip_limit", 1) == 1
    off = System(cfg, use_loop_closing=False, device="cpu")
    off._on_keyframe(0)
    assert off.loop_closer is None and off.voc is None


def test_system_wires_the_schedule_into_the_loop_closer():
    """The switches as System hands them to its LoopCloser, as the JAX
    System does (system.py:162-178): the defaults, and the pinned
    schedule."""
    from orb_line_slam_tpu_torch.loop.vocabulary import Vocabulary

    cfg = config_from_jax(CFG)
    voc = Vocabulary.synthesize(k=4, depth=2)
    for async_loop, gba_async in ((True, True), (False, False)):
        slam = System(cfg, vocabulary=voc, async_loop=async_loop, device="cpu")
        slam.gba_async = gba_async
        slam.tracker.map.add_keyframe(_Frame(cfg.orb.n_features), np.eye(3), np.zeros(3), 0)
        slam._on_keyframe(0)
        lc = slam.loop_closer
        assert (lc.async_detect, lc.gba_async) == (async_loop, gba_async)
        assert lc.pre_correct_hook == slam._drain_mapping and slam.tracker.reloc_candidates_fn is not None
        slam.shutdown()
        assert lc._worker is None or not lc._worker.is_alive()


class _Frame:
    """A keyframe's feature table with nothing valid."""

    def __init__(self, n):
        self.xy = np.zeros((n, 2), np.float32)
        self.u_right = np.full(n, -1.0, np.float32)
        self.depth = np.full(n, -1.0, np.float32)
        self.octave = np.zeros(n, np.int32)
        self.angle = np.zeros(n, np.float32)
        self.desc = np.zeros((n, 32), np.uint8)
        self.valid = np.zeros(n, bool)


def test_fp32_policy():
    import orb_line_slam_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
