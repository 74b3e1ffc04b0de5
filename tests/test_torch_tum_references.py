"""Where chip_smoke.py's JAX-CPU constants for phases 12 and 13 come
from: the JAX package, on the CPU, on the same 60 monocular and 60 RGB-D
frames that chip_smoke.py renders with the port's renderer, on the pinned
schedule (System(use_loop_closing=False, async_loop=False),
tracker.async_mapping = False, pipeline_depth = 0).  Slow (about two
minutes): run it after changing a phase's scene, path or configuration,
and write the new values into chip_smoke.py.

    JAX_PLATFORMS=cpu python -m pytest -m slow tests/test_torch_tum_references.py -s
"""

import importlib.util
import os

import numpy as np
import pytest

from orb_line_slam_tpu.config import CameraIntrinsics, OrbConfig, SlamConfig, TrackingConfig
from orb_line_slam_tpu.eval.trajectory import ate_rmse
from orb_line_slam_tpu.pipeline.system import System as JaxSystem

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_config(tcfg):
    """The JAX package's SlamConfig with chip_smoke.tum_config()'s values."""
    return SlamConfig(
        camera=CameraIntrinsics(*tcfg.camera),
        orb=OrbConfig(n_features=tcfg.orb.n_features, n_levels=tcfg.orb.n_levels,
                      scale_factor=tcfg.orb.scale_factor),
        tracking=TrackingConfig(th_depth=tcfg.tracking.th_depth,
                                max_frames_between_kf=tcfg.tracking.max_frames_between_kf),
        fps=tcfg.fps, rgb=tcfg.rgb, depth_map_factor=tcfg.depth_map_factor,
    )


@pytest.mark.slow
@pytest.mark.parametrize("sensor", ["mono", "rgbd"])
def test_chip_smoke_jax_cpu_references(sensor):
    cs = _chip_smoke()
    tcfg = cs.tum_config()
    mposes, mframes, rposes, rframes = cs.render_tum_sequences(tcfg, cs.N_FRAMES)
    poses, frames = (mposes, mframes) if sensor == "mono" else (rposes, rframes)
    s = JaxSystem(_jax_config(tcfg), use_loop_closing=False, async_loop=False)
    s.tracker.async_mapping = False
    s.tracker.pipeline_depth = 0
    for i, fr in enumerate(frames):
        if sensor == "mono":
            s.track_monocular(fr, timestamp=cs.TUM_DT * i)
        else:
            s.track_rgbd(*fr, timestamp=cs.TUM_DT * i)
    s.shutdown()
    traj = s.tracker.final_trajectory()
    tracked = np.array([not e[4] for e in traj])
    est = np.stack([-R.T @ t for (_, _, R, t, _) in traj])
    gt = np.stack([-R.T @ t for (R, t) in poses])
    if sensor == "mono":
        ate = float(ate_rmse(est[tracked], gt[tracked], align=True, with_scale=True))
        want = cs.JAX_CPU_REFERENCE_ATE_MONO_M
        assert int(np.argmax(tracked)) == cs.JAX_CPU_MONO_INIT_FRAME
    else:
        ate = float(ate_rmse(est, gt, align=True))
        want = cs.JAX_CPU_REFERENCE_ATE_RGBD_M
    print(f"{sensor}: JAX-CPU ATE {ate!r} m, {int(s.map.n_keyframes())} keyframes, "
          f"first tracked frame {int(np.argmax(tracked))}, state {s.tracking_state()}")
    assert s.tracking_state() == "OK"
    assert ate == pytest.approx(want, rel=1e-3)
