"""Where chip_smoke.py's JAX-CPU constants for phases 5, 7, 12 and 13 come
from: the JAX package, on the CPU, on the same chip_smoke.N_FRAMES (40)
frames that chip_smoke.py renders with the port's renderer (the point
cell's stereo pairs, the point+line cell's, the TUM-size monocular images
and RGB-D pairs), each cell's configuration carried across field by
field, on the pinned schedule (System(use_loop_closing=False,
async_loop=False), tracker.async_mapping = False, pipeline_depth = 0).
Slow (about two minutes for the TUM pair, longer for the stereo cells):
run it after changing a phase's scene, path, length or configuration, and
write the new values into chip_smoke.py.

    JAX_PLATFORMS=cpu python -m pytest -m slow tests/test_torch_tum_references.py -s
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest

from orb_line_slam_tpu import config as jax_config
from orb_line_slam_tpu.eval.trajectory import ate_rmse
from orb_line_slam_tpu.pipeline.system import System as JaxSystem

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_config(tcfg):
    """The JAX package's SlamConfig with the values of a chip_smoke
    configuration, field by field."""
    fields = lambda obj, cls: cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})  # noqa: E731
    jc = jax_config
    return jc.SlamConfig(
        camera=jc.CameraIntrinsics(*tcfg.camera), orb=fields(tcfg.orb, jc.OrbConfig),
        lines=fields(tcfg.lines, jc.LineConfig), tracking=fields(tcfg.tracking, jc.TrackingConfig),
        map=fields(tcfg.map, jc.MapConfig), fps=tcfg.fps, rgb=tcfg.rgb,
        depth_map_factor=tcfg.depth_map_factor, rectify=tcfg.rectify,
    )


def _cell(cs, sensor):
    """(config, poses, frames, seconds per frame, the constant) of a cell."""
    if sensor in ("mono", "rgbd"):
        tcfg = cs.tum_config()
        mposes, mframes, rposes, rframes = cs.render_tum_sequences(tcfg, cs.N_FRAMES)
        if sensor == "mono":
            return tcfg, mposes, mframes, cs.TUM_DT, cs.JAX_CPU_REFERENCE_ATE_MONO_M
        return tcfg, rposes, rframes, cs.TUM_DT, cs.JAX_CPU_REFERENCE_ATE_RGBD_M
    if sensor == "points":
        tcfg = cs.kitti_config()
        return (tcfg, *cs.render_sequence(tcfg, cs.N_FRAMES), 0.1, cs.JAX_CPU_REFERENCE_ATE_M)
    tcfg = cs.euroc_config()
    return (tcfg, *cs.render_sequence(tcfg, cs.N_FRAMES, cs.LINE_SCENE, cs.LINE_STEP), 0.05,
            cs.JAX_CPU_REFERENCE_ATE_LINES_M)


@pytest.mark.slow
@pytest.mark.parametrize("sensor", ["mono", "rgbd", "points", "lines"])
def test_chip_smoke_jax_cpu_references(sensor):
    cs = _chip_smoke()
    tcfg, poses, frames, dt, want = _cell(cs, sensor)
    s = JaxSystem(_jax_config(tcfg), use_loop_closing=False, async_loop=False)
    s.tracker.async_mapping = False
    s.tracker.pipeline_depth = 0
    track = {"mono": s.track_monocular, "rgbd": s.track_rgbd}.get(sensor, s.track_stereo)
    for i, fr in enumerate(frames):
        track(*(fr if isinstance(fr, tuple) else (fr,)), timestamp=dt * i)
    s.shutdown()
    traj = s.tracker.final_trajectory()
    tracked = np.array([not e[4] for e in traj])
    est = np.stack([-R.T @ t for (_, _, R, t, _) in traj])
    gt = np.stack([-R.T @ t for (R, t) in poses])
    if sensor == "mono":
        ate = float(ate_rmse(est[tracked], gt[tracked], align=True, with_scale=True))
        assert int(np.argmax(tracked)) == cs.JAX_CPU_MONO_INIT_FRAME
    else:
        ate = float(ate_rmse(est, gt, align=True))
    print(f"{sensor}: JAX-CPU ATE {ate!r} m, {int(s.map.n_keyframes())} keyframes, "
          f"first tracked frame {int(np.argmax(tracked))}, state {s.tracking_state()}")
    assert s.tracking_state() == "OK"
    assert ate == pytest.approx(want, rel=1e-3)
