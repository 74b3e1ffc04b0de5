"""The port's System on its default schedule (the JAX System's: deferred
local mapping, loop detection on a worker thread, global BA solved on
another) over the 320x160 closed circuit of tests/test_torch_loop_system.py,
on the CPU, with every worker joined between frames: the loop is
detected on the loop-closing worker and corrected on the calling thread,
the global BA is solved on the global-BA worker and applied by
poll_global_ba, the ATE meets tests/test_loop_closure_e2e.py's bound
against the JAX package's System on its default schedule over the same
frames, and no worker thread outlives shutdown()."""

import dataclasses
import threading

import jax
import numpy as np
import torch

import orb_line_slam_tpu.config as jax_config
from orb_line_slam_tpu.geometry.camera import CameraIntrinsics as JaxCameraIntrinsics
from orb_line_slam_tpu.pipeline import tracking as jax_tracking
from orb_line_slam_tpu.pipeline.system import System as JaxSystem
from orb_line_slam_tpu_torch.data.synthetic import loop_circuit_trajectory
from orb_line_slam_tpu_torch.eval.trajectory import ate_rmse
from orb_line_slam_tpu_torch.loop.loop_closing import LoopCloser
from orb_line_slam_tpu_torch.pipeline.system import System
from tests.test_torch_async_schedule import _FrameClock, _wait_jax
from tests.test_torch_loop_system import CFG, LAPS, N_FRAMES, RADIUS, _scene

torch.set_num_threads(1)
WORKER_NAMES = {"local-mapping", "loop-closing", "global-ba"}


def _ate(trajectory, poses):
    est = np.stack([-R.T @ t for (_, _, R, t, _) in trajectory])
    gt = np.stack([-R.T @ t for (R, t) in poses])
    return float(ate_rmse(est, gt, align=True))


def _jax_default_schedule_ate(frames, poses, monkeypatch):
    """The JAX package's System(cfg) defaults over the frames, made
    deterministic as tests/test_torch_async_schedule.py makes it: its
    tracker's clock advances one second per frame (its polls' throttles
    never hold a poll back), pipeline depth 0, and between frames the
    mapping chains' and the deferred BA's device work, the detection
    worker's queue and the global BA in flight are waited for.  Returns
    (ATE, loops closed)."""
    clock = _FrameClock()
    monkeypatch.setattr(jax_tracking, "time", clock)
    jcfg = jax_config.SlamConfig(
        camera=JaxCameraIntrinsics(**CFG.camera._asdict()),
        orb=jax_config.OrbConfig(n_features=CFG.orb.n_features, n_levels=CFG.orb.n_levels),
        lines=jax_config.LineConfig(enabled=CFG.lines.enabled, n_lines=CFG.lines.n_lines),
        map=jax_config.MapConfig(**dataclasses.asdict(CFG.map)),
    )
    slam = JaxSystem(jcfg)
    assert slam.async_loop and slam.gba_async and slam.tracker.async_mapping
    slam.tracker.pipeline_depth = 0
    for i, (left, right) in enumerate(frames):
        clock.now += 1.0
        slam.track_stereo(left, right, timestamp=0.1 * i)
        _wait_jax(slam.tracker)
        lc = slam.loop_closer
        if lc is not None and lc._jobs is not None:
            lc._jobs.join()
        if lc is not None and lc._pending_gba is not None:
            jax.block_until_ready(lc._pending_gba[1])
    slam.shutdown()
    return _ate(slam.tracker.final_trajectory(), poses), slam.n_loops_closed


def test_shipping_schedule_closes_the_loop_through_its_workers(monkeypatch):
    threads = {"sim3": set(), "correct": set(), "gba_solve": set(), "gba_apply": set()}

    def on_thread(key, fn):
        def wrapper(self, *a, **k):
            threads[key].add(threading.current_thread().name)
            return fn(self, *a, **k)
        return wrapper

    monkeypatch.setattr(LoopCloser, "_compute_sim3", on_thread("sim3", LoopCloser._compute_sim3))
    monkeypatch.setattr(LoopCloser, "_correct", on_thread("correct", LoopCloser._correct))
    monkeypatch.setattr(LoopCloser, "_solve_gba", on_thread("gba_solve", LoopCloser._solve_gba))
    monkeypatch.setattr(LoopCloser, "_apply_gba", on_thread("gba_apply", LoopCloser._apply_gba))
    polled = []
    poll = LoopCloser.poll_global_ba
    monkeypatch.setattr(LoopCloser, "poll_global_ba",
                        lambda self, force=False: polled.append(poll(self, force)) or polled[-1])

    poses = loop_circuit_trajectory(N_FRAMES, radius=RADIUS, laps=LAPS)
    scene = _scene()
    frames = [scene.render_stereo(R, t) for R, t in poses]
    slam = System(CFG, device="cpu")
    assert slam.async_loop and slam.gba_async and slam.tracker.async_mapping
    for i, (left, right) in enumerate(frames):
        slam.track_stereo(left, right, timestamp=0.1 * i)
        lc = slam.loop_closer
        for w in (slam.tracker._mapping_worker, lc and lc._worker, lc and lc._gba_worker):
            if w:
                w.join()
    slam.shutdown()

    lc = slam.loop_closer
    assert slam.tracking_state() == "OK"
    assert slam.n_loops_closed >= 1 and len(lc.loop_edges) == slam.n_loops_closed
    assert threads["sim3"] == {"loop-closing_0"} and threads["correct"] == {"MainThread"}
    assert lc.n_gba_applied >= 1 and any(polled) and lc.last_gba_solver == "dense+lines"
    assert threads["gba_solve"] == {"global-ba_0"} and threads["gba_apply"] == {"MainThread"}
    tr = slam.tracker
    assert tr.n_local_ba >= 10 and tr._pending_ba is None and not tr._map_jobs
    # With the workers joined between frames a deferred BA lands at the
    # next frame's poll, or in its own frame when a forced join applies it.
    assert len(tr.ba_lag_frames) == tr.n_local_ba and max(tr.ba_lag_frames) == 1
    busy = slam.worker_busy_s()
    assert set(busy) == WORKER_NAMES and all(v > 0 for v in busy.values())
    assert not WORKER_NAMES & {t.name.rsplit("_", 1)[0] for t in threading.enumerate()}
    ate = _ate(tr.final_trajectory(), poses)
    ate_jax, loops_jax = _jax_default_schedule_ate(frames, poses, monkeypatch)
    assert loops_jax >= 1
    assert ate < max(1.25 * ate_jax, ate_jax + 0.02), (ate, ate_jax)
