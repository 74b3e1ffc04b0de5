"""The port's endurance run (eval/endurance.py) against the JAX package's.

One small call of each package's run_endurance on the CPU, pinned
(shipping=False) and with lines off: 48 frames at 0.188 m per frame
(2 pi 8 m x 0.18 laps / 48, inside the 0.275 m of tests/test_endurance.py's
420-frame run), three noise frames from frame 24 that force LOST, then
the relocalization ladder.  Each package renders its own frames (the
port's numpy renderer differs from the JAX package's cv2 one in a few
edge pixels).  The slow tests are tests/test_endurance.py's two on the
port, and the recomputation of chip_smoke.py's phase-16 constant.

The JAX run is pinned to a deterministic schedule, as
tests/test_torch_async_schedule.py pins it: its tracking module's clock
advances one second per frame, and after each frame the test waits for
the tracker's outstanding device work (the mapping chains and the
deferred local BA).  Unpinned, the JAX System polls its deferred mapping
by wall time (a BA is not polled before 0.1 s, map jobs not before
0.05 s) and by whether XLA has finished, so where a BA lands, and with
it the relocalization after the noise frames, follows the host's speed:
on two CPUs the unpinned run lost 22 frames and never recovered.  The
port's schedule is deterministic in frames (Tracker.poll_mapping).
"""

import importlib.util
import os

import pytest
import torch

from orb_line_slam_tpu.eval.endurance import run_endurance as jax_run_endurance
from orb_line_slam_tpu.pipeline import tracking as jax_tracking
from orb_line_slam_tpu.pipeline.system import System as JaxSystem
from orb_line_slam_tpu_torch.eval.endurance import run_endurance
from tests.test_torch_async_schedule import _FrameClock, _wait_jax

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(n_frames=48, laps=0.18, loss_at=0.5, loss_frames=3, lines=False, shipping=False, fps_window=16)


def pinned_jax_run_endurance(**kwargs):
    """The JAX package's run_endurance on a schedule that does not depend
    on the host: one second of the tracking module's clock per frame,
    and each frame's outstanding device work awaited after it."""
    clock = _FrameClock()
    track = JaxSystem.track_stereo

    def track_and_wait(self, *a, **k):
        pose = track(self, *a, **k)
        clock.now += 1.0
        _wait_jax(self.tracker)
        return pose

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_tracking, "time", clock)
        mp.setattr(JaxSystem, "track_stereo", track_and_wait)
        return jax_run_endurance(**kwargs)


@pytest.fixture(scope="module")
def runs():
    port, ref = run_endurance(device="cpu", **SMALL), pinned_jax_run_endurance(**SMALL)
    keys = ("ate_long_lost_frames", "ate_long_recovered_at", "ate_long_kf_created", "ate_long_keyframes",
            "ate_long_points", "ate_long_m")
    print("endurance (port, JAX pinned): " + ", ".join(f"{k[9:]} {port[k]} {ref[k]}" for k in keys))
    return port, ref


def test_same_keys(runs):
    port, ref = runs
    assert port.keys() == ref.keys()
    for key in ("ate_long_frames", "ate_long_path_m"):
        assert port[key] == ref[key]
    assert len(port["ate_long_fps_windows"]) == 3


def test_lost_frames(runs):
    port, ref = runs
    assert port["ate_long_lost_frames"] == ref["ate_long_lost_frames"] == SMALL["loss_frames"], (port, ref)


def test_recovered_at(runs):
    port, ref = runs
    # The JAX System sets tracker.pipeline_depth = 2, which run_endurance
    # keeps: its tracking_state() is that of the frame consumed two frames
    # earlier, so the same recovery reads two frames later than in the
    # port, which has no depth-2 pipelining.
    assert port["ate_long_recovered_at"] > int(SMALL["n_frames"] * SMALL["loss_at"])
    assert port["ate_long_recovered_at"] == ref["ate_long_recovered_at"] - 2, (port, ref)


def test_keyframes_created(runs):
    port, ref = runs
    assert abs(port["ate_long_kf_created"] - ref["ate_long_kf_created"]) <= 3, (port, ref)


def test_points(runs):
    port, ref = runs
    assert abs(port["ate_long_points"] - ref["ate_long_points"]) <= 0.1 * ref["ate_long_points"], (port, ref)


def test_ate(runs):
    port, ref = runs
    ate, want = port["ate_long_m"], ref["ate_long_m"]
    assert ate <= max(1.25 * want, want + 0.02), (port, ref)


@pytest.mark.slow
def test_endurance_long_run():
    """tests/test_endurance.py::test_endurance_long_run on the port."""
    m = run_endurance(n_frames=420, laps=2.3, loss_at=0.62, loss_frames=4, device="cpu")

    # Survived: tracked to the end, recovered from the injected loss.
    assert m["ate_long_lost_frames"] <= 30, m
    assert m["ate_long_recovered_at"] > 0, f"never relocalized: {m}"
    # Capacity pressure: the table grows past its 96 slots only when
    # culling cannot keep up.
    assert m["ate_long_keyframes"] <= 256, m
    # ATE bounded on the ~116 m path.
    assert m["ate_long_m"] < 1.5, m
    # Loop closing fired at least once across >= 2 revisits.
    assert m["ate_long_loops"] >= 1, m


@pytest.mark.slow
def test_endurance_capacity_churn_no_loop():
    """tests/test_endurance.py::test_endurance_capacity_churn_no_loop on
    the port: slot reuse and culling over a long run without the loop
    closer must not corrupt the map or lose tracking."""
    m = run_endurance(n_frames=300, laps=1.6, loss_at=2.0, use_loop_closing=False, lines=False, device="cpu")
    assert m["ate_long_lost_frames"] == 0, m
    assert m["ate_long_keyframes"] <= 256, m
    assert m["ate_long_m"] < 1.5, m


@pytest.mark.slow
def test_jax_endurance_reference():
    """Where chip_smoke.py's JAX_CPU_REFERENCE_ATE_ENDURANCE_M comes from:
    the JAX package's run_endurance on phase 16's call on the pinned
    schedule of pinned_jax_run_endurance, on the CPU (about two minutes).

        JAX_PLATFORMS=cpu python -m pytest -m slow tests/test_torch_endurance.py -k reference -s
    """
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    m = pinned_jax_run_endurance(shipping=False, **cs.ENDURANCE)
    print(m)
    assert m["ate_long_lost_frames"] == cs.ENDURANCE["loss_frames"]
    assert m["ate_long_m"] == pytest.approx(cs.JAX_CPU_REFERENCE_ATE_ENDURANCE_M, rel=1e-3)
