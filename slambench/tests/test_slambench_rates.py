"""The rate and the tail are taken over all the frames and all the time of
the window: a stall inside the window lowers frames_per_s and shows in the
95th percentile."""

import time
from types import SimpleNamespace

import numpy as np

from slambench import harness
from slambench.drivers import stereo


class FakeSystem:
    """A System that tracks a frame in ``frame_s`` seconds, except the
    frames listed in ``stall`` (pass, frame), which take ``stall_s``."""

    frame_s, stall_s, stall = 0.004, 0.0, set()
    made = 0

    def __init__(self, cfg, use_loop_closing=True, async_loop=True, device="cpu"):
        FakeSystem.made += 1
        self.p = FakeSystem.made - 1
        self.tracker = SimpleNamespace(async_mapping=True)
        self.gba_async = True

    def track_stereo(self, left, right, timestamp=0.0):
        time.sleep(self.stall_s if (self.p, int(timestamp * 10)) in self.stall else self.frame_s)
        return np.eye(4)

    def tracking_state(self):
        return "OK"

    def shutdown(self):
        pass


def replay(seconds, stall=(), stall_s=0.0):
    FakeSystem.made, FakeSystem.stall, FakeSystem.stall_s = 0, set(stall), stall_s
    prog = SimpleNamespace(System=FakeSystem)
    cell = {"config": {"fps": 10.0, "loop_closing": True}, "traffic": {"schedule": "pinned"}}
    frames = [(None, None)] * 20
    window_s, frame_ms, passes, failed = stereo.replay(prog, None, cell, [frames], stereo.Probes(), seconds, "cpu")
    run = SimpleNamespace(tracked=len(frame_ms) - failed, window_s=window_s, frame_ms=frame_ms, passes=len(passes))
    return run, passes


def test_the_rate_is_all_frames_over_all_the_time():
    run, passes = replay(0.5)
    fps = harness.load_metric("frames_per_s")(run)
    assert run.window_s >= 0.5 and len(passes) >= 2 and len(passes[-1]) <= 20
    assert abs(fps - run.tracked / run.window_s) < 1e-9
    # The window ends at the first frame boundary after its length.
    assert run.window_s < 0.5 + 0.05


def test_a_stall_inside_the_window_lowers_the_rate():
    steady, _ = replay(0.6)
    stalled, _ = replay(0.6, stall={(0, 5)}, stall_s=0.3)
    rate = harness.load_metric("frames_per_s")
    assert rate(stalled) < 0.7 * rate(steady)


def test_the_tail_is_over_every_frame():
    run, _ = replay(0.6, stall={(0, 3), (0, 7), (0, 11), (0, 15), (1, 3), (1, 7), (1, 11), (1, 15)}, stall_s=0.03)
    p95 = harness.load_metric("frame_ms_p95")(run)
    assert len(run.frame_ms) > 60
    assert p95 == np.percentile(run.frame_ms, 95)
    assert p95 > 20.0
