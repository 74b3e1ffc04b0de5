"""utils/worker.py, the port's one worker-thread primitive, and the
lifetime of the threads System starts: jobs run in order on one thread,
a job's exception is raised where its result is read, stop() joins the
thread, and System.reset()/shutdown() leave no worker thread alive.
Plus a stress test of the map-lock discipline the detection worker's
snapshot relies on.  Every wait is bounded."""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from orb_line_slam_tpu_torch.config import CameraIntrinsics, LineConfig, MapConfig, OrbConfig, SlamConfig
from orb_line_slam_tpu_torch.loop.loop_closing import _MapSnapshot
from orb_line_slam_tpu_torch.loop.vocabulary import Vocabulary
from orb_line_slam_tpu_torch.pipeline.system import System
from orb_line_slam_tpu_torch.slam_map.map_store import MapStore
from orb_line_slam_tpu_torch.utils.worker import Worker

torch.set_num_threads(1)
WORKER_NAMES = {"local-mapping", "loop-closing", "global-ba"}


def worker_threads():
    """Names of the live threads that are workers' (``<name>_0``)."""
    return WORKER_NAMES & {t.name.rsplit("_", 1)[0] for t in threading.enumerate()}
CFG = SlamConfig(
    camera=CameraIntrinsics(fx=160.0, fy=160.0, cx=160.0, cy=80.0, bf=80.0, width=320, height=160),
    orb=OrbConfig(n_features=64, n_levels=3), lines=LineConfig(enabled=False),
    map=MapConfig(max_keyframes=16, max_points=512, max_lines=16, local_window=4, local_points=256),
)


def test_jobs_run_in_order_on_the_worker_thread():
    w = Worker("test-worker", "cpu")
    seen = []

    def job(i):
        time.sleep(0.002)
        seen.append((i, threading.current_thread().name))
        return i * i

    futs = [w.submit(job, i) for i in range(20)]
    assert [f.result(timeout=30) for f in futs] == [i * i for i in range(20)]
    assert seen == [(i, "test-worker_0") for i in range(20)] and w.busy_s > 0.02
    w.submit(time.sleep, 0.05)
    w.join()
    w.stop()
    assert not w.is_alive()
    with pytest.raises(RuntimeError, match="stopped"):
        w.submit(job, 0)


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_job_exception_is_raised_at_result_and_the_worker_goes_on():
    w = Worker("test-worker", "cpu")

    def fails():
        raise ValueError("job failed")

    bad = w.submit(fails)
    good = w.submit(lambda: 7)
    with pytest.raises(ValueError, match="job failed"):
        bad.result(timeout=30)
    assert good.result(timeout=30) == 7 and w.is_alive()
    exiting = w.submit(sys.exit, 3)
    assert isinstance(exiting.exception(timeout=30), SystemExit)
    assert w.submit(lambda: 8).result(timeout=30) == 8     # an exit in a job is the job's
    w.stop()
    assert not w.is_alive()


def test_stop_finishes_queued_jobs_first():
    w = Worker("test-worker", "cpu")
    futs = [w.submit(time.sleep, 0.01) for _ in range(5)]
    w.stop()
    assert all(f.done() and f.exception() is None for f in futs) and not w.is_alive()


def test_reset_and_shutdown_leave_no_worker_alive():
    """System.reset() and shutdown() end the mapping worker, the
    detection worker and the global-BA worker."""
    for end in ("reset", "shutdown"):
        slam = System(CFG, vocabulary=Vocabulary.synthesize(k=4, depth=2), device="cpu")
        f = _EmptyFrame(CFG.orb.n_features)
        slam.map.add_keyframe(f, np.eye(3), np.zeros(3), 0)
        slam.map.add_keyframe(f, np.eye(3), np.array([0.0, 0.0, -1.0]), 1, parent=0)
        slam._on_keyframe(0)                  # starts the detection worker
        lc = slam.loop_closer
        lc._gba_worker = Worker("global-ba", "cpu")
        tracker = slam.tracker
        tracker._mapping_worker = Worker("local-mapping", "cpu")
        workers = [tracker._mapping_worker, lc._worker, lc._gba_worker]
        for w in workers:
            w.submit(lambda: None).result(timeout=30)
        assert all(w.is_alive() for w in workers) and worker_threads() == WORKER_NAMES
        getattr(slam, end)()
        assert not any(w.is_alive() for w in workers)
        assert not worker_threads()
        if end == "reset":
            assert slam.loop_closer is None and slam.tracker is not tracker


class _EmptyFrame:
    def __init__(self, n):
        self.xy = np.zeros((n, 2), np.float32)
        self.u_right = np.full(n, -1.0, np.float32)
        self.depth = np.full(n, -1.0, np.float32)
        self.octave = np.zeros(n, np.int32)
        self.angle = np.zeros(n, np.float32)
        self.desc = np.zeros((n, 32), np.uint8)
        self.valid = np.zeros(n, bool)


def test_snapshots_under_the_map_lock_are_never_torn():
    """One writer rewrites every keyframe pose and landmark to a new
    version number under map.lock, as the tracking thread mutates the map;
    eight readers take _MapSnapshots under the lock, as the detection
    worker does.  Each snapshot must hold one version throughout (a torn
    read mixes two).  The interpreter switches threads every 10 us."""
    store = MapStore(CFG.map, CFG.orb.n_features)
    for k in range(4):
        store.add_keyframe(_EmptyFrame(CFG.orb.n_features), np.eye(3), np.zeros(3), k)
    store.add_points(np.zeros((64, 3), np.float32), np.zeros((64, 32), np.uint8), np.zeros(64, np.int32), 0,
                     np.arange(64))
    stop = threading.Event()
    torn = []

    def writer():
        v = 0.0
        while not stop.is_set():
            v += 1.0
            with store.lock:
                for k in range(4):
                    store.kf_t[k] = v
                    store.pt_pos[16 * k: 16 * (k + 1)] = v

    def reader():
        while not stop.is_set():
            with store.lock:
                snap = _MapSnapshot(store, (1, 3))
            versions = {float(snap.kf_t[1][0]), float(snap.kf_t[3][0])} | set(np.unique(snap.pt_pos[:64]).tolist())
            if len(versions) != 1:
                torn.append(versions)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=writer)] + [threading.Thread(target=reader) for _ in range(8)]
    try:
        for t in threads:
            t.start()
        time.sleep(1.0)
    finally:
        stop.set()
        for t in threads:
            t.join(30)
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not torn, torn[:3]
