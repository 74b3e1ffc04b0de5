"""The port's tracer (``utils/timing.py``) on the CPU: spans nest with
their parents, frame ids and threads, a mapping worker's included; a
disabled tracer keeps its timers' sums and records nothing; under a
torch.profiler each span is a ``slam/<name>`` host range inside its
parent's; a short pinned run's counters match what the tracker and the
loop closer did; and ``closure_ms`` comes from the closure's spans with
the keys it always had, on both detection schedules."""

import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from orb_line_slam_tpu_torch.config import CameraIntrinsics, LineConfig, MapConfig, OrbConfig, SlamConfig
from orb_line_slam_tpu_torch.data.synthetic import SyntheticScene, loop_circuit_trajectory
from orb_line_slam_tpu_torch.pipeline.system import System
from orb_line_slam_tpu_torch.slam_map.map_store import MapStore
from orb_line_slam_tpu_torch.utils.timing import StageTimer, Tracer, span
from orb_line_slam_tpu_torch.utils.worker import Worker
from slambench import spans as readers
from tests.test_torch_async_loop import CLOSING_KF, _add_copy_of, _closers, _drive, _stop

torch.set_num_threads(1)

# tests/test_torch_loop_system.py's circuit without lines: 12 frames make
# keyframes, local BAs and loop queries.
CAM = CameraIntrinsics(fx=160.0, fy=160.0, cx=160.0, cy=80.0, bf=80.0, width=320, height=160)
CFG = SlamConfig(
    camera=CAM, orb=OrbConfig(n_features=400, n_levels=3), lines=LineConfig(enabled=False, n_lines=32),
    map=MapConfig(max_keyframes=32, max_points=4096, max_lines=64, local_window=8, local_points=2048),
)
N_FRAMES = 12


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def test_spans_nest_with_parents_frames_and_threads_across_a_worker():
    tracer = Tracer()
    timer = StageTimer(tracer)
    tracer.enable()
    worker = Worker("trace-test", "cpu")

    def job():
        with timer.stage("local_ba"):
            with span("ba_solve"):
                pass
        return threading.get_ident()

    try:
        for fid in (0, 1):
            tracer.frame_id = fid
            with timer.stage("frame"):
                with timer.stage("frontend"):
                    with span("detect"):
                        pass
                worker_thread = worker.submit(job).result(timeout=60)
    finally:
        worker.stop()
    recs = _by_name(tracer.drain())
    assert tracer.drain() == []
    assert {n: len(v) for n, v in recs.items()} == {"frame": 2, "frontend": 2, "detect": 2, "local_ba": 2,
                                                     "ba_solve": 2}
    main = threading.get_ident()
    assert worker_thread != main
    for i in (0, 1):
        frame, frontend, detect = recs["frame"][i], recs["frontend"][i], recs["detect"][i]
        ba, solve = recs["local_ba"][i], recs["ba_solve"][i]
        assert frame.parent is None and frontend.parent == frame.id and detect.parent == frontend.id
        assert ba.parent is None and solve.parent == ba.id       # a root on its own thread
        assert {r.thread for r in (frame, frontend, detect)} == {main}
        assert {r.thread for r in (ba, solve)} == {worker_thread}
        assert {r.frame for r in (frame, frontend, detect, ba, solve)} == {i}
        assert frame.start_ns <= frontend.start_ns <= detect.start_ns <= detect.end_ns <= frontend.end_ns
        assert frame.start_ns <= ba.start_ns <= solve.start_ns <= solve.end_ns <= ba.end_ns <= frame.end_ns
    assert dict(timer.cnt) == {"frame": 2, "frontend": 2, "detect": 2, "local_ba": 2, "ba_solve": 2}


def test_disabled_tracer_keeps_only_the_sums():
    timer = StageTimer()
    with span("no_open_span"):           # no span open on this thread: nothing
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with timer.stage("frame"):
                with span("detect"):
                    torch.ones(16).sum()
        timer.add("ba_wait", 0.25)
        timer.count("keyframes", 2)
    assert timer.tracer.drain() == []
    assert dict(timer.cnt) == {"frame": 3, "detect": 3, "ba_wait": 1}
    assert timer.acc["ba_wait"] == 0.25 and timer.acc["frame"] >= timer.acc["detect"] > 0
    assert dict(timer.tracer.counters) == {"keyframes": 2}
    assert set(timer.table(3)) == {"frame", "detect", "ba_wait"} and timer.table(3)["frame"]["calls"] == 3
    assert not any(e.name().startswith(readers.PREFIX) for e in prof.profiler.kineto_results.events())
    timer.tracer.enable()
    with timer.stage("frame"):
        pass
    timer.tracer.disable()
    with timer.stage("frame"):
        pass
    assert [r.name for r in timer.tracer.drain()] == ["frame"] and timer.cnt["frame"] == 5


def test_spans_are_profiler_ranges_inside_their_parents():
    timer = StageTimer()
    timer.tracer.enable()
    with timer.stage("warm"):            # the first range of a process loads the profiler's operators
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.stage("frame"):
            with timer.stage("frontend"):
                with span("detect"):
                    torch.ones(64).cumsum(0)
                with span("describe"):
                    torch.ones(64).sum()
            with timer.stage("track_step"):
                torch.ones(8).sum()
    program, _, _ = readers.read_events(prof)
    got = {name: (a, b) for name, a, b in program}
    assert sorted(n for n, _, _ in program) == ["describe", "detect", "frame", "frontend", "track_step"]
    parent = {"frontend": "frame", "detect": "frontend", "describe": "frontend", "track_step": "frame"}
    for child, up in parent.items():
        assert got[up][0] <= got[child][0] <= got[child][1] <= got[up][1]
    assert got["detect"][1] <= got["describe"][0] and got["frontend"][1] <= got["track_step"][0]
    chains = {chain for _, _, chain in readers.segments(program)}
    assert chains == {("frame",), ("frame", "frontend"), ("frame", "frontend", "detect"),
                      ("frame", "frontend", "describe"), ("frame", "track_step")}
    # The records and the profiler's ranges share a clock.
    t0 = prof.profiler.kineto_results.trace_start_ns()
    for r in timer.tracer.drain()[1:]:
        assert abs(r.start_ns - (t0 + got[r.name][0] * 1e3)) < 5e6


@pytest.fixture(scope="module", params=["pinned", "deferred"])
def short_run(request):
    """A short run of the circuit from pixels with the tracer on: mapping
    pinned to the tracking thread, or the local BA deferred to the
    mapping worker; MapStore.add_keyframe counted."""
    scene = SyntheticScene(CAM, n_points=500, seed=5, extent=((-9.0, 15.0), (-3.0, 3.0), (-12.0, 12.0)))
    scene.noise_sigma = 6.0
    poses = loop_circuit_trajectory(70, radius=3.0, laps=1.15)[:N_FRAMES]
    inserted = []
    add_keyframe = MapStore.add_keyframe

    def counted(self, *a, **k):
        kf = add_keyframe(self, *a, **k)
        inserted.append(kf)
        return kf

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(MapStore, "add_keyframe", counted)
        slam = System(CFG, use_loop_closing=True, async_loop=False, device="cpu")
        slam.gba_async = False
        slam.tracker.async_mapping = request.param == "deferred"
        slam.tracer.enable()
        for i, (R, t) in enumerate(poses):
            slam.track_stereo(*scene.render_stereo(R, t), timestamp=0.1 * i)
        records = slam.tracer.drain()     # the frames' spans; shutdown's flush follows
        slam.shutdown()
    return request.param, slam, inserted, records


def test_counters_add_up_over_a_short_run(short_run):
    _, slam, inserted, _ = short_run
    tr, counters = slam.tracker, slam.tracer.counters
    assert slam.tracking_state() == "OK"
    assert counters["keyframes"] == len(inserted) >= 5
    assert counters["local_ba_solved"] == tr.n_local_ba + tr.n_ba_stale >= 3
    assert counters["local_ba_skipped"] == tr.n_ba_skipped
    lc = slam.loop_closer
    assert counters["loop_queries_due"] == lc.timing.cnt["loop_query"] >= 1
    assert counters["loop_queries_due"] >= counters["loop_queries_with_candidates"]
    assert tr.timing.cnt["frame"] == tr.timing.cnt["frontend"] == tr.timing.cnt["upload"] == N_FRAMES
    assert tr.timing.cnt["track_step"] == tr.timing.cnt["track_consume"] == tr.timing.cnt["track_step_call"]
    assert tr.timing.cnt["loop_closing"] == tr.timing.cnt["kf_event_total"]
    assert tr.timing.cnt["local_ba"] == counters["local_ba_solved"]


def test_every_span_of_a_frame_carries_its_frame_id(short_run):
    schedule, slam, _, records = short_run
    main = threading.get_ident()
    by_id = {r.id: r for r in records}
    frames = [r for r in records if r.name == "frame"]
    assert [r.frame for r in frames] == list(range(N_FRAMES))
    for r in records:
        if r.thread != main:
            continue
        root = r
        while root.parent is not None:
            parent = by_id[root.parent]
            assert parent.start_ns <= root.start_ns <= root.end_ns <= parent.end_ns
            root = parent
        assert root.name == "frame" and r.frame == root.frame
    names = {r.name for r in records}
    assert {"upload", "frontend", "pyramid", "detect", "describe", "stereo", "track_step", "mirror_refresh",
            "track_step_call", "track_consume", "kf_event_total", "map_jobs", "ba_pack_host", "local_ba",
            "ba_upload", "ba_solve", "ba_fetch", "loop_closing", "bow", "vocab_train"} <= names
    solves = [r for r in records if r.name == "local_ba"]
    assert solves and all((r.thread != main) == (schedule == "deferred") for r in solves)
    for r in records:
        if r.name in ("ba_upload", "ba_solve", "ba_fetch"):
            assert by_id[r.parent].name == "local_ba" and by_id[r.parent].thread == r.thread


def _closure(async_detect: bool):
    """A LoopCloser over the drifted map driven to its closure; the global
    BA solved on the calling thread where detection is too."""
    lc = _closers(async_detect)[1]
    if async_detect:
        assert not _drive(lc)
        assert lc.process_keyframe(_add_copy_of(lc.map, CLOSING_KF), run_gba=False)
    else:
        lc.gba_async = False
        closed = [k for k in range(lc.map._next_kf) if lc.process_keyframe(k, run_gba=True)]
        assert closed or lc.flush(run_gba=True)
    _stop(lc)
    return lc


@pytest.mark.parametrize("async_detect", [False, True], ids=["on the tracking thread", "on the worker"])
def test_closure_ms_from_the_closure_spans(async_detect):
    lc = _closure(async_detect)
    assert len(lc.closure_ms) == 1 and lc.closure_ms[0]["kf"] == CLOSING_KF
    keys = {"kf", "detect", "sim3", "correct", "essential_graph"} | (set() if async_detect else {"gba"})
    ms = lc.closure_ms[0]
    assert set(ms) == keys and all(ms[k] > 0 for k in keys - {"kf"})
    for name in keys - {"kf"}:
        assert ms[name] <= lc.timing.acc[name] * 1e3 + 1e-9
    assert lc.timing.tracer.counters["loop_queries_due"] == lc.timing.cnt["loop_query"] >= 1
