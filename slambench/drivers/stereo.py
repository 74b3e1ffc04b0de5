"""The stereo driver: one stereo sequence replayed closed loop through
``System.track_stereo``, pass after pass, each pass a fresh ``System`` on
the traffic's schedule (``make_system``); pass n plays the noise copy n
modulo the pool.  The probes wrap the single-sequence path's layer calls
(``Probes``); the checks of ``check.py`` read their captures.  A traffic
file that names no driver runs this one."""

from __future__ import annotations

import time

import numpy as np

from slambench import check, harness
from slambench.drivers import _common

RANGE_TAGS = ("point_frontend", "line_frontend", "track_step", "mapping", "loop_detect")
# The ranges that label the device's idle gaps, outermost first.
LABELS = RANGE_TAGS
# What one call of the program in ``replay`` tracks, and how many frames.
CALL = "frame"


def frames_per_call(cell: dict) -> int:
    return 1


def make_probes(cell: dict, seed: int) -> "Probes":
    """The probes of a run, sampling the frames of the window's first pass
    that the checks compare."""
    return Probes(check_frames(seed, int(cell["n_frames"]), cell["traffic"]["check"]))


def worst_ate(passes, gt_centres, cell: dict):
    """The worst pass's ATE (m) against the rendered ground truth."""
    return check.worst_ate(passes, gt_centres)


def check_frames(seed: int, n_frames: int, chk: dict) -> list[int]:
    """The frames of the window's first pass whose front end and pose solves
    the checks compare, drawn from the seed."""
    rng = np.random.default_rng(int(seed) % 2 ** 63)
    return sorted(rng.choice(np.arange(2, n_frames), size=chk["frames"], replace=False).tolist())


class Probes(_common.BaseProbes):
    """Wraps the program's layer entry points from outside: host-clock spans
    of the mapping and loop-detection calls on the tracking thread, the
    samples the checks compare (in the sample pass: the sampled frames'
    front ends, tracking steps and pose solves, the local BAs, every
    keyframe's insertion into the loop detector and its query), and (while
    ``tracing``) a profiler range around each layer call and the arguments
    of each hand-written kernel's launch.  ``where`` is the (pass, frame)
    being tracked."""

    def __init__(self, sample_frames=()):
        super().__init__()
        self.sample_frames = set(sample_frames)
        self.spans = {"mapping": [], "loop_detect": [], "vocab_train": [], "system": []}
        self.frontend, self.lines, self.pose, self.ba = {}, {}, [], []
        self.steps, self.loop_events, self.voc_train = [], [], None
        self._step = None
        self._event = None

    def _sampling(self) -> bool:
        return self.where[0] == self.sample_pass and self.where[1] in self.sample_frames

    def __enter__(self):
        from orb_line_slam_tpu_torch.loop import loop_closing
        from orb_line_slam_tpu_torch.pipeline import system, tracking
        from orb_line_slam_tpu_torch.pipeline import track_step as step

        def clone(x):
            return type(x)(*(t.detach().clone() for t in x))

        def sample_probe(fn, store):
            def wrapper(*a, **k):
                out = fn(*a, **k)
                if self._sampling():
                    store[self.where[1]] = clone(out)
                return out
            return wrapper

        def step_probe(fn):
            def wrapper(*a, **k):
                if not self._sampling():
                    return fn(*a, **k)
                rec = {"args": {n: harness.snapshot(v) for n, v in check._bind(fn, a, k).items()}, "solves": []}
                self._step = rec
                try:
                    out = fn(*a, **k)
                finally:
                    self._step = None
                rec["out"] = harness.snapshot(out)
                self.steps.append((self.where[1], rec))
                return out
            return wrapper

        def pose_probe(fn, in_step):
            def wrapper(*a, **k):
                out = fn(*a, **k)
                if self._sampling() or self.tracing:
                    call = {"args": check.bind_pose_call(fn, a, k), "result": clone(out), "path": "other"}
                    if self._sampling():
                        if in_step and self._step is not None:
                            solves = self._step["solves"]
                            call["path"] = check.SOLVE_PATHS[len(solves)] if len(solves) < 3 else "extra"
                            solves.append(call)
                        self.pose.append(call)
                    if self.tracing:
                        self.pose_calls.append(call)
                return out
            return wrapper

        def ba_probe(fn):
            def wrapper(cfg, device, pack, lpack, line0):
                t0 = time.perf_counter()
                out = fn(cfg, device, pack, lpack, line0)
                if self.recording:
                    self.spans["mapping"].append(time.perf_counter() - t0)
                if self.where[0] == self.sample_pass:
                    cp = lambda d: None if d is None else {  # noqa: E731
                        k: (np.array(v, copy=True) if isinstance(v, np.ndarray) else v) for k, v in d.items()}
                    self.ba.append({"pack": cp(pack), "lpack": cp(lpack),
                                    "line0": None if line0 is None else tuple(np.array(x, copy=True) for x in line0),
                                    "result": out[0]})
                return out
            return wrapper

        def loop_probe(fn):
            def wrapper(sys_self, kf_id):
                t0 = time.perf_counter()
                out = fn(sys_self, kf_id)
                if self.recording:
                    self.spans["loop_detect"].append(time.perf_counter() - t0)
                return out
            return wrapper

        def keep_training(train):
            self.voc_train = train

        def insert_probe(fn):
            # One keyframe's insertion into the loop detector (the words
            # its BoW transform gave) and the state that decides whether
            # it is queried.
            def wrapper(closer, prev, run_gba=True):
                if prev is None or not self._sample_pass():
                    return fn(closer, prev, run_gba)
                store = closer.map
                kf, gen, words, valid = prev
                self._event = {
                    "kf": int(kf), "desc": np.array(store.kf_desc[kf], copy=True),
                    "valid": np.array(valid, copy=True), "words": words.detach().cpu().numpy().copy(),
                    "gen_ok": bool(store.kf_valid[kf] and store.kf_gen[kf] == gen),
                    "gate": store.n_keyframes() >= 6 and closer.kf_counter - closer.last_loop_count >= 10,
                    "query": None}
                self.loop_events.append(self._event)
                try:
                    return fn(closer, prev, run_gba)
                finally:
                    self._event = None
            return wrapper

        self._install([
            (tracking, "build_stereo_frame",
             self._ranged(sample_probe(tracking.build_stereo_frame, self.frontend), "point_frontend")),
            (tracking, "build_line_features",
             self._ranged(sample_probe(tracking.build_line_features, self.lines), "line_frontend")),
            (tracking, "track_step", self._ranged(step_probe(tracking.track_step), "track_step")),
            (tracking, "_solve_local_ba", self._ranged(ba_probe(tracking._solve_local_ba), "mapping")),
            (tracking, "pose_optimize", pose_probe(tracking.pose_optimize, False)),
            (step, "pose_optimize", pose_probe(step.pose_optimize, True)),
            (system.System, "_on_keyframe", self._ranged(loop_probe(system.System._on_keyframe), "loop_detect")),
            self.train_patch(keep_training),
            (loop_closing.LoopCloser, "_process_resolved", insert_probe(loop_closing.LoopCloser._process_resolved)),
            *self.query_patches(lambda: self._event),
            *self.kernel_patches(),
        ])
        return self


def make_system(System, cfg, traffic: dict, loop_closing: bool, device: str):
    """A System on the traffic's schedule: "pinned" (mapping, loop detection
    and global BA on the tracking thread, each frame's work finished before
    the next) or "default" (the System's worker threads)."""
    if traffic["schedule"] == "pinned":
        slam = System(cfg, use_loop_closing=loop_closing, async_loop=False, device=device)
        slam.gba_async = False
        slam.tracker.async_mapping = False
        return slam
    if traffic["schedule"] == "default":
        return System(cfg, use_loop_closing=loop_closing, device=device)
    raise ValueError(f"unknown schedule {traffic['schedule']!r}")


class _Pass:
    """One pass of ``replay``: a fresh System over one noise copy."""

    def __init__(self, prog, cfg, cell: dict, frames, device: str):
        config = cell["config"]
        self.slam = make_system(prog.System, cfg, cell["traffic"], bool(config["loop_closing"]), device)
        self.frames, self.n, self.dt = frames, len(frames), 1.0 / float(config["fps"])
        self.output = []

    def prepare(self, i: int) -> None:
        pass

    def call(self, i: int):
        left, right = self.frames[i]
        return self.slam.track_stereo(left, right, timestamp=self.dt * i)

    def record(self, T) -> int:
        self.output.append(np.asarray(T, np.float64))
        return self.slam.tracking_state() != "OK"

    def close(self) -> None:
        self.slam.shutdown()
        self.slam = None


def replay(prog, cfg, cell: dict, sequences, probes: Probes, seconds: float, device: str, whole_passes=False):
    """Closed-loop passes, each a fresh System, pass n over the stereo pairs
    ``sequences[n % len(sequences)]``, until the first frame boundary after
    ``seconds`` (with ``whole_passes`` the end of that pass).  Returns
    (window seconds, host ms a frame, each pass's returned Tcw, frames not
    tracked)."""
    return _common.closed_loop(probes, seconds, whole_passes,
                               lambda p: _Pass(prog, cfg, cell, sequences[p % len(sequences)], device))


def traced_pass(prog, cfg, cell: dict, sequences, probes: Probes, device: str, sync):
    """A fresh pass over ``sequences[0]`` with a torch.profiler window over
    the traffic's traced frames (a window that comes back without its device
    records is taken again over the next frames).  Returns the window's raw
    records."""
    trace = cell["traffic"]["trace"]
    run = _Pass(prog, cfg, cell, sequences[0], device)
    got = _common.traced_window(probes, run.n, run.call, int(trace["start_frac"] * run.n), int(trace["frames"]),
                                sync, RANGE_TAGS, "frame")
    run.close()
    sync()
    return got
