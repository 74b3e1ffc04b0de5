"""What the drivers share: the probes' patching of the program's entry
points with its undoing, the profiler ranges, the captures of each
hand-written kernel's launch arguments and of the loop detector's query,
the closed-loop passes of a window and the traced window with its retakes.
A driver supplies its entry point and the probes of its own path."""

from __future__ import annotations

import threading
import time
from types import SimpleNamespace

import numpy as np


class BaseProbes:
    """The part of a driver's probes that does not depend on its path.
    ``where`` is the (pass, call) being run; the sample pass is the one the
    checks compare; ``recording`` is on in the measured window, ``tracing``
    in the traced one."""

    def __init__(self):
        self.where = (-1, -1)
        self.sample_pass = 0
        self.recording = False
        self.tracing = False
        self.describe_calls, self.pose_calls = [], []
        self._valid = None
        self._lock = threading.Lock()
        self._saved = []

    def _sample_pass(self) -> bool:
        return self.where[0] == self.sample_pass

    def _ranged(self, fn, tag):
        """``fn`` inside a profiler range ``tag`` while tracing."""
        from torch.profiler import record_function

        def wrapper(*a, **k):
            if not self.tracing:
                return fn(*a, **k)
            with record_function(tag):
                return fn(*a, **k)
        return wrapper

    def _install(self, patches) -> None:
        """Put each (object, name, new) in place, keeping what it held."""
        for obj, name, new in patches:
            # A class keeps its own entry (a staticmethod stays one).
            self._saved.append((obj, name, vars(obj)[name] if isinstance(obj, type) else getattr(obj, name)))
            setattr(obj, name, new)

    def __exit__(self, *exc):
        for obj, name, fn in reversed(self._saved):
            setattr(obj, name, fn)
        self._saved = []

    def kernel_patches(self) -> list:
        """While tracing, the arguments of each orb_describe launch, with the
        valid mask of the detection pass before it."""
        import torch
        from orb_line_slam_tpu_torch.frontend import orb_extractor as orb

        def detect_probe(fn):
            def wrapper(*a, **k):
                out = fn(*a, **k)
                if self.tracing:
                    self._valid = out[4].detach().clone()
                return out
            return wrapper

        def describe_probe(fn):
            def wrapper(atlas, axy, delta):
                if self.tracing:
                    valid = self._valid if self._valid is not None else torch.ones(axy.shape[:2], dtype=torch.bool)
                    self.describe_calls.append((tuple(atlas.shape), axy.detach().clone(), valid.to(axy.device)))
                    self._valid = None
                return fn(atlas, axy, delta)
            return wrapper

        return [(orb, "_detect_all_levels", detect_probe(orb._detect_all_levels)),
                (orb, "describe_keypoints", describe_probe(orb.describe_keypoints))]

    def train_patch(self, keep) -> tuple:
        """The vocabulary's training: its host seconds while recording, and
        in the sample pass its arguments (the corpus copied) handed to
        ``keep``."""
        from orb_line_slam_tpu_torch.loop import vocabulary

        from slambench import check

        def train_probe(fn):
            def wrapper(*a, **k):
                t0 = time.perf_counter()
                out = fn(*a, **k)
                if self.recording:
                    with self._lock:
                        self.spans["vocab_train"].append(time.perf_counter() - t0)
                if self._sample_pass():
                    kw = check._bind(fn, a, k)
                    keep({**kw, "descriptors": np.array(kw["descriptors"], copy=True)})
                return out
            return wrapper

        return (vocabulary.Vocabulary, "train", staticmethod(train_probe(vocabulary.Vocabulary.train)))

    def query_patches(self, event) -> list:
        """A keyframe's loop query: the state that decides it (covisibility,
        database keys, consistent groups), its candidates and its winner,
        put in ``event()["query"]`` where ``event()`` is the keyframe event
        being captured (None where none is)."""
        from orb_line_slam_tpu_torch.loop import loop_closing
        from orb_line_slam_tpu_torch.slam_map import keyframe_db

        def query_probe(fn):
            def wrapper(closer, kf_id):
                ev = event()
                if ev is None:
                    return fn(closer, kf_id)
                q = {"W": np.array(closer.map.covisibility(), copy=True), "db_keys": set(closer.db.bow),
                     "groups": [(set(g), c) for g, c in closer.consistent_groups], "cands": None}
                ev["query"] = q
                q["winner"] = fn(closer, kf_id)
                return q["winner"]
            return wrapper

        def candidates_probe(fn):
            def wrapper(db, *a, **k):
                out = fn(db, *a, **k)
                ev = event()
                if ev is not None and ev["query"] is not None:
                    ev["query"]["cands"] = list(out)
                return out
            return wrapper

        return [(loop_closing.LoopCloser, "_detect", query_probe(loop_closing.LoopCloser._detect)),
                (keyframe_db.KeyFrameDatabase, "detect_loop_candidates",
                 candidates_probe(keyframe_db.KeyFrameDatabase.detect_loop_candidates))]


def closed_loop(probes, seconds: float, whole_passes: bool, open_pass):
    """Closed-loop passes until the first call boundary after ``seconds``
    (with ``whole_passes`` the end of that pass).  ``open_pass(p)`` builds
    pass p's program state (its seconds go to the ``system`` span) and
    returns an object with ``n`` calls, ``prepare(i)`` (untimed),
    ``call(i)`` (timed), ``record(result)`` (the sequence-frames it
    returned not tracked), ``output`` and ``close()`` (timed with the
    construction).  Returns (window seconds, host ms a call, each pass's
    output, frames not tracked)."""
    call_ms, passes, failed = [], [], 0
    t_w0 = time.perf_counter()
    deadline, done, p, t_end = t_w0 + seconds, False, 0, t_w0
    while not done:
        t0 = time.perf_counter()
        run = open_pass(p)
        system_s = time.perf_counter() - t0
        for i in range(run.n):
            probes.where = (p, i)
            run.prepare(i)
            t0 = time.perf_counter()
            result = run.call(i)
            t_end = time.perf_counter()
            call_ms.append((t_end - t0) * 1e3)
            failed += run.record(result)
            if t_end >= deadline and not whole_passes:
                break
        done = t_end >= deadline
        passes.append(run.output)
        t0 = time.perf_counter()
        run.close()
        del run
        if probes.recording:
            probes.spans["system"].append(system_s + time.perf_counter() - t0)
        p += 1
    probes.where = (-1, -1)
    return t_end - t_w0, call_ms, passes, failed


def traced_window(probes, n_calls: int, call, start: int, length: int, sync, tags, noun: str,
                  frames_per_call: int = 1, opened=None, extra=None):
    """A torch.profiler window over calls [start, start + length) of
    ``call(i)``, i < ``n_calls``; a window that comes back without its
    device records, or without a record of each orb_describe and pose_solve
    launch the probes saw, is taken again over the next calls.
    ``opened()`` runs as the window opens, ``extra()`` gives further fields
    of the result as it closes.  Returns the window's raw records, or
    None."""
    from torch.profiler import ProfilerActivity, profile

    from slambench import devtrace, harness

    got, tries, prof, tw0 = None, 0, None, 0.0
    for i in range(n_calls):
        if got is None and prof is None and i == start and tries < harness.MAX_TRACE_TRIES:
            sync()
            probes.describe_calls, probes.pose_calls, probes.tracing = [], [], True
            if opened is not None:
                opened()
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
            tw0 = time.perf_counter()
        call(i)
        if prof is not None and i == start + length - 1:
            sync()
            window_s = time.perf_counter() - tw0
            prof.__exit__(None, None, None)
            probes.tracing = False
            tries += 1
            recs, host, launch_calls = devtrace.read_events(prof, tags)
            prof = None
            ranges = [r for r in recs if r.name in tags]
            ops = [r for r in recs if r.name not in tags and not r.name.startswith("ProfilerStep")]
            own = {k: [r for r in ops if v in r.name] for k, v in harness.KERNELS.items()}
            if ops and len(own["orb_describe"]) == len(probes.describe_calls) \
                    and len(own["pose_solve"]) == len(probes.pose_calls):
                got = SimpleNamespace(frames=length * frames_per_call, window_s=window_s, ops=ops, ranges=ranges,
                                      host=host, launch_calls=launch_calls, own=own,
                                      describe_calls=probes.describe_calls, pose_calls=probes.pose_calls,
                                      first_frame=start, tries=tries, **(extra() if extra is not None else {}))
            else:
                print(f"profile of {noun}s {start}-{i} came back with {len(ops)} device records, "
                      f"{len(own['orb_describe'])} orb_describe of {len(probes.describe_calls)} launches, "
                      f"{len(own['pose_solve'])} pose_solve of {len(probes.pose_calls)}: taken again", flush=True)
                start = i + 1
        if got is not None:
            break
    if prof is not None:           # a retake that ran past the last call
        prof.__exit__(None, None, None)
    probes.tracing = False
    return got
