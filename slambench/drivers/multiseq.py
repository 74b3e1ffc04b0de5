"""The multi-sequence driver: B stereo sequences of one configuration tracked
together by the program's ``MultiSequenceTracker`` (BASELINE #4), one
``process_stereo`` a time step for all B, on the System's default schedule,
which the tracker fixes (loop detection and global BA on worker threads,
deferred local mapping, each sequence's consume on a pool of B threads).
Once every tracker is OK with a carry, a step is one batched frame
(``pipeline/track_step.py::batched_frame_track``: one front end over the 2B
images, the tracking step under ``torch.func.vmap``); before that, and
after a frame whose line mirrors differ, each sequence takes its own.

Traffic keys: ``sequences`` (B); ``steps`` (time steps a pass);
``stagger`` (sequence b plays frames [stagger b, stagger b + steps) of the
rendered sequence, so the sequences' keyframe events do not coincide);
the noise pool (in pass p, sequence b plays copy (p + b) mod the pool's
size of the copies in the order drawn from the seed); ``trace`` (the
traced steps, from ``start_frac`` of a pass); ``check`` (the samples of
``checks/multiseq.py``).  Closed loop: the next step starts when all B
poses are back; each pass a fresh tracker; a window of whole passes.

The probes capture the batched path outside ``vmap``: the batched step's
inputs and outputs around ``batched_frame_track``, the pose solves at the
operator's call with a leading [B] (the vmap rule's, whose tensors are
real), the local BAs and the loop detector's work on the worker threads,
each attributed to its sequence by the objects it runs on."""

from __future__ import annotations

import contextlib
import inspect
import threading
import time
import warnings

import numpy as np

from slambench import check, harness
from slambench.drivers import _common

# The tracker's stages (its own span names), the range the probes put
# around each per-sequence (bootstrap) step, and inside
# batched_frame_track the ones around its parts, the batched front ends and
# the vmapped tracking step (the stereo driver's names of those layers).
# The profiler keeps the device side of the innermost range alone, so no
# range encloses those three: the step's device time is their sum.
STAGES = ("poll_refresh", "gather_inputs", "batched_track", "consume")
BOOTSTRAP = "bootstrap"
STEP_PARTS = ("point_frontend", "line_frontend", "track_step")
RANGE_TAGS = (BOOTSTRAP, *STAGES, *STEP_PARTS)
# The ranges that label the device's idle gaps, outermost first.
LABELS = (BOOTSTRAP, *STAGES)
CALL = "step"
# The program's kernels counted on each traced step's batched_frame_track.
STEP_KERNELS = ("orb_detect", "orb_describe", "stereo_sad", "pose_solve")


def frames_per_call(cell: dict) -> int:
    return int(cell["traffic"]["sequences"])


def make_probes(cell: dict, seed: int) -> "Probes":
    """The probes of a run; the cell's checks install their samples."""
    return Probes()


def pass_sequences(sequences, p: int, n_seq: int):
    """The noise copy each sequence plays in pass ``p``."""
    return [sequences[(p + b) % len(sequences)] for b in range(n_seq)]


def worst_ate(passes, gt_centres, cell: dict):
    """The worst ATE (m) over every pass's sequences, each against its own
    stretch of the rendered ground truth."""
    stagger = int(cell["traffic"]["stagger"])
    worst = None
    for seqs in passes:
        for b, poses in enumerate(seqs):
            if len(poses) < check.MIN_ATE_FRAMES:
                continue
            ate = check.worst_ate([poses], gt_centres[stagger * b:stagger * b + len(poses)])
            worst = ate if worst is None else max(worst, ate)
    return worst


def _at(x, b: int):
    """Sequence b's slice of a tensor or of a NamedTuple of tensors with a
    leading [B]."""
    if x is None:
        return None
    if isinstance(x, tuple):
        return type(x)(*(v[b] for v in x))
    return x[b]


class _Ranged:
    """A stage of the tracker's timer inside a profiler range of its name."""

    def __init__(self, inner, name: str):
        from torch.profiler import record_function

        self.inner, self.range = inner, record_function(name)

    def __enter__(self):
        self.range.__enter__()
        return self.inner.__enter__()

    def __exit__(self, *exc):
        try:
            return self.inner.__exit__(*exc)
        finally:
            self.range.__exit__(None, None, None)


class Probes(_common.BaseProbes):
    """Wraps the batched path's calls from outside.  In the sample pass
    (``where[0] == sample_pass``): a sample of its batched steps
    (``step_sample``, keyed by the step's ordinal among the pass's batched
    steps; ``sequences(k)`` names the sequences it keeps of step k), each
    kept sequence's slice of the step's inputs, front end, pose solves and
    ``TrackOut`` and its raw pair (``batched_steps``); a sample of its
    local BAs (``ba_sample``, keyed by (sequence, ordinal in the
    sequence)); every keyframe's insertion into each sequence's loop
    detector and its query (``loop_by_seq``) and each sequence's
    vocabulary training (``voc_by_seq``).  While recording: the host
    seconds of each local BA on its sequence's mapping worker and of each
    keyframe's loop-closing call.  While ``tracing``: the profiler ranges
    (the tracker's stages, the per-sequence steps, and inside
    ``batched_frame_track`` the front ends and the vmapped tracking step), each
    orb_describe and pose_solve launch's arguments, and each batched step's
    kernel launches.  The common checks' captures (``frontend``, ``steps``,
    ``pose``, ``ba``, ``loop_events``) stay empty on this path."""

    def __init__(self):
        super().__init__()
        self.spans = {"mapping": [], "loop_detect": [], "vocab_train": [], "system": [], "consume": [],
                      "steps": [], "passes": []}
        self.frontend, self.lines, self.pose, self.ba, self.steps = {}, {}, [], [], []
        self.loop_events, self.voc_train = [], None
        self.step_launches = []
        self.step_sample, self.ba_sample = check.Reservoir(), check.Reservoir()
        self.sequences = lambda k: ()
        self.loop_by_seq, self.voc_by_seq = {}, {}
        self.pairs = None
        self.n_batched = 0
        self._step = None
        self._seq = {}
        self._ba_count = {}
        self._tls = threading.local()
        self._warnings = None
        self._seen = None

    def sample(self, step_sample: "check.Reservoir", sequences, ba_sample: "check.Reservoir") -> None:
        """The sample pass's samples: of its batched steps (by ordinal),
        the sequences kept of each step, and of its local BAs."""
        self.step_sample, self.sequences, self.ba_sample = step_sample, sequences, ba_sample

    @property
    def sample_frames(self) -> dict:
        """The kept batched steps' ordinals and sequences."""
        return {k: [b for b, _ in recs] for k, recs in self.step_sample.items()}

    @property
    def batched_steps(self) -> list:
        """(ordinal, sequence, record) of each kept slice, in order."""
        return [(k, b, rec) for k, recs in self.step_sample.items() for b, rec in recs]

    def window_note(self) -> str:
        steps = self.spans["steps"]
        passes = " ".join(f"{n}/{t:.3f}" for n, t in self.spans["passes"])
        return ("; steps batched, per sequence while bootstrapping, per sequence for line mirrors of different "
                f"capacities: {[sum(s[i] for s in steps) for i in range(3)]} over {len(steps)} passes; steps/s "
                f"of each pass from its tracker's construction to its last step: {passes}")

    @property
    def vmap_fallbacks(self) -> list[str]:
        """The vmap fallback warnings seen since the probes were entered."""
        return sorted({str(w.message)[:160] for w in self._seen or () if "batching rule" in str(w.message).lower()})

    def bind(self, mst) -> None:
        """A new pass's tracker: its sequences' objects by identity, its
        stages and per-sequence steps inside profiler ranges while tracing."""
        self.n_batched = 0
        self._ba_count = {}
        self._seq = {}
        for b, s in enumerate(mst.systems):
            for obj in (s, s.tracker, s.tracker.map):
                self._seq[id(obj)] = b
        stage, per_sequence = mst.timing.stage, mst._per_sequence

        def ranged_stage(name, children=False):
            inner = stage(name, children)
            return _Ranged(inner, name) if self.tracing and name in STAGES else inner

        def ranged_per_sequence(*a):
            if not self.tracing:
                return per_sequence(*a)
            with _Ranged(contextlib.nullcontext(), BOOTSTRAP):
                return per_sequence(*a)

        mst.timing.stage = ranged_stage
        mst._per_sequence = ranged_per_sequence

    def _launches(self) -> dict:
        return {k: m.launches for k, m in self._kernels.items()}

    def __enter__(self):
        import torch
        from orb_line_slam_tpu_torch.backend import pose_opt
        from orb_line_slam_tpu_torch.loop import loop_closing, vocabulary
        from orb_line_slam_tpu_torch.ops import describe, detect, stereo_sad
        from orb_line_slam_tpu_torch.parallel import multi_sequence
        from orb_line_slam_tpu_torch.pipeline import system, tracking
        from orb_line_slam_tpu_torch.pipeline import track_step as step
        from orb_line_slam_tpu_torch.slam_map import keyframe_db, map_store

        self._kernels = {"orb_detect": detect, "orb_describe": describe, "stereo_sad": stereo_sad,
                         "pose_solve": pose_opt}
        step_names = [p for p in inspect.signature(step.track_step).parameters
                      if p not in ("frame", "lf", "cfg", "has_lines")]
        wrapped = torch._C._functorch.is_functorch_wrapped_tensor
        tls, lock = self._tls, self._lock

        def event():
            return getattr(tls, "event", None)

        def batched_probe(fn):
            def wrapper(left, right, stacked, cfg, has_lines):
                k = self.n_batched
                self.n_batched += 1
                seqs = self.sequences(k) if self._sample_pass() and self.step_sample.wants(k) else ()
                if seqs:
                    self._step = {"solves": [], "seqs": seqs, "thread": threading.get_ident()}
                before = self._launches() if self.tracing else None
                try:
                    out = fn(left, right, stacked, cfg, has_lines)
                finally:
                    rec, self._step = self._step, None
                if before is not None:
                    after = self._launches()
                    self.step_launches.append({n: after[n] - before[n] for n in STEP_KERNELS})
                if seqs:
                    self._keep_step(k, seqs, rec, stacked, out, cfg, has_lines, step_names)
                return out
            return wrapper

        def solve_probe(fn):
            # The pose solve operator, called by pose_optimize (under vmap
            # with wrapped tensors: left to the rule's call below) and by
            # its vmap rule with the B solves' real [B, ...] tensors.
            def wrapper(*a):
                out = fn(*a)
                if wrapped(a[0]):
                    return out
                rec = self._step
                if rec is not None and a[0].dim() == 3 and rec["thread"] == threading.get_ident():
                    rec["solves"].append({b: {"op": tuple(x[b].detach().clone() for x in a[:11]) + tuple(a[11:16]),
                                              "rounds": a[16], "iters": a[17],
                                              "result": tuple(o[b].detach().clone() for o in out[:5])}
                                          for b in rec["seqs"]})
                if self.tracing:
                    call = {"op": tuple(x.detach().clone() for x in a[:11]) + tuple(a[11:16]),
                            "rounds": a[16], "iters": a[17]}
                    with lock:
                        self.pose_calls.append(call)
                return out
            return wrapper

        def ba_probe(fn):
            def wrapper(tracker, pack, lpack, line0):
                t0 = time.perf_counter()
                out = fn(tracker, pack, lpack, line0)
                if self.recording:
                    with lock:
                        self.spans["mapping"].append(time.perf_counter() - t0)
                b = self._seq.get(id(tracker))
                if b is None or not self._sample_pass():
                    return out
                with lock:
                    n = self._ba_count.get(b, 0)
                    self._ba_count[b] = n + 1
                    if not self.ba_sample.wants((b, n)):
                        return out
                    cp = lambda d: None if d is None else {  # noqa: E731
                        k: (np.array(v, copy=True) if isinstance(v, np.ndarray) else v) for k, v in d.items()}
                    self.ba_sample.offer((b, n), {
                        "pack": cp(pack), "lpack": cp(lpack),
                        "line0": None if line0 is None else tuple(np.array(x, copy=True) for x in line0),
                        "result": out[0]})
                return out
            return wrapper

        def keyframe_probe(fn):
            def wrapper(sys_self, kf_id):
                tls.system = self._seq.get(id(sys_self))
                t0 = time.perf_counter()
                try:
                    return fn(sys_self, kf_id)
                finally:
                    tls.system = None
                    if self.recording:
                        with lock:
                            self.spans["loop_detect"].append(time.perf_counter() - t0)
            return wrapper

        def keep_training(train):
            b = getattr(tls, "system", None)
            if b is not None:
                with lock:
                    self.voc_by_seq[b] = train

        def job_probe(fn):
            # One keyframe's detection job on its loop closer's worker: the
            # BoW transform, the insertion, the gate and the query.
            def wrapper(closer, kf_id, gen, count):
                b = self._seq.get(id(closer.map))
                if b is None or not self._sample_pass():
                    return fn(closer, kf_id, gen, count)
                ev = {"kf": int(kf_id), "desc": None, "valid": None, "words": None, "gen_ok": False,
                      "gate": False, "query": None}
                tls.event, tls.job = ev, (closer, count)
                try:
                    return fn(closer, kf_id, gen, count)
                finally:
                    tls.event = tls.job = None
                    if ev["desc"] is not None:     # the job reached the transform
                        if ev["valid"] is None:
                            ev["valid"] = np.ones(len(ev["desc"]), bool)
                        with lock:
                            self.loop_by_seq.setdefault(b, []).append(ev)
            return wrapper

        def transform_probe(fn):
            def wrapper(voc, descs):
                out = fn(voc, descs)
                ev = event()
                if ev is not None and ev["desc"] is None:
                    ev["desc"] = descs.detach().cpu().numpy().copy()
                    ev["words"] = out.detach().cpu().numpy().copy()
                return out
            return wrapper

        def add_probe(fn):
            def wrapper(db, kf_id, words, valid):
                out = fn(db, kf_id, words, valid)
                ev = event()
                if ev is not None and ev["kf"] == kf_id:
                    ev["valid"], ev["gen_ok"], ev["added"] = np.array(valid, copy=True), True, True
                return out
            return wrapper

        def n_keyframes_probe(fn):
            # The job's gate reads the keyframe count first, right after the
            # insertion; the loop count and the parked loop beside it.
            def wrapper(store):
                n = fn(store)
                ev = event()
                if ev is not None and ev.get("added") and "n_keyframes" not in ev:
                    closer, count = tls.job
                    ev["n_keyframes"] = n
                    ev["gate"] = bool(n >= 6 and count - closer.last_loop_count >= 10
                                      and closer._pending_loop is None)
                return n
            return wrapper

        self._install([
            (multi_sequence, "batched_frame_track", batched_probe(multi_sequence.batched_frame_track)),
            (step, "build_stereo_frames", self._ranged(step.build_stereo_frames, "point_frontend")),
            (step, "build_line_features", self._ranged(step.build_line_features, "line_frontend")),
            (step, "track_step", self._ranged(step.track_step, "track_step")),
            (pose_opt, "pose_solve", solve_probe(pose_opt.pose_solve)),
            (tracking.Tracker, "_solve_ba", ba_probe(tracking.Tracker._solve_ba)),
            (system.System, "_on_keyframe", keyframe_probe(system.System._on_keyframe)),
            self.train_patch(keep_training),
            (vocabulary.Vocabulary, "dispatch_transform", transform_probe(vocabulary.Vocabulary.dispatch_transform)),
            (loop_closing.LoopCloser, "_detect_job", job_probe(loop_closing.LoopCloser._detect_job)),
            (keyframe_db.KeyFrameDatabase, "add_words", add_probe(keyframe_db.KeyFrameDatabase.add_words)),
            (map_store.MapStore, "n_keyframes", n_keyframes_probe(map_store.MapStore.n_keyframes)),
            *self.query_patches(event),
            *self.kernel_patches(),
        ])
        # functorch warns where an operator has no batching rule and it
        # loops over the batch instead: such warnings are counted.
        torch._C._functorch._set_vmap_fallback_warning_enabled(True)
        self._warnings = warnings.catch_warnings(record=True)
        self._seen = self._warnings.__enter__()
        warnings.filterwarnings("always", message=".*[Bb]atching rule.*")
        return self

    def __exit__(self, *exc):
        import torch

        self._warnings.__exit__(*exc)
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
        super().__exit__(*exc)

    def _keep_step(self, k, seqs, rec, stacked, out, cfg, has_lines, step_names) -> None:
        """Each sampled sequence's slice of a batched step, cloned: the
        track_step arguments, the frame, line features and TrackOut, the
        pose solves in order (the operator's arguments), the raw pair."""
        frames, lfs, outs = out
        if len(stacked) != len(step_names):
            raise RuntimeError(f"batched_frame_track took {len(stacked)} stacked inputs, track_step names "
                               f"{len(step_names)}")
        recs = []
        for b in seqs:
            args = {name: harness.snapshot(_at(x, b)) for name, x in zip(step_names, stacked)}
            args["has_lines"] = bool(has_lines)
            recs.append((b, {
                "step": self.where[1], "args": args, "frame": harness.snapshot(_at(frames, b)),
                "lf": harness.snapshot(_at(lfs, b)), "out": harness.snapshot(_at(outs, b)),
                "solves": [s[b] for s in rec["solves"]], "pair": (self.pairs[0][b], self.pairs[1][b]),
                "cam": tuple(cfg.camera), "scale_factor": float(cfg.orb.scale_factor),
                "n_levels": int(cfg.orb.n_levels)}))
        self.step_sample.offer(k, recs)


class _Pass:
    """One pass of ``replay``: a fresh ``MultiSequenceTracker`` of B
    sequences over pass p's noise copies."""

    def __init__(self, probes: Probes, cfg, cell: dict, sequences, p: int, device: str):
        from orb_line_slam_tpu_torch.parallel.multi_sequence import MultiSequenceTracker

        config, traffic = cell["config"], cell["traffic"]
        self.t0 = self.t_last = time.perf_counter()
        self.probes = probes
        self.n_seq, self.stagger, self.n = int(traffic["sequences"]), int(traffic["stagger"]), int(traffic["steps"])
        self.dt = 1.0 / float(config["fps"])
        self.mst = MultiSequenceTracker(cfg, self.n_seq, device=device)
        probes.bind(self.mst)
        self.seqs = pass_sequences(sequences, p, self.n_seq)
        self.output = [[] for _ in range(self.n_seq)]

    def prepare(self, i: int) -> None:
        self.lefts = [self.seqs[b][self.stagger * b + i][0] for b in range(self.n_seq)]
        self.rights = [self.seqs[b][self.stagger * b + i][1] for b in range(self.n_seq)]
        self.probes.pairs = (self.lefts, self.rights)

    def call(self, i: int):
        return self.mst.process_stereo(self.lefts, self.rights, [self.dt * i] * self.n_seq)

    def record(self, T) -> int:
        self.t_last = time.perf_counter()
        failed = 0
        for b, t in enumerate(self.mst.trackers):
            failed += t.state != "OK"
            self.output[b].append(np.asarray(T[b], np.float64))
        return failed

    def close(self) -> None:
        mst = self.mst
        counts = (mst.n_batched_frames, mst.n_bootstrap_frames, mst.n_mixed_line_frames)
        consume = (mst.timing.acc.get("consume", 0.0), mst.timing.cnt.get("consume", 0))
        mst.shutdown()
        self.mst = None
        if self.probes.recording:
            self.probes.spans["consume"].append(consume)
            self.probes.spans["steps"].append(counts)
            self.probes.spans["passes"].append((len(self.output[0]), self.t_last - self.t0))


def replay(prog, cfg, cell: dict, sequences, probes: Probes, seconds: float, device: str, whole_passes=True):
    """Closed-loop passes, each a fresh ``MultiSequenceTracker`` of B
    sequences, until the end of the pass in which ``seconds`` run out: a
    pass starts slowly (the tracker's construction, the bootstrap steps,
    the first keyframes' vocabulary trainings), so a window cut inside one
    would read where the cut fell.  Returns (window seconds, host ms a
    step, each pass's B returned trajectories of 4x4 Tcw, sequence-frames
    returned while their sequence was not OK)."""
    out = _common.closed_loop(probes, seconds, True, lambda p: _Pass(probes, cfg, cell, sequences, p, device))
    probes.pairs = None
    return out


def traced_pass(prog, cfg, cell: dict, sequences, probes: Probes, device: str, sync):
    """A fresh pass (pass 0's copies) with a torch.profiler window over the
    traffic's traced steps (a window that comes back without its device
    records is taken again over the next steps).  Returns the window's raw
    records."""
    trace = cell["traffic"]["trace"]
    run = _Pass(probes, cfg, cell, sequences, 0, device)
    length, batched0 = int(trace["steps"]), [0]

    def call(i):
        run.prepare(i)
        run.call(i)

    def opened():
        probes.step_launches, batched0[0] = [], run.mst.n_batched_frames

    def extra():
        batched = run.mst.n_batched_frames - batched0[0]
        return {"steps": length, "batched": batched, "step_launches": probes.step_launches,
                "note": (f"; {batched} of the {length} traced steps batched, kernel launches on each batched "
                         f"step's batched_frame_track {sorted({tuple(s.values()) for s in probes.step_launches})} "
                         f"({', '.join(STEP_KERNELS)}); vmap fallbacks {probes.vmap_fallbacks}")}

    got = _common.traced_window(probes, run.n, call, int(trace["start_frac"] * run.n), length, sync, RANGE_TAGS,
                                CALL, run.n_seq, opened, extra)
    run.close()
    sync()
    return got
