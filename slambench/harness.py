"""The benchmark of orb_line_slam_tpu_torch: one cell, one run.

A cell (``cells/<name>.json``) names a configuration (``configs/``: the
camera, ORB and line budgets, map capacities and the rendered scene) and
a traffic mix (``traffic/``: how the sequence is replayed, its sensor
noise, the traced frames and the checks' samples); the per-layer and
end-to-end metrics are one reader each in ``metrics/<name>.py``, found by
the names ``BENCHMARK.json`` gives the cell.  Adding a configuration, a
traffic mix or a metric adds files only.

A run renders the cell's sequence from ``--seed`` (the sensor noise),
warms up on one whole pass, then replays the sequence closed loop for
``--seconds``: each pass a fresh ``System``, each frame handed to
``System.track_stereo`` when the last pose has come back.  Nothing the
harness runs imports JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# Top-level module names that may not be loaded in a run, compared whole:
# the program's own name begins with the JAX package's.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "orb_line_slam_tpu")
RANGE_TAGS = ("point_frontend", "line_frontend", "track_step", "mapping", "loop_detect")
KERNELS = {"orb_describe": "orb_describe_kernel", "stereo_sad": "stereo_sad_kernel", "pose_solve": "pose_solve_kernel"}
MAX_TRACE_TRIES = 3


# ---------------------------------------------------------------------------
# Data: cells, configurations, traffic mixes and metric readers by name.

def load_json(kind: str, name: str) -> dict:
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} entry named {name!r}: {path} is missing")
    return json.loads(path.read_text())


def load_cell(name: str) -> dict:
    """The cell's file with its configuration and traffic mix read in."""
    cell = load_json("cells", name)
    return {**cell, "name": name, "config": load_json("configs", cell["config"]),
            "traffic": load_json("traffic", cell["traffic"])}


def load_metric(name: str):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"slambench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def benchmark_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_metrics(spec: dict, cell: str, trace: bool) -> list[dict]:
    """The end-to-end (trace 0) or per-layer (trace 1) metrics of a cell."""
    return [m for m in spec["per_layer" if trace else "end_to_end"] if "workloads" not in m or cell in m["workloads"]]


def slam_config(mod, config: dict):
    """A SlamConfig of ``mod`` (the program's config module) from a
    configuration file's settings."""
    c = config
    return mod.SlamConfig(camera=mod.CameraIntrinsics(**c["camera"]), orb=mod.OrbConfig(**c["orb"]),
                          lines=mod.LineConfig(**c["lines"]), tracking=mod.TrackingConfig(**c["tracking"]),
                          map=mod.MapConfig(**c["map"]), fps=float(c["fps"]))


def render_sequence(config: dict, traffic: dict, n_frames: int, seed: int, processes=None):
    """(ground-truth poses, [stereo pairs of each pass]) of the cell's
    sequence: one copy per sensor-noise draw of the traffic's pool, in an
    order drawn from ``seed``.  Every seed replays the same draws, so the
    work of a window does not follow the seed; the window's n-th pass
    plays copy n modulo the pool's size."""
    from . import render

    cam = render.Camera(**{k: config["camera"][k] for k in render.Camera._fields})
    sc = config["scene"]
    scene = render.SyntheticScene(cam, n_points=sc["points"], n_lines=sc.get("lines", 0), extent=sc["extent"],
                                  seed=sc["seed"])
    for more in sc.get("extend", ()):
        render.extend_scene(scene, render.SyntheticScene(cam, n_points=more["points"], extent=more["extent"],
                                                         seed=more["seed"]))
    tr = config["trajectory"]
    if tr["kind"] != "forward":
        raise ValueError(f"unknown trajectory kind {tr['kind']!r}")
    poses = render.circular_trajectory(n_frames, step=tr["step_m"])
    clean = render.render_frames(scene, poses, processes)
    pool = traffic["noise_pool"]
    order = np.random.default_rng(int(seed) % 2 ** 63).permutation(len(pool))
    copies = render.noisy_copies(clean, float(traffic["noise_sigma"]), [pool[i] for i in order], processes)
    return poses, copies


# ---------------------------------------------------------------------------
# Probes: the benchmark's wrappers around the program's layer calls.

def snapshot(x):
    """A copy of a tensor, or of a NamedTuple of tensors, detached from
    what the program writes later; anything else as it is."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(snapshot(v) for v in x))
    return x


class Probes:
    """Wraps the program's layer entry points from outside: host-clock spans
    of the mapping and loop-detection calls on the tracking thread, the
    samples the checks compare (in the sample pass: the sampled frames'
    front ends, tracking steps and pose solves, the local BAs, every
    keyframe's insertion into the loop detector and its query), and (while
    ``tracing``) a profiler range around each layer call and the arguments
    of each hand-written kernel's launch.  ``where`` is the (pass, frame)
    being tracked."""

    def __init__(self, sample_frames=()):
        self.where = (-1, -1)
        self.sample_pass = 0
        self.sample_frames = set(sample_frames)
        self.recording = False
        self.tracing = False
        self.spans = {"mapping": [], "loop_detect": [], "vocab_train": [], "system": []}
        self.frontend, self.lines, self.pose, self.ba = {}, {}, [], []
        self.steps, self.loop_events, self.voc_train = [], [], None
        self.describe_calls, self.pose_calls = [], []
        self._valid = None
        self._step = None
        self._event = None
        self._saved = []

    def _sampling(self) -> bool:
        return self.where[0] == self.sample_pass and self.where[1] in self.sample_frames

    def _sample_pass(self) -> bool:
        return self.where[0] == self.sample_pass

    def _ranged(self, fn, tag):
        from torch.profiler import record_function

        def wrapper(*a, **k):
            if not self.tracing:
                return fn(*a, **k)
            with record_function(tag):
                return fn(*a, **k)
        return wrapper

    def __enter__(self):
        import torch
        from orb_line_slam_tpu_torch.frontend import orb_extractor as orb
        from orb_line_slam_tpu_torch.loop import loop_closing, vocabulary
        from orb_line_slam_tpu_torch.pipeline import system, tracking
        from orb_line_slam_tpu_torch.pipeline import track_step as step
        from orb_line_slam_tpu_torch.slam_map import keyframe_db

        from . import check

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
                rec = {"args": {n: snapshot(v) for n, v in check._bind(fn, a, k).items()}, "solves": []}
                self._step = rec
                try:
                    out = fn(*a, **k)
                finally:
                    self._step = None
                rec["out"] = snapshot(out)
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

        def train_probe(fn):
            def wrapper(*a, **k):
                t0 = time.perf_counter()
                out = fn(*a, **k)
                if self.recording:
                    self.spans["vocab_train"].append(time.perf_counter() - t0)
                if self._sample_pass():
                    kw = check._bind(fn, a, k)
                    self.voc_train = {**kw, "descriptors": np.array(kw["descriptors"], copy=True)}
                return out
            return wrapper

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

        def query_probe(fn):
            def wrapper(closer, kf_id):
                if self._event is None:
                    return fn(closer, kf_id)
                q = {"W": np.array(closer.map.covisibility(), copy=True), "db_keys": set(closer.db.bow),
                     "groups": [(set(g), c) for g, c in closer.consistent_groups], "cands": None}
                self._event["query"] = q
                q["winner"] = fn(closer, kf_id)
                return q["winner"]
            return wrapper

        def candidates_probe(fn):
            def wrapper(db, *a, **k):
                out = fn(db, *a, **k)
                if self._event is not None and self._event["query"] is not None:
                    self._event["query"]["cands"] = list(out)
                return out
            return wrapper

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

        patches = [
            (tracking, "build_stereo_frame",
             self._ranged(sample_probe(tracking.build_stereo_frame, self.frontend), "point_frontend")),
            (tracking, "build_line_features",
             self._ranged(sample_probe(tracking.build_line_features, self.lines), "line_frontend")),
            (tracking, "track_step", self._ranged(step_probe(tracking.track_step), "track_step")),
            (tracking, "_solve_local_ba", self._ranged(ba_probe(tracking._solve_local_ba), "mapping")),
            (tracking, "pose_optimize", pose_probe(tracking.pose_optimize, False)),
            (step, "pose_optimize", pose_probe(step.pose_optimize, True)),
            (system.System, "_on_keyframe", self._ranged(loop_probe(system.System._on_keyframe), "loop_detect")),
            (vocabulary.Vocabulary, "train", staticmethod(train_probe(vocabulary.Vocabulary.train))),
            (loop_closing.LoopCloser, "_process_resolved", insert_probe(loop_closing.LoopCloser._process_resolved)),
            (loop_closing.LoopCloser, "_detect", query_probe(loop_closing.LoopCloser._detect)),
            (keyframe_db.KeyFrameDatabase, "detect_loop_candidates",
             candidates_probe(keyframe_db.KeyFrameDatabase.detect_loop_candidates)),
            (orb, "_detect_all_levels", detect_probe(orb._detect_all_levels)),
            (orb, "describe_keypoints", describe_probe(orb.describe_keypoints)),
        ]
        for obj, name, new in patches:
            # A class keeps its own entry (a staticmethod stays one).
            self._saved.append((obj, name, vars(obj)[name] if isinstance(obj, type) else getattr(obj, name)))
            setattr(obj, name, new)
        return self

    def __exit__(self, *exc):
        for obj, name, fn in reversed(self._saved):
            setattr(obj, name, fn)
        self._saved = []


# ---------------------------------------------------------------------------

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


def host_probe() -> tuple[float, float]:
    """Wall time (ms) of a fixed pure-Python loop, min and median of 7: how
    much host CPU this process gets (after chip_smoke.py::host_probe)."""
    times = []
    for _ in range(7):
        t0 = time.perf_counter()
        acc = 0
        for i in range(200_000):
            acc += i * i
        times.append((time.perf_counter() - t0) * 1e3)
    return min(times), float(np.median(times))


def card_line() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "nvidia-smi: no answer"


def check_frames(seed: int, n_frames: int, chk: dict) -> list[int]:
    """The frames of the window's first pass whose front end and pose solves
    the checks compare, drawn from the seed."""
    rng = np.random.default_rng(int(seed) % 2 ** 63)
    return sorted(rng.choice(np.arange(2, n_frames), size=chk["frames"], replace=False).tolist())


def pick_bas(seed: int, probes: "Probes", chk: dict) -> list[int]:
    """Keep ``chk["ba_calls"]`` of the local BAs the window's first pass
    solved, drawn from the seed; returns their ordinals."""
    rng = np.random.default_rng((int(seed) % 2 ** 63, 1))
    n = len(probes.ba)
    keep = sorted(rng.choice(n, size=min(n, chk["ba_calls"]), replace=False).tolist())
    probes.ba = [probes.ba[i] for i in keep]
    return keep


def load_program(device: str):
    """The program's modules the harness drives, and the seconds the
    kernel build or load took."""
    import torch
    from orb_line_slam_tpu_torch import config as program_config
    from orb_line_slam_tpu_torch.backend import pose_opt
    from orb_line_slam_tpu_torch.ops import _build, describe, stereo_sad
    from orb_line_slam_tpu_torch.pipeline.system import System
    t0 = time.perf_counter()
    if torch.device(device).type == "cuda":
        _build.build(tuple(KERNELS))
    build_s = time.perf_counter() - t0
    kernels = {"orb_describe": describe, "stereo_sad": stereo_sad, "pose_solve": pose_opt}
    return SimpleNamespace(System=System, config=program_config, kernels=kernels, build_s=build_s)


def replay(prog, cfg, cell: dict, sequences, probes: Probes, seconds: float, device: str, whole_passes=False):
    """Closed-loop passes, each a fresh System, pass n over the stereo pairs
    ``sequences[n % len(sequences)]``, until the first frame boundary after
    ``seconds`` (with ``whole_passes`` the end of that pass).  Returns
    (window seconds, host ms a frame, each pass's returned Tcw, frames not
    tracked)."""
    config, traffic = cell["config"], cell["traffic"]
    dt = 1.0 / float(config["fps"])
    frame_ms, passes, failed = [], [], 0
    t_w0 = time.perf_counter()
    deadline, done, p, t_end = t_w0 + seconds, False, 0, t_w0
    while not done:
        t0 = time.perf_counter()
        slam = make_system(prog.System, cfg, traffic, bool(config["loop_closing"]), device)
        system_s = time.perf_counter() - t0
        out = []
        for i, (left, right) in enumerate(sequences[p % len(sequences)]):
            probes.where = (p, i)
            t0 = time.perf_counter()
            T = slam.track_stereo(left, right, timestamp=dt * i)
            t_end = time.perf_counter()
            frame_ms.append((t_end - t0) * 1e3)
            failed += slam.tracking_state() != "OK"
            out.append(np.asarray(T, np.float64))
            if t_end >= deadline and not whole_passes:
                break
        done = t_end >= deadline
        passes.append(out)
        t0 = time.perf_counter()
        slam.shutdown()
        del slam
        if probes.recording:
            probes.spans["system"].append(system_s + time.perf_counter() - t0)
        p += 1
    probes.where = (-1, -1)
    return t_end - t_w0, frame_ms, passes, failed


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, t_start: float, device: str = "cuda",
             log=print, rendered=None) -> dict:
    """One run of a cell: set-up, the measured window, with ``trace`` a
    profiled pass, then the checks.  ``rendered`` is (poses, copies, render
    seconds) of the cell's sequence where the caller rendered it first.
    Returns the run's record (the ``run`` the metric readers read, the
    checks' numbers, the peak device memory)."""
    config, traffic = cell["config"], cell["traffic"]
    n = int(cell["n_frames"])
    sample_frames = check_frames(seed, n, traffic["check"])
    if rendered is None:
        t0 = time.perf_counter()
        rendered = (*render_sequence(config, traffic, n, seed), time.perf_counter() - t0)
    poses, sequences, render_s = rendered
    t0 = time.perf_counter()
    import torch

    prog = load_program(device)
    import_s = time.perf_counter() - t0 - prog.build_s

    dev = torch.device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    cfg = slam_config(prog.config, config)
    probes = Probes(sample_frames)
    with probes:
        # Warm-up: one whole pass, so every shape and lazy initialisation
        # the window meets has been met.
        t0 = time.perf_counter()
        probes.sample_pass = -1
        _, warm_ms, _, _ = replay(prog, cfg, cell, sequences, probes, 0.0, device, whole_passes=True)
        gc.collect()
        sync()
        warmup_s = time.perf_counter() - t0
        setup_s = time.perf_counter() - t_start
        log(f"set-up {setup_s:.3f} s: imports {import_s:.3f}, render {render_s:.3f} ({n} stereo pairs, "
            f"{len(sequences)} noise draws), kernel build/load {prog.build_s:.3f}, warm-up pass {warmup_s:.3f} "
            f"(frames 0-9 {sum(warm_ms[:10]) / 1e3:.3f} s: {' '.join(f'{x:.0f}' for x in warm_ms[:10])} ms; "
            f"the other {len(warm_ms) - 10} {sum(warm_ms[10:]) / 1e3:.3f} s)")

        # The measured window: closed-loop passes, each a fresh System.
        for mod in prog.kernels.values():
            mod.launches = 0
        probes.sample_pass, probes.recording = 0, True
        window_s, frame_ms, passes, failed = replay(prog, cfg, cell, sequences, probes, seconds, device)
        probes.recording = False
        attempted = len(frame_ms)
        launches = {k: m.launches for k, m in prog.kernels.items()}
        peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
        log(f"window {window_s:.3f} s: {attempted} frames in {len(passes)} passes ({len(passes[-1])} in the last), "
            f"{failed} not tracked; {len(probes.spans['loop_detect'])} keyframe events, "
            f"{len(probes.spans['mapping'])} local BAs on the tracking thread; kernel launches {json.dumps(launches)}; "
            f"System construction and shutdown {sum(probes.spans['system']):.3f} s, vocabulary training "
            f"{sum(probes.spans['vocab_train']):.3f} s ({len(probes.spans['vocab_train'])} trainings)")

        traced = traced_pass(prog, cfg, cell, sequences[0], probes, device, sync) if trace else None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # The checks, once the window has closed and the program's state is freed.
    t0 = time.perf_counter()
    n_ba = len(probes.ba)
    ba_ordinals = pick_bas(seed, probes, traffic["check"])
    numbers = checked_numbers(probes, sequences[0], poses, passes, config, dev)
    numbers["frames_not_tracked"] = failed
    if traced is not None:
        finish_trace(traced, config, dev)
    log(f"checks {time.perf_counter() - t0:.3f} s over frames {sample_frames} of the window's first pass, local "
        f"BAs {ba_ordinals} of its {n_ba}, {len(probes.pose)} pose solves, {len(probes.loop_events)} keyframe "
        f"insertions into the loop detector; numbers {json.dumps(numbers)} (not compared: ate_m, the worst pass's "
        f"ATE against the rendered ground truth; the widest pose gaps; pose_gap_medians, each path's [rad, m, "
        f"solves]; loop_queries, [queries due, with candidates, insertions])")

    run = SimpleNamespace(setup_s=setup_s, window_s=window_s, frame_ms=frame_ms, attempted=attempted,
                          failed=failed, tracked=attempted - failed, passes=len(passes), spans=probes.spans,
                          launches=launches, trace=traced, lines=bool(config["lines"]["enabled"]))
    return {"run": run, "numbers": numbers, "memory_peak_bytes": peak}


def checked_numbers(probes: Probes, frames, poses, passes, config: dict, dev) -> dict:
    """The checks' numbers: the layers captured in the window's first pass
    (over the stereo pairs ``frames``) against the reference, and the worst
    pass's ATE against the rendered ground truth."""
    from . import check

    numbers = check.program_numbers(probes, frames, check.ref_slam_config(config), dev)
    gt = check.centres(np.stack([R for R, _ in poses]), np.stack([t for _, t in poses]))
    numbers["ate_m"] = check.worst_ate(passes, gt) if passes else None
    return numbers


def pass_numbers(prog, cfg, cell: dict, seed: int, rendered, device: str = "cuda", control: bool = False) -> dict:
    """The checks' numbers of one closed-loop pass of the cell's sequence as
    a run's window starts it (``seed``'s first noise draw, the samples drawn
    from ``seed``; ``rendered`` is render_sequence's (poses, copies)): the
    program's against the reference, and with ``control`` the control's
    and the worst ATE of a pass of the program itself with TF32 switched
    on."""
    import torch

    from . import check

    config, traffic = cell["config"], cell["traffic"]
    poses, sequences = rendered
    frames = sequences[0]
    dev = torch.device(device)
    probes = Probes(check_frames(seed, int(cell["n_frames"]), traffic["check"]))
    probes.recording = True
    with probes:
        window_s, frame_ms, passes, failed = replay(prog, cfg, cell, [frames], probes, 0.0, device, whole_passes=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    row = {"seed": seed, "frames": len(frame_ms), "failed": failed, "fps": (len(frame_ms) - failed) / window_s,
           "keyframes": len(probes.spans["loop_detect"]), "bas": len(probes.spans["mapping"])}
    pick_bas(seed, probes, traffic["check"])
    t0 = time.perf_counter()
    row["program"] = {**checked_numbers(probes, frames, poses, passes, config, dev), "frames_not_tracked": failed}
    row["check_s"] = time.perf_counter() - t0
    if control:
        ref_cfg = check.ref_slam_config(config)
        row["control"] = check.control_numbers(probes, frames, ref_cfg, dev)
        with check.precision(True), Probes() as tf32:
            _, _, tf32_passes, tf32_failed = replay(prog, cfg, cell, [frames], tf32, 0.0, device, whole_passes=True)
        gt = check.centres(np.stack([R for R, _ in poses]), np.stack([t for _, t in poses]))
        row["control"]["ate_m"] = check.worst_ate(tf32_passes, gt)
        row["control"]["frames_not_tracked"] = tf32_failed
    return row


def traced_pass(prog, cfg, cell: dict, frames, probes: Probes, device: str, sync):
    """A fresh pass with a torch.profiler window over the traffic's traced
    frames (a window that comes back without its device records is taken
    again over the next frames).  Returns the window's raw records."""
    from torch.profiler import ProfilerActivity, profile

    from . import devtrace

    config, traffic = cell["config"], cell["traffic"]
    dt = 1.0 / float(config["fps"])
    n = len(frames)
    length = int(traffic["trace"]["frames"])
    start = int(traffic["trace"]["start_frac"] * n)
    slam = make_system(prog.System, cfg, traffic, bool(config["loop_closing"]), device)
    got, tries, prof, tw0 = None, 0, None, 0.0
    for i, (left, right) in enumerate(frames):
        if got is None and prof is None and i == start and tries < MAX_TRACE_TRIES:
            sync()
            probes.describe_calls, probes.pose_calls, probes.tracing = [], [], True
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
            tw0 = time.perf_counter()
        slam.track_stereo(left, right, timestamp=dt * i)
        if prof is not None and i == start + length - 1:
            sync()
            window_s = time.perf_counter() - tw0
            prof.__exit__(None, None, None)
            probes.tracing = False
            tries += 1
            recs, host, launch_calls = devtrace.read_events(prof, RANGE_TAGS)
            prof = None
            ranges = [r for r in recs if r.name in RANGE_TAGS]
            ops = [r for r in recs if r.name not in RANGE_TAGS and not r.name.startswith("ProfilerStep")]
            own = {k: [r for r in ops if v in r.name] for k, v in KERNELS.items()}
            if ops and len(own["orb_describe"]) == len(probes.describe_calls) \
                    and len(own["pose_solve"]) == len(probes.pose_calls):
                got = SimpleNamespace(frames=length, window_s=window_s, ops=ops, ranges=ranges, host=host,
                                      launch_calls=launch_calls, own=own, describe_calls=probes.describe_calls,
                                      pose_calls=probes.pose_calls, first_frame=start, tries=tries)
            else:
                print(f"profile of frames {start}-{i} came back with {len(ops)} device records, "
                      f"{len(own['orb_describe'])} orb_describe of {len(probes.describe_calls)} launches, "
                      f"{len(own['pose_solve'])} pose_solve of {len(probes.pose_calls)}: taken again", flush=True)
                start = i + 1
        if got is not None:
            break
    if prof is not None:           # a retake that ran past the last frame
        prof.__exit__(None, None, None)
    slam.shutdown()
    del slam
    probes.tracing = False
    sync()
    return got


def finish_trace(tr, config: dict, dev) -> None:
    """Device time per range and kernel, busy union, idle gaps, and the
    needed work of each kernel launch in the traced window (the pose
    solves' round masks from the reference's plain solve)."""
    import torch

    from . import check, need
    from . import devtrace
    from .ref.backend import pose_opt as ref_pose_opt

    tr.range_times = devtrace.range_device_times(tr.ops, tr.ranges, RANGE_TAGS)
    busy = devtrace.busy_intervals(tr.ops)
    tr.busy_s = sum(b - a for a, b in busy) / 1e6
    lo = min(a for a, _ in busy)
    hi = max(b for _, b in busy)
    gaps = devtrace.idle_gaps(busy, lo, hi)
    idle = {}
    for a, b in gaps:
        label = devtrace.host_label(b, tr.host, RANGE_TAGS)
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    tr.idle_by_host = sorted(idle.items(), key=lambda kv: -kv[1])
    by_name = {}
    for r in tr.ops:
        by_name[r.name] = by_name.get(r.name, 0.0) + (r.end - r.start) / 1e6
    tr.top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    tr.kernels = sum(devtrace.is_kernel(r) for r in tr.ops)
    tr.own_s = {k: sum(r.end - r.start for r in v) / 1e6 for k, v in tr.own.items()}
    tr.describe_needs = [need.describe_need(shape[1], shape[2], axy, valid) for shape, axy, valid in tr.describe_calls]
    tr.pose_needs = []
    ref_cfg = check.ref_slam_config(config)
    with check.precision(False), torch.no_grad():
        for call in tr.pose_calls:
            kw = dict(call["args"])
            cam = check.ref_config.CameraIntrinsics(*kw["cam"])
            args = ref_pose_opt.solve_args(kw["R0"], kw["t0"], kw["points_w"], kw["obs_uvur"], kw["octave"],
                                           kw["valid"], cam, kw["scale_factor"], kw["line_start_w"],
                                           kw["line_end_w"], kw["line_obs"], kw["line_octave"], kw["line_valid"])
            masks = []
            ref_pose_opt.pose_solve_plain(*args, kw["rounds"], kw["iters"], round_masks=masks)
            tr.pose_needs.append(need.pose_solve_need(args[:11], kw["rounds"], kw["iters"], masks))


# ---------------------------------------------------------------------------

def cell_limits(cell: dict) -> dict:
    """The cell's limits, every frame of the window tracked among them."""
    return {"frames_not_tracked": 0, **cell["limits"]}


def decide(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number the cell has a
    limit for was read and lies at or under it."""
    checks = {name: {"value": numbers.get(name), "limit": limit} for name, limit in limits.items()}
    return all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values()), checks


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES})


def set_environment() -> None:
    """Caches at fixed paths inside the checkout; no JAX through a library;
    the card looked for without creating a CUDA context."""
    cache = ROOT / "slambench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["PYTORCH_NVML_BASED_CUDA_CHECK"] = "1"


def parse_args(argv):
    ap = argparse.ArgumentParser(description="Run one cell of the orb_line_slam_tpu_torch benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse_args(argv)
    set_environment()
    spec = benchmark_spec()
    entry = next((w for w in spec["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    # Rendered first: the renderer forks, before torch has started threads.
    t0 = time.perf_counter()
    rendered = (*render_sequence(cell["config"], cell["traffic"], int(cell["n_frames"]), args.seed),
                time.perf_counter() - t0)
    t0 = time.perf_counter()
    import torch

    print(f"render {rendered[2]:.3f} s, torch import {time.perf_counter() - t0:.3f} s", flush=True)
    chips = int(entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"a CUDA card is required: torch.cuda.is_available() {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} devices, the cell needs {chips}", file=sys.stderr)
        return 2
    card = card_line()
    probe = host_probe()
    print(f"card: {card}; host probe {probe[0]:.2f} ms min, {probe[1]:.2f} ms median", flush=True)
    rec = run_cell(cell, args.seed, args.seconds, bool(args.trace), t_start,
                   log=lambda s: print(s, flush=True), rendered=rendered)
    run = rec["run"]

    metrics = {}
    for m in cell_metrics(spec, args.workload, bool(args.trace)):
        value = load_metric(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct, checks = decide(rec["numbers"], cell_limits(cell))
    correct = correct and run.attempted > 0

    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": rec["memory_peak_bytes"]}
    result = {"correct": bool(correct), "attempted": run.attempted, "failed": run.failed, "metrics": metrics,
              "device": device}
    if args.trace:
        tr = run.trace
        if tr is None:
            print("no complete profile of the traced pass", file=sys.stderr)
            return 4
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": [[k, v] for k, v in tr.top_ops[:10]],
                               "idle_gaps": [[k, v] for k, v in tr.idle_by_host[:10]]}
        print(f"traced frames {tr.first_frame}-{tr.first_frame + tr.frames - 1} (try {tr.tries}): "
              f"{tr.kernels} kernels, {tr.launch_calls} launch calls, busy {tr.busy_s:.6f} s of {tr.window_s:.6f} s; "
              f"device us, kernels and calls per range {json.dumps(tr.range_times)}; own device s per kernel "
              f"{json.dumps(tr.own_s)} over {len(tr.describe_calls)} orb_describe and {len(tr.pose_calls)} pose_solve "
              f"launches", flush=True)
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
