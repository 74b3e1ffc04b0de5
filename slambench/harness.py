"""The benchmark of orb_line_slam_tpu_torch: one cell, one run.

A cell (``cells/<name>.json``) names a configuration (``configs/``: the
camera, ORB and line budgets, map capacities and the rendered scene, its
camera path a trajectory kind of ``trajectories/<kind>.py``), a traffic
mix (``traffic/``: how the sequences are replayed, its sensor noise, the
traced frames and the checks' samples) and the checks it adds to the
common ones of ``check.py`` (``checks/<name>.py``).  The traffic names its
driver (``drivers/<name>.py``, ``stereo`` where it names none): the
closed-loop passes through the program's entry point, the traced pass, and
the probes around the program's layer calls that its path needs, on the
parts all drivers share (``drivers/_common.py``).  The
per-layer and end-to-end metrics are one reader each in
``metrics/<name>.py``, found by the names ``BENCHMARK.json`` gives the
cell.  Adding a configuration, a trajectory kind, a traffic mix, a driver,
a check or a metric adds files only.

A run renders the cell's sequence from ``--seed`` (the sensor noise),
warms up on one whole pass, then replays closed loop for ``--seconds``
through the driver, each pass from a fresh program state.  Nothing the
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
DEFAULT_DRIVER = "stereo"
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


def load_module(kind: str, name: str):
    """The module ``<kind>/<name>.py``, loaded from its file."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} entry named {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"slambench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric(name: str):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    return load_module("metrics", name).read


def load_driver(traffic: dict):
    """The traffic's driver, ``drivers/<name>.py``: ``make_probes(cell,
    seed)`` and its ``Probes``, ``replay``, ``traced_pass``,
    ``frames_per_call``, ``worst_ate``, its profiler ranges ``RANGE_TAGS``
    and the ``LABELS`` of the idle gaps."""
    return load_module("drivers", traffic.get("driver", DEFAULT_DRIVER))


def load_checks(cell: dict) -> list:
    """The checks the cell adds to ``check.py``'s, ``checks/<name>.py``:
    ``install(probes, cell, seed)`` and ``numbers(probes, ctx, control)``."""
    return [load_module("checks", name) for name in cell.get("checks", ())]


def load_trajectory(kind: str):
    """The ``poses(n_frames, spec)`` function of ``trajectories/<kind>.py``."""
    try:
        return load_module("trajectories", kind).poses
    except FileNotFoundError:
        raise ValueError(f"unknown trajectory kind {kind!r}") from None


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
    poses = load_trajectory(tr["kind"])(n_frames, tr)
    clean = render.render_frames(scene, poses, processes)
    pool = traffic["noise_pool"]
    order = np.random.default_rng(int(seed) % 2 ** 63).permutation(len(pool))
    copies = render.noisy_copies(clean, float(traffic["noise_sigma"]), [pool[i] for i in order], processes)
    return poses, copies


# ---------------------------------------------------------------------------

def snapshot(x):
    """A copy of a tensor, or of a NamedTuple of tensors, detached from
    what the program writes later; anything else as it is."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(snapshot(v) for v in x))
    return x


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




def pick_bas(seed: int, probes, chk: dict) -> list[int]:
    """Keep ``chk["ba_calls"]`` of the local BAs the window's first pass
    solved (the probes' ``ba``), drawn from the seed; returns their
    ordinals."""
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


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, t_start: float, device: str = "cuda",
             log=print, rendered=None) -> dict:
    """One run of a cell: set-up, the measured window, with ``trace`` a
    profiled pass, then the checks.  ``rendered`` is (poses, copies, render
    seconds) of the cell's sequence where the caller rendered it first.
    Returns the run's record (the ``run`` the metric readers read, the
    checks' numbers, the peak device memory)."""
    config, traffic = cell["config"], cell["traffic"]
    n = int(cell["n_frames"])
    if rendered is None:
        t0 = time.perf_counter()
        rendered = (*render_sequence(config, traffic, n, seed), time.perf_counter() - t0)
    poses, sequences, render_s = rendered
    t0 = time.perf_counter()
    import torch

    prog = load_program(device)
    import_s = time.perf_counter() - t0 - prog.build_s
    driver, checks = load_driver(traffic), load_checks(cell)

    dev = torch.device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    cfg = slam_config(prog.config, config)
    probes = driver.make_probes(cell, seed)
    for c in checks:
        c.install(probes, cell, seed)
    call = driver.CALL
    with probes:
        # Warm-up: one whole pass, so every shape and lazy initialisation
        # the window meets has been met.
        t0 = time.perf_counter()
        probes.sample_pass = -1
        _, warm_ms, _, _ = driver.replay(prog, cfg, cell, sequences, probes, 0.0, device, whole_passes=True)
        gc.collect()
        sync()
        warmup_s = time.perf_counter() - t0
        setup_s = time.perf_counter() - t_start
        log(f"set-up {setup_s:.3f} s: imports {import_s:.3f}, render {render_s:.3f} ({n} stereo pairs, "
            f"{len(sequences)} noise draws), kernel build/load {prog.build_s:.3f}, warm-up pass {warmup_s:.3f} "
            f"({call}s 0-9 {sum(warm_ms[:10]) / 1e3:.3f} s: {' '.join(f'{x:.0f}' for x in warm_ms[:10])} ms; "
            f"the other {len(warm_ms) - 10} {sum(warm_ms[10:]) / 1e3:.3f} s)")

        # The measured window: closed-loop passes, each a fresh program state.
        for mod in prog.kernels.values():
            mod.launches = 0
        probes.sample_pass, probes.recording = 0, True
        window_s, frame_ms, passes, failed = driver.replay(prog, cfg, cell, sequences, probes, seconds, device)
        probes.recording = False
        attempted = len(frame_ms) * driver.frames_per_call(cell)
        launches = {k: m.launches for k, m in prog.kernels.items()}
        peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
        log(f"window {window_s:.3f} s: {attempted} frames in {len(frame_ms)} {call}s of {len(passes)} passes, "
            f"{failed} not tracked; {len(probes.spans['loop_detect'])} keyframe "
            f"events, {len(probes.spans['mapping'])} local BAs on the tracking thread; kernel launches "
            f"{json.dumps(launches)}; System construction and shutdown {sum(probes.spans['system']):.3f} s, "
            f"vocabulary training {sum(probes.spans['vocab_train']):.3f} s ({len(probes.spans['vocab_train'])} "
            f"trainings){getattr(probes, 'window_note', lambda: '')()}")

        traced = driver.traced_pass(prog, cfg, cell, sequences, probes, device, sync) if trace else None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # The checks, once the window has closed and the program's state is freed.
    t0 = time.perf_counter()
    n_ba = len(probes.ba)
    ba_ordinals = pick_bas(seed, probes, traffic["check"])
    numbers = checked_numbers(driver, checks, probes, sequences, poses, passes, cell, seed, dev)
    numbers["frames_not_tracked"] = failed
    if traced is not None:
        finish_trace(traced, config, dev, driver.RANGE_TAGS, driver.LABELS)
    log(f"checks {time.perf_counter() - t0:.3f} s over the samples {probes.sample_frames} of the window's first "
        f"pass, local BAs {ba_ordinals} of its {n_ba}, {len(probes.pose)} pose solves, {len(probes.loop_events)} "
        f"keyframe insertions into the loop detector; numbers {json.dumps(numbers)} (not compared: ate_m, the "
        f"worst pass's ATE against the rendered ground truth; the widest pose gaps; pose_gap_medians, each path's "
        f"[rad, m, solves]; loop_queries, [queries due, with candidates, insertions])")

    run = SimpleNamespace(setup_s=setup_s, window_s=window_s, frame_ms=frame_ms, attempted=attempted,
                          failed=failed, tracked=attempted - failed, passes=len(passes), spans=probes.spans,
                          launches=launches, trace=traced, lines=bool(config["lines"]["enabled"]))
    return {"run": run, "numbers": numbers, "memory_peak_bytes": peak}


def checked_numbers(driver, checks, probes, sequences, poses, passes, cell: dict, seed: int, dev,
                    control: bool = False) -> dict:
    """The checks' numbers: the layers the probes captured in the window's
    first pass against the reference (``check.py``'s on the first noise
    copy ``sequences[0]``, then each of the cell's own checks), and the
    worst pass's ATE against the rendered ground truth.  With ``control``
    the control's numbers in the program's place."""
    from . import check

    ref_cfg = check.ref_slam_config(cell["config"])
    common = check.control_numbers if control else check.program_numbers
    numbers = common(probes, sequences[0], ref_cfg, dev)
    ctx = SimpleNamespace(cell=cell, seed=seed, cfg=ref_cfg, device=dev, sequences=sequences)
    for c in checks:
        numbers.update(c.numbers(probes, ctx, control))
    if not control:
        gt = check.centres(np.stack([R for R, _ in poses]), np.stack([t for _, t in poses]))
        numbers["ate_m"] = driver.worst_ate(passes, gt, cell) if passes else None
    return numbers


def pass_numbers(prog, cfg, cell: dict, seed: int, rendered, device: str = "cuda", control: bool = False) -> dict:
    """The checks' numbers of one closed-loop pass of the cell as a run's
    window starts it (``seed``'s first noise draw, the samples drawn from
    ``seed``; ``rendered`` is render_sequence's (poses, copies)): the
    program's against the reference, and with ``control`` the control's
    and the worst ATE of a pass of the program itself with TF32 switched
    on."""
    import torch

    from . import check

    traffic = cell["traffic"]
    driver, checks = load_driver(traffic), load_checks(cell)
    poses, sequences = rendered
    dev = torch.device(device)
    probes = driver.make_probes(cell, seed)
    for c in checks:
        c.install(probes, cell, seed)
    probes.recording = True
    with probes:
        window_s, frame_ms, passes, failed = driver.replay(prog, cfg, cell, sequences, probes, 0.0, device,
                                                           whole_passes=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    frames = len(frame_ms) * driver.frames_per_call(cell)
    row = {"seed": seed, "frames": frames, "failed": failed, "fps": (frames - failed) / window_s,
           "keyframes": len(probes.spans["loop_detect"]), "bas": len(probes.spans["mapping"])}
    pick_bas(seed, probes, traffic["check"])
    t0 = time.perf_counter()
    row["program"] = {**checked_numbers(driver, checks, probes, sequences, poses, passes, cell, seed, dev),
                      "frames_not_tracked": failed}
    row["check_s"] = time.perf_counter() - t0
    if control:
        row["control"] = checked_numbers(driver, checks, probes, sequences, poses, passes, cell, seed, dev,
                                         control=True)
        with check.precision(True), driver.Probes() as tf32:
            _, _, tf32_passes, tf32_failed = driver.replay(prog, cfg, cell, sequences, tf32, 0.0, device,
                                                           whole_passes=True)
        gt = check.centres(np.stack([R for R, _ in poses]), np.stack([t for _, t in poses]))
        row["control"]["ate_m"] = driver.worst_ate(tf32_passes, gt, cell)
        row["control"]["frames_not_tracked"] = tf32_failed
    return row


def pose_need(call: dict, ref_cfg) -> tuple[int, int]:
    """The needed work of one pose-solve launch: ``call`` holds either the
    operator's arguments (``op``: 11 tensors, with a leading [B] for a
    batched launch, and 5 camera numbers; ``rounds``, ``iters``) or
    ``pose_optimize``'s (``args``).  The round masks come from the
    reference's plain solve, over a batched launch's solves under vmap."""
    import torch

    from . import check, need
    from .ref.backend import pose_opt as ref_pose_opt

    if "op" in call:
        args, rounds, iters = call["op"], call["rounds"], call["iters"]
    else:
        kw = call["args"]
        cam = check.ref_config.CameraIntrinsics(*kw["cam"])
        args = ref_pose_opt.solve_args(kw["R0"], kw["t0"], kw["points_w"], kw["obs_uvur"], kw["octave"],
                                       kw["valid"], cam, kw["scale_factor"], kw["line_start_w"],
                                       kw["line_end_w"], kw["line_obs"], kw["line_octave"], kw["line_valid"])
        rounds, iters = kw["rounds"], kw["iters"]
    if args[0].dim() == 2:
        masks = []
        ref_pose_opt.pose_solve_plain(*args, rounds, iters, round_masks=masks)
        return need.pose_solve_need(args[:11], rounds, iters, masks)

    def solve_masks(*a):
        masks = []
        ref_pose_opt.pose_solve_plain(*a, rounds, iters, round_masks=masks)
        return masks

    masks = torch.func.vmap(solve_masks, in_dims=(0,) * 11 + (None,) * 5)(*args)
    return need.pose_solve_need(args[:11], rounds, iters, masks)


def finish_trace(tr, config: dict, dev, tags, labels) -> None:
    """Device time per range (``tags``) and kernel, busy union, idle gaps
    labelled by the innermost of the host ranges ``labels`` (outermost
    first), and the needed work of each kernel launch in the traced window
    (the pose solves' round masks from the reference's plain solve)."""
    import torch

    from . import check, need
    from . import devtrace

    tr.range_times = devtrace.range_device_times(tr.ops, tr.ranges, tags)
    busy = devtrace.busy_intervals(tr.ops)
    tr.busy_s = sum(b - a for a, b in busy) / 1e6
    lo = min(a for a, _ in busy)
    hi = max(b for _, b in busy)
    gaps = devtrace.idle_gaps(busy, lo, hi)
    idle = {}
    for a, b in gaps:
        label = devtrace.host_label(b, tr.host, labels)
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    tr.idle_by_host = sorted(idle.items(), key=lambda kv: -kv[1])
    by_name = {}
    for r in tr.ops:
        by_name[r.name] = by_name.get(r.name, 0.0) + (r.end - r.start) / 1e6
    tr.top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    tr.kernels = sum(devtrace.is_kernel(r) for r in tr.ops)
    tr.own_s = {k: sum(r.end - r.start for r in v) / 1e6 for k, v in tr.own.items()}
    tr.describe_needs = [need.describe_need(shape[1], shape[2], axy, valid) for shape, axy, valid in tr.describe_calls]
    ref_cfg = check.ref_slam_config(config)
    with check.precision(False), torch.no_grad():
        tr.pose_needs = [pose_need(call, ref_cfg) for call in tr.pose_calls]


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
        print(f"traced {tr.frames} frames from call {tr.first_frame} of the pass (try {tr.tries}): "
              f"{tr.kernels} kernels, {tr.launch_calls} launch calls, busy {tr.busy_s:.6f} s of {tr.window_s:.6f} s; "
              f"device us, kernels and calls per range {json.dumps(tr.range_times)}; own device s per kernel "
              f"{json.dumps(tr.own_s)} over {len(tr.describe_calls)} orb_describe and {len(tr.pose_calls)} pose_solve "
              f"launches{getattr(tr, 'note', '')}", flush=True)
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
