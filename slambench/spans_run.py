"""One cell's program spans on the card: which stage's host work leaves
the device idle, why (blocking calls or launches), and what the first
frames of a fresh process hold.

    python3 slambench/spans_run.py --workload kitti_stereo.seq --seed 7 --traces 1 --cost-passes 0

From the root of a checkout, on a CUDA card.  Renders the cell as
``slambench/run.py`` does, builds or loads the kernels, then in one
process:

1. the warm-up pass on a fresh System with its tracer on (no profiler):
   the first two frames by span (``warmup_frames_s``), the pass's
   counters, the kernel builds and loads;
2. ``--cost-passes K`` pairs of whole passes, the tracer off then on (no
   profiler): the frames/s of each;
3. ``--traces N`` windows over the traffic's traced frames, each on a
   fresh System with its tracer on under a torch.profiler, beside the
   benchmark's own layer ranges (``drivers/stereo.py::Probes``): the device's idle
   gaps, blocking CUDA calls and kernel launches by the program's span,
   the metrics of ``metrics/`` that read them, and their agreement with
   the benchmark's own labels in the same trace.

Prints its findings, and one JSON object as the last line of standard
output (also written to ``chiprun_out/spans_<cell>_<seed>.json``).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from slambench import devtrace, harness, spans  # noqa: E402
from slambench.drivers import stereo  # noqa: E402

UNITS = {"point_frontend_idle_ms": "ms/frame", "line_frontend_idle_ms": "ms/frame", "track_step_idle_ms": "ms/frame",
         "host_syncs_per_frame": "calls/frame", "warmup_frames_s": "s"}


def replay(prog, cfg, cell, frames, device, tracer_on):
    """A fresh System over ``frames``, its tracer on or off; returns
    (System, frames/s)."""
    dt = 1.0 / float(cell["config"]["fps"])
    slam = stereo.make_system(prog.System, cfg, cell["traffic"], bool(cell["config"]["loop_closing"]), device)
    if tracer_on:
        slam.tracer.enable()
    t0 = time.perf_counter()
    for i, (left, right) in enumerate(frames):
        slam.track_stereo(left, right, timestamp=dt * i)
    slam.shutdown()
    return slam, len(frames) / (time.perf_counter() - t0)


def traced_window(prog, cfg, cell, frames, device, sync, warmup_frames):
    """The traffic's traced frames on a fresh System, its tracer on, under
    a torch.profiler with the benchmark's layer ranges beside it; returns
    this window's numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    config, traffic = cell["config"], cell["traffic"]
    dt = 1.0 / float(config["fps"])
    length = int(traffic["trace"]["frames"])
    start = int(traffic["trace"]["start_frac"] * len(frames))
    slam = stereo.make_system(prog.System, cfg, traffic, bool(config["loop_closing"]), device)
    slam.tracer.enable()
    probes = stereo.Probes()
    with probes:
        for i, (left, right) in enumerate(frames[:start + length]):
            if i == start:
                sync()
                slam.tracer.drain()
                probes.tracing = True
                prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                prof.__enter__()
                tw0 = time.perf_counter()
            slam.track_stereo(left, right, timestamp=dt * i)
        sync()
        window_s = time.perf_counter() - tw0
        prof.__exit__(None, None, None)
        probes.tracing = False
    records = slam.tracer.drain()
    slam.shutdown()
    del slam
    torch.cuda.empty_cache()

    recs, host, launch_total = devtrace.read_events(prof, stereo.RANGE_TAGS)
    program, syncs, launches = spans.read_events(prof)
    trace_start_ns = prof.profiler.kineto_results.trace_start_ns()
    annotations = sum(r.name.startswith(spans.PREFIX) for r in recs)   # the spans' device side
    ops = [r for r in recs if r.name not in stereo.RANGE_TAGS
           and not r.name.startswith(("ProfilerStep", spans.PREFIX))]
    busy = devtrace.busy_intervals(ops)
    lo, hi = min(a for a, _ in busy), max(b for _, b in busy)
    gaps = devtrace.idle_gaps(busy, lo, hi)
    idle_us = sum(b - a for a, b in gaps)
    labels = {}
    for a, b in gaps:   # the benchmark's own labels: the range open at the gap's end
        tag = devtrace.host_label(b, host, stereo.RANGE_TAGS)
        labels[tag] = labels.get(tag, 0.0) + (b - a) / 1e6
    sw = spans.window(program, syncs, launches, gaps, length)
    run = SimpleNamespace(trace=SimpleNamespace(frames=length, slam=sw), lines=bool(config["lines"]["enabled"]),
                          warmup_frames=warmup_frames)
    metrics = {}
    for name, unit in UNITS.items():
        value = harness.load_metric(name)(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}

    # The tracer's records (time.time_ns) against the same spans in the
    # profiler's trace: the two clocks' offset.
    kineto_frames = sorted(s[1] for s in program if s[0] == "frame")
    record_frames = sorted(r.start_ns for r in records if r.name == "frame")
    offsets = [r - (trace_start_ns + k * 1e3) for r, k in zip(record_frames, kineto_frames)]
    rows = {}
    for key, table, i, scale in (("sync_calls", sw.syncs, 0, 1.0), ("sync_wait_ms", sw.syncs, 1, 1e-3),
                                 ("launch_calls", sw.launches, 0, 1.0)):
        for lab, v in spans.by_label({chain: row[i] for chain, row in table.items()}):
            rows.setdefault(lab, {})[key] = v * scale / length
    idle_by_span = [[k, v / 1e6] for k, v in spans.by_label(sw.idle)]
    label_ms = labels.get("point_frontend", 0.0) * 1e3 / length
    checks = {
        "idle_by_span_over_window_idle": sum(v for _, v in idle_by_span) / (idle_us / 1e6),
        "point_frontend_idle_ms_over_label": (metrics["point_frontend_idle_ms"]["value"] / label_ms
                                              if label_ms and "point_frontend_idle_ms" in metrics else None),
        "host_syncs_per_frame_unattributed": len(syncs) / length,
        "syncs_outside_spans": sw.syncs.get((), [0])[0],
        "launch_calls_devtrace": launch_total, "launch_calls_spans": len(launches),
        "span_device_annotations": annotations,
        "clock_offset_us_median": statistics.median(offsets) / 1e3 if offsets else None,
        "clock_offset_us_range": [min(offsets) / 1e3, max(offsets) / 1e3] if offsets else None,
    }
    return {"window_s": window_s, "frames": length, "first_frame": start, "busy_s": sum(b - a for a, b in busy) / 1e6,
            "span_s": (hi - lo) / 1e6, "idle_s": idle_us / 1e6, "kernels": sum(devtrace.is_kernel(r) for r in ops),
            "metrics": metrics, "idle_by_span": idle_by_span[:10],
            "idle_gaps": sorted(labels.items(), key=lambda kv: -kv[1]),
            "calls_by_span": dict(sorted(rows.items(), key=lambda kv: -kv[1].get("sync_calls", 0.0))), "checks": checks}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description="The program's spans of one cell on the card.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--traces", type=int, default=1)
    ap.add_argument("--cost-passes", type=int, default=0)
    args = ap.parse_args(argv)
    harness.set_environment()
    cell = harness.load_cell(args.workload)
    poses, sequences = harness.render_sequence(cell["config"], cell["traffic"], int(cell["n_frames"]), args.seed)
    import torch

    if not torch.cuda.is_available():
        print("a CUDA card is required", file=sys.stderr)
        return 2
    card = harness.card_line()
    print(f"card: {card}; host probe {harness.host_probe()} ms", flush=True)
    dev = torch.device("cuda")
    sync = lambda: torch.cuda.synchronize(dev)  # noqa: E731
    prog = harness.load_program("cuda")
    builds = prog.kernels["orb_describe"]._build.builds    # the program's kernel builds and loads
    cfg = harness.slam_config(prog.config, cell["config"])

    slam, fps = replay(prog, cfg, cell, sequences[0], "cuda", True)
    sync()
    records = slam.tracer.drain()
    warm = spans.frame_breakdown(records, (0, 1))
    top = {f: sorted(row.items(), key=lambda kv: -kv[1])[:12] for f, row in warm.items()}
    out = {"workload": args.workload, "seed": args.seed, "card": card, "setup_s": time.perf_counter() - T_START,
           "warmup": {"fps": fps, "frames": top, "counters": dict(slam.tracer.counters),
                      "builds": list(builds)}}
    print(f"warm-up pass {fps:.3f} frames/s; counters {json.dumps(out['warmup']['counters'])}; kernel builds and "
          f"loads {json.dumps(out['warmup']['builds'])}", flush=True)
    for f, row in out["warmup"]["frames"].items():
        print(f"warm-up frame {f} by span (s): {json.dumps(row)}", flush=True)
    del slam

    if args.cost_passes:
        fps = {"off": [], "on": []}
        for _ in range(args.cost_passes):
            for mode in ("off", "on"):
                slam, v = replay(prog, cfg, cell, sequences[0], "cuda", mode == "on")
                fps[mode].append(v)
                del slam
        out["cost"] = fps
        print(f"tracer cost, frames/s of whole passes off / on: {json.dumps(fps)}", flush=True)

    out["traces"] = []
    for _ in range(args.traces):
        t = traced_window(prog, cfg, cell, sequences[0], "cuda", sync, warm)
        out["traces"].append(t)
        first, last = t["first_frame"], t["first_frame"] + t["frames"] - 1
        print(f"traced frames {first}-{last}: metrics {json.dumps(t['metrics'])}; checks {json.dumps(t['checks'])}",
              flush=True)
        print(f"idle by span (s): {json.dumps(t['idle_by_span'])}; the benchmark's labels {json.dumps(t['idle_gaps'])}",
              flush=True)
        print(f"calls a frame by span: {json.dumps(t['calls_by_span'])}", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", f"spans_{args.workload}_{args.seed}.json"), "w") as f:
        json.dump(out, f)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
