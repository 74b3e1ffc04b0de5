# Frozen copy of the profiler parsing of chip_smoke.py at commit d30c4f7
# (DeviceRecord, device_records, range_device_times), read from the
# profiler's raw events, with the host-side ranges read the same way and
# the busy union and idle gaps of a window added.
"""Device records of a torch.profiler window: kernels, copies and the device
side of record_function ranges, and the host side of those ranges."""

from __future__ import annotations

import bisect
from typing import NamedTuple

import torch


class DeviceRecord(NamedTuple):
    name: str
    start: float     # us from the trace's start
    end: float
    stream: int


LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")


def read_events(prof, tags) -> tuple[list[DeviceRecord], dict[str, list[tuple[float, float]]], int]:
    """(device records, host intervals (us) of each range in ``tags``, kernel
    launch calls) of a finished profile, read once from the profiler's raw
    events: torch.profiler's own ``events()`` first builds a tree of every
    host and device event, which takes about a minute a few frames."""
    raw = prof.profiler.kineto_results
    t0, cuda = raw.trace_start_ns(), torch.autograd.DeviceType.CUDA
    recs, host, launches = [], {tag: [] for tag in tags}, 0
    for e in raw.events():
        start = e.start_ns() - t0
        if e.device_type() == cuda:
            recs.append(DeviceRecord(e.name(), start / 1e3, (start + e.duration_ns()) / 1e3, e.device_resource_id()))
        elif e.name() in LAUNCH_CALLS:
            launches += 1
        elif e.name() in host:
            host[e.name()].append((start / 1e3, (start + e.duration_ns()) / 1e3))
    return recs, host, launches


def is_kernel(rec: DeviceRecord) -> bool:
    return not rec.name.startswith(("Memcpy", "Memset"))


def range_device_times(ops: list[DeviceRecord], ranges: list[DeviceRecord], tags) -> dict[str, list]:
    """{tag: [device us, kernels, calls]}: a range's device time is the sum
    of the device kernels that start inside its device interval."""
    kern = sorted((e for e in ops if is_kernel(e)), key=lambda e: e.start)
    starts = [e.start for e in kern]
    csum = [0.0]
    for e in kern:
        csum.append(csum[-1] + e.end - e.start)
    per = {tag: [0.0, 0, 0] for tag in tags}
    for r in ranges:
        i = bisect.bisect_left(starts, r.start)
        j = bisect.bisect_right(starts, r.end)
        per[r.name][0] += csum[j] - csum[i]
        per[r.name][1] += j - i
        per[r.name][2] += 1
    return per


def busy_intervals(ops: list[DeviceRecord]) -> list[tuple[float, float]]:
    """The union of the device operations' intervals (us), in order."""
    merged: list[list[float]] = []
    for e in sorted(ops, key=lambda e: e.start):
        if merged and e.start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e.end)
        else:
            merged.append([e.start, e.end])
    return [(a, b) for a, b in merged]


def idle_gaps(busy: list[tuple[float, float]], lo: float, hi: float) -> list[tuple[float, float]]:
    """The gaps (us) between busy intervals inside [lo, hi]."""
    gaps, cur = [], lo
    for a, b in busy:
        if a > cur:
            gaps.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        gaps.append((cur, hi))
    return [(a, b) for a, b in gaps if b > a]


def host_label(t: float, host: dict[str, list[tuple[float, float]]], order) -> str:
    """The innermost of the ranges in ``order`` (outermost first) that holds
    host time t, or "host" where none does."""
    label = "host"
    for tag in order:
        if any(a <= t <= b for a, b in host.get(tag, ())):
            label = tag
    return label


def range_ms(run, tag):
    """Device ms a traced frame of the kernels that start inside the range
    ``tag``; None without a trace or where the range was never entered."""
    tr = run.trace
    if tr is None or tr.range_times[tag][2] == 0:
        return None
    return tr.range_times[tag][0] / 1e3 / tr.frames
