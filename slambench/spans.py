"""The program's own spans in a torch.profiler window: the host ranges
``slam/<name>`` that orb_line_slam_tpu_torch's tracer opens while enabled
under a profiler, read beside the window's device idle gaps and its CUDA
runtime calls.

The spans of one thread nest.  ``segments`` cuts the window's host time
into pieces in which the same spans are open; each piece carries its
chain (the open spans' names, outermost first).  Idle gaps, blocking
runtime calls and kernel launches are put down to the chain open where
they fall: a gap is split where the chain changes, a call counts where it
starts.  Spans of several threads that overlap are clipped to nest (the
later-opened one ends where the span it was opened in ends).
"""

from __future__ import annotations

import bisect
from typing import NamedTuple

from .devtrace import LAUNCH_CALLS

PREFIX = "slam/"
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cuStreamSynchronize",
              "cuCtxSynchronize", "cuEventSynchronize")


class Call(NamedTuple):
    name: str
    start: float     # us from the trace's start
    end: float


def is_sync(name: str) -> bool:
    """A CUDA runtime or driver call that blocks the host until the device
    has caught up: a synchronisation, or a memcpy that is not Async."""
    return name in SYNC_CALLS or (name.startswith(("cudaMemcpy", "cuMemcpy")) and "Async" not in name)


def read_events(prof) -> tuple[list[tuple[str, float, float]], list[Call], list[Call]]:
    """(host spans (name without the prefix, start, end), blocking calls,
    launch calls) of a finished profile, times in us from the trace's
    start, read once from the profiler's raw events."""
    import torch

    raw = prof.profiler.kineto_results
    t0, cuda = raw.trace_start_ns(), torch.autograd.DeviceType.CUDA
    spans, syncs, launches = [], [], []
    for e in raw.events():
        if e.device_type() == cuda:
            continue
        name = e.name()
        start = (e.start_ns() - t0) / 1e3
        end = start + e.duration_ns() / 1e3
        if name.startswith(PREFIX):
            spans.append((name[len(PREFIX):], start, end))
        elif name in LAUNCH_CALLS:
            launches.append(Call(name, start, end))
        elif is_sync(name):
            syncs.append(Call(name, start, end))
    return spans, syncs, launches


def segments(spans) -> list[tuple[float, float, tuple[str, ...]]]:
    """(start, end, chain) pieces of the time that ``spans`` ((name, start,
    end)) cover, in order; chain names the spans open there, outermost
    first."""
    out: list[tuple[float, float, tuple[str, ...]]] = []
    stack: list[tuple[str, float, float]] = []
    cur = 0.0

    def close(until: float):
        nonlocal cur
        while stack and stack[-1][2] <= until:
            end = stack[-1][2]
            if end > cur:
                out.append((cur, end, tuple(s[0] for s in stack)))
            cur = max(cur, end)
            stack.pop()

    for name, a, b in sorted(spans, key=lambda s: (s[1], -s[2])):
        close(a)
        if stack and a > cur:
            out.append((cur, a, tuple(s[0] for s in stack)))
        cur = a
        stack.append((name, a, min(b, stack[-1][2]) if stack else b))
    close(float("inf"))
    return out


def idle_by_chain(gaps, segs) -> dict[tuple[str, ...], float]:
    """Idle us of ``gaps`` ((start, end), in order) by the chain open where
    it falls; () holds what no span covers."""
    out: dict[tuple[str, ...], float] = {}
    starts = [s[0] for s in segs]
    for a, b in gaps:
        covered = 0.0
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(segs) and segs[i][0] < b:
            lo, hi = max(a, segs[i][0]), min(b, segs[i][1])
            if hi > lo:
                out[segs[i][2]] = out.get(segs[i][2], 0.0) + hi - lo
                covered += hi - lo
            i += 1
        if b - a > covered:
            out[()] = out.get((), 0.0) + (b - a) - covered
    return out


def calls_by_chain(calls, segs) -> dict[tuple[str, ...], list]:
    """{chain: [calls, us inside them]} of ``calls``, each put down to the
    chain open at its start."""
    starts = [s[0] for s in segs]
    out: dict[tuple[str, ...], list] = {}
    for c in calls:
        i = bisect.bisect_right(starts, c.start) - 1
        chain = segs[i][2] if i >= 0 and c.start < segs[i][1] else ()
        row = out.setdefault(chain, [0, 0.0])
        row[0] += 1
        row[1] += c.end - c.start
    return out


def inside(by_chain: dict, names, but=()) -> float:
    """The sum of ``by_chain``'s values over the chains that hold one of
    ``names`` and none of ``but``."""
    return sum(v for chain, v in by_chain.items()
               if any(n in chain for n in names) and not any(n in chain for n in but))


def label(chain: tuple[str, ...]) -> str:
    """The innermost span with its parent ("frontend/detect"), or "host"."""
    return "/".join(chain[-2:]) if chain else "host"


def by_label(by_chain: dict) -> list[tuple[str, float]]:
    """``by_chain``'s values summed by label, largest first."""
    out: dict[str, float] = {}
    for chain, v in by_chain.items():
        out[label(chain)] = out.get(label(chain), 0.0) + v
    return sorted(out.items(), key=lambda kv: -kv[1])


class SlamWindow(NamedTuple):
    """The program's spans over a traced window of ``frames`` frames."""

    frames: int
    opened: frozenset       # the names of the spans that opened
    idle: dict              # {chain: idle us}
    syncs: dict             # {chain: [blocking calls, us in them]}
    launches: dict          # {chain: [launch calls, us in them]}


def window(spans, syncs, launches, gaps, frames: int) -> SlamWindow:
    segs = segments(spans)
    return SlamWindow(frames, frozenset(s[0] for s in spans), idle_by_chain(gaps, segs), calls_by_chain(syncs, segs),
                      calls_by_chain(launches, segs))


def idle_ms(run, names, but=()):
    """Device idle ms a traced frame inside the program's spans ``names``
    (not inside ``but``); None where the run has no program spans or the
    spans never opened."""
    sw = slam_window(run)
    if sw is None or not sw.opened & set(names):
        return None
    return inside(sw.idle, names, but) / 1e3 / sw.frames


def slam_window(run):
    tr = getattr(run, "trace", None)
    return getattr(tr, "slam", None) if tr is not None else None


def frame_breakdown(records, frames) -> dict[int, dict[str, float]]:
    """{frame id: {span name: seconds}} of the tracer's span records
    (orb_line_slam_tpu_torch.utils.timing.Span) of the given frames."""
    out: dict[int, dict[str, float]] = {f: {} for f in frames}
    for r in records:
        if r.frame in out:
            row = out[r.frame]
            row[r.name] = row.get(r.name, 0.0) + (r.end_ns - r.start_ns) / 1e9
    return out
