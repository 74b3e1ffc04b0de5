"""Host timing of the pipeline's stages, and the port's tracer.

The reference reports only a per-frame chrono median (SURVEY.md §5
"Tracing / profiling").  Here every host-side stage is a span.  A span
always adds its host seconds to its ``StageTimer``'s bucket of that name
(``acc``, ``cnt``, ``table()``), at the cost of one perf_counter pair.
A ``Tracer``, which a ``System`` owns and shares among its components'
timers, adds three things:

- counters (``count``), always on;
- while ``enable()``d, one ``Span`` record a span: name, start and end
  (``time.time_ns``, the profiler's clock), the enclosing span on the
  same thread, the thread and the tracker's frame id; ``drain()`` hands
  them out;
- while enabled and a ``torch.profiler`` is active, a
  ``record_function("slam/<name>")`` range around each span, so the
  spans land in the profiler's trace beside the CUDA runtime calls and
  kernels they issued.

Spans nest per thread.  Code without a timer of its own (the front end,
the local-BA solve, the kernel loader) opens ``span(name)``, a child of
the innermost span open on its thread, or nothing where none is.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import defaultdict
from typing import NamedTuple, Optional

import torch


class Span(NamedTuple):
    """One finished span of an enabled tracer."""

    id: int
    parent: Optional[int]   # the enclosing span on the same thread, None at a root
    name: str
    start_ns: int           # time.time_ns()
    end_ns: int
    thread: int             # threading.get_ident()
    frame: int              # the tracker's frame id at the span's start


class Tracer:
    """The switch, span records and counters shared by one System's timers."""

    def __init__(self):
        self.enabled = False
        self.frame_id = -1
        self.counters: dict[str, int] = defaultdict(int)
        self._records: list[Span] = []
        self._ids = itertools.count(1)

    def enable(self):
        self.enabled = True

    def disable(self):
        self.enabled = False

    def drain(self) -> list[Span]:
        """The spans finished since the last drain, in the order they ended."""
        out, self._records = self._records, []
        return out


_local = threading.local()


def _open_stack() -> list:
    """The spans open on this thread, innermost last."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Stage:
    """Context manager of one span; ``seconds`` holds its host time after
    exit, and ``children`` (where kept) the seconds of its direct children
    of the same timer by name."""

    __slots__ = ("timer", "name", "t0", "seconds", "children", "id", "parent", "frame", "start_ns", "range")

    def __init__(self, timer: "StageTimer", name: str, children: bool = False):
        self.timer = timer
        self.name = name
        self.children = {} if children else None
        self.id = None

    def __enter__(self):
        stack = _open_stack()
        tracer = self.timer.tracer
        if tracer.enabled:
            self.id = next(tracer._ids)
            self.parent = stack[-1].id if stack else None
            self.frame = tracer.frame_id
            self.range = None
            if torch._C._autograd._profiler_enabled():
                self.range = torch.autograd.profiler.record_function(f"slam/{self.name}")
                self.range.__enter__()
            self.start_ns = time.time_ns()
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
        stack = _local.stack
        stack.pop()
        timer = self.timer
        timer.acc[self.name] += self.seconds
        timer.cnt[self.name] += 1
        if stack and stack[-1].children is not None and stack[-1].timer is timer:
            kept = stack[-1].children
            kept[self.name] = kept.get(self.name, 0.0) + self.seconds
        if self.id is not None:
            end = time.time_ns()
            if self.range is not None:
                self.range.__exit__(None, None, None)
            timer.tracer._records.append(Span(self.id, self.parent, self.name, self.start_ns, end,
                                              threading.get_ident(), self.frame))
        return False

    def children_ms(self) -> dict[str, float]:
        return {name: s * 1e3 for name, s in self.children.items()}


class StageTimer:
    """Host seconds and calls of named stages, summed per timer; spans and
    counters go to ``tracer`` (a private one if none is given)."""

    def __init__(self, tracer: Optional[Tracer] = None):
        self.tracer = tracer if tracer is not None else Tracer()
        self.acc: dict[str, float] = defaultdict(float)
        self.cnt: dict[str, int] = defaultdict(int)

    def stage(self, name: str, children: bool = False) -> _Stage:
        """A span of ``name``; with ``children`` it keeps its direct
        children's seconds."""
        return _Stage(self, name, children)

    def add(self, name: str, seconds: float):
        """Add a time measured elsewhere (no span)."""
        self.acc[name] += seconds
        self.cnt[name] += 1

    def count(self, name: str, n: int = 1):
        self.tracer.counters[name] += n

    def reset(self):
        self.acc.clear()
        self.cnt.clear()

    def table(self, n_frames: int | None = None) -> dict[str, dict]:
        """{stage: {total_ms, calls, ms_per_call, ms_per_frame}}."""
        acc, cnt = dict(self.acc), dict(self.cnt)   # a worker thread may add a stage meanwhile
        out = {}
        for name in sorted(acc, key=lambda k: -acc[k]):
            total = acc[name]
            calls = cnt.get(name, 0)
            row = {
                "total_ms": round(total * 1e3, 2),
                "calls": calls,
                "ms_per_call": round(total / max(calls, 1) * 1e3, 3),
            }
            if n_frames:
                row["ms_per_frame"] = round(total / n_frames * 1e3, 3)
            out[name] = row
        return out


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name: str):
    """A span of ``name`` on the timer of the innermost span open on this
    thread; a context that does nothing where no span is open."""
    stack = getattr(_local, "stack", None)
    if not stack:
        return _NO_SPAN
    return _Stage(stack[-1].timer, name)
