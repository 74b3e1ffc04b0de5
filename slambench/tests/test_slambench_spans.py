"""The readers of the program's spans (slambench/spans.py and the metrics
that read them) on synthetic intervals and calls: idle time inside a span
is the intersection of the gaps with it, idle by span adds up to the
window's idle time, each call goes to the innermost span open at its
start, and the readers stay silent on a run without the program's spans."""

from types import SimpleNamespace

import pytest

from slambench import harness, spans

# Two frames (us): each a front end with detection and description inside
# it, a tracking step and the step's consumption with a keyframe event.
SPANS = [
    ("frame", 0.0, 100.0), ("frontend", 0.0, 40.0), ("detect", 5.0, 20.0), ("describe", 20.0, 30.0),
    ("track_step", 40.0, 70.0), ("track_consume", 70.0, 100.0), ("kf_event_total", 80.0, 95.0),
    ("frame", 110.0, 200.0), ("frontend", 110.0, 150.0), ("detect", 115.0, 130.0),
    ("track_step", 150.0, 180.0), ("track_consume", 180.0, 200.0),
]
GAPS = [(2.0, 8.0), (25.0, 45.0), (60.0, 85.0), (98.0, 112.0), (120.0, 125.0), (190.0, 205.0)]


def _overlap(gaps, lo, hi):
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in gaps)


def test_segments_follow_the_nesting():
    segs = spans.segments(SPANS)
    assert segs[:5] == [(0.0, 5.0, ("frame", "frontend")), (5.0, 20.0, ("frame", "frontend", "detect")),
                        (20.0, 30.0, ("frame", "frontend", "describe")), (30.0, 40.0, ("frame", "frontend")),
                        (40.0, 70.0, ("frame", "track_step"))]
    assert all(a < b for a, b, _ in segs) and all(s[1] <= t[0] for s, t in zip(segs, segs[1:]))
    # nothing between the frames
    assert not any(a < 110.0 and b > 100.0 for a, b, _ in segs)


def test_idle_inside_a_span_is_the_gaps_intersection_with_it():
    by_chain = spans.idle_by_chain(GAPS, spans.segments(SPANS))
    frontend = _overlap(GAPS, 0.0, 40.0) + _overlap(GAPS, 110.0, 150.0)
    assert spans.inside(by_chain, ("frontend",)) == pytest.approx(frontend)
    detect = _overlap(GAPS, 5.0, 20.0) + _overlap(GAPS, 115.0, 130.0)
    assert spans.inside(by_chain, ("detect",)) == pytest.approx(detect)
    step = _overlap(GAPS, 40.0, 100.0) - _overlap(GAPS, 80.0, 95.0) + _overlap(GAPS, 150.0, 200.0)
    assert spans.inside(by_chain, ("track_step", "track_consume"), but=("kf_event_total",)) == pytest.approx(step)
    assert by_chain[()] == pytest.approx(_overlap(GAPS, 100.0, 110.0) + _overlap(GAPS, 200.0, 205.0))


def test_idle_by_span_adds_up_to_the_window_idle():
    by_chain = spans.idle_by_chain(GAPS, spans.segments(SPANS))
    total = sum(b - a for a, b in GAPS)
    assert sum(v for _, v in spans.by_label(by_chain)) == pytest.approx(total, rel=1e-2)
    labels = dict(spans.by_label(by_chain))
    assert labels["frontend/detect"] == pytest.approx(_overlap(GAPS, 5.0, 20.0) + _overlap(GAPS, 115.0, 130.0))
    assert labels["host"] == pytest.approx(by_chain[()])


def test_each_call_goes_to_the_innermost_span_open_at_its_start():
    calls = [spans.Call("cudaStreamSynchronize", 6.0, 9.0), spans.Call("cudaStreamSynchronize", 21.0, 50.0),
             spans.Call("cudaMemcpy", 85.0, 86.0), spans.Call("cudaDeviceSynchronize", 105.0, 106.0),
             spans.Call("cudaLaunchKernel", 40.0, 40.5)]
    by_chain = spans.calls_by_chain(calls, spans.segments(SPANS))
    assert by_chain == {("frame", "frontend", "detect"): [1, 3.0], ("frame", "frontend", "describe"): [1, 29.0],
                        ("frame", "track_consume", "kf_event_total"): [1, 1.0], (): [1, 1.0],
                        ("frame", "track_step"): [1, 0.5]}


def test_blocking_calls_are_told_from_asynchronous_ones():
    assert spans.is_sync("cudaStreamSynchronize") and spans.is_sync("cudaMemcpy") and spans.is_sync("cuMemcpyDtoH_v2")
    assert not spans.is_sync("cudaMemcpyAsync") and not spans.is_sync("cudaLaunchKernel")
    assert not spans.is_sync("cudaStreamWaitEvent")


def test_spans_of_two_threads_that_overlap_are_clipped_to_nest():
    segs = spans.segments([("frame", 0.0, 10.0), ("local_ba", 5.0, 30.0), ("frame", 12.0, 20.0)])
    assert segs == [(0.0, 5.0, ("frame",)), (5.0, 10.0, ("frame", "local_ba")), (12.0, 20.0, ("frame",))]


def _run(window=None, lines=True, warmup=None):
    return SimpleNamespace(trace=None if window is None else SimpleNamespace(slam=window), lines=lines,
                           warmup_frames=warmup)


def test_readers_read_the_window_and_stay_silent_without_it():
    calls = [spans.Call("cudaStreamSynchronize", 6.0, 9.0), spans.Call("cudaStreamSynchronize", 105.0, 106.0)]
    window = spans.window(SPANS, calls, [], GAPS, frames=2)
    names = ("point_frontend_idle_ms", "line_frontend_idle_ms", "track_step_idle_ms", "host_syncs_per_frame",
             "warmup_frames_s")
    read = {n: harness.load_metric(n) for n in names}
    for n in names:
        assert read[n](_run()) is None
    run = _run(window, warmup={0: {"frame": 4.5, "frontend": 2.0}, 1: {"frame": 1.5}})
    frontend = (_overlap(GAPS, 0.0, 40.0) + _overlap(GAPS, 110.0, 150.0)) / 1e3 / 2
    assert read["point_frontend_idle_ms"](run) == pytest.approx(frontend)
    assert read["line_frontend_idle_ms"](run) is None        # the span never opened
    assert read["line_frontend_idle_ms"](_run(window, lines=False)) is None
    assert read["track_step_idle_ms"](run) > 0
    assert read["host_syncs_per_frame"](run) == 0.5           # the one inside a span, over two frames
    assert read["warmup_frames_s"](run) == 6.0
