"""Frames tracked per second: every frame the measured window handed to
System.track_stereo that came back tracked, over the whole window (system
construction and shutdown between passes included)."""


def read(run):
    return run.tracked / run.window_s if run.window_s > 0 else None
