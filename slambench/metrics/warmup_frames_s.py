"""Seconds of the program's ``frame`` spans over the first two frames of
a fresh process's warm-up pass: the port's lazy start-up."""


def read(run):
    frames = getattr(run, "warmup_frames", None)
    if not frames or any("frame" not in row for row in frames.values()):
        return None
    return sum(row["frame"] for row in frames.values())
