"""Device ms a traced step of the kernels launched in batched_frame_track:
the sum over the ranges the multi-sequence driver puts around its parts,
the front ends of the 2B images and the vmapped tracking step with its
pose solves (the profiler keeps the device side of the innermost range
alone, so no range encloses them)."""

PARTS = ("point_frontend", "line_frontend", "track_step")


def read(run):
    tr = run.trace
    steps = getattr(tr, "steps", 0)
    parts = [tr.range_times.get(k, (0, 0, 0)) for k in PARTS] if tr is not None else []
    if not steps or not any(p[2] for p in parts):
        return None
    return sum(p[0] for p in parts) / 1e3 / steps
