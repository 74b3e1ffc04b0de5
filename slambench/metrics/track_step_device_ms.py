"""Device ms a traced frame of the kernels that start inside the range
around track_step (its pose solves included)."""

from slambench.devtrace import range_ms


def read(run):
    return range_ms(run, "track_step")

