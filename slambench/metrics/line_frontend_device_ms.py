"""Device ms a traced frame of the kernels that start inside the range
around build_line_features; nothing where the configuration has no lines."""

from slambench.devtrace import range_ms


def read(run):
    return range_ms(run, "line_frontend") if run.lines else None

