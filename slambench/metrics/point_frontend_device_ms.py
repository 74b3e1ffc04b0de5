"""Device ms a traced frame of the kernels that start inside the range
around build_stereo_frame."""

from slambench.devtrace import range_ms


def read(run):
    return range_ms(run, "point_frontend")

