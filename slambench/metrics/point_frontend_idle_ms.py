"""Device idle ms a traced frame inside the program's own span
``frontend`` (build_stereo_frame: pyramid, detection, orb_describe,
stereo matching): the gaps of the device's busy union that fall inside
it, summed over the traced frames."""

from slambench import spans


def read(run):
    return spans.idle_ms(run, ("frontend",))
