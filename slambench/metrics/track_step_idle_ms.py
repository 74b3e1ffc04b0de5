"""Device idle ms a traced frame inside the program's spans
``track_step`` (the mirror refresh and the step's launches) and
``track_consume`` (the step's outputs read back and the frame's host
bookkeeping), outside the keyframe event (``kf_event_total``: mapping and
loop closing, which their own metrics cover)."""

from slambench import spans


def read(run):
    return spans.idle_ms(run, ("track_step", "track_consume"), but=("kf_event_total",))
