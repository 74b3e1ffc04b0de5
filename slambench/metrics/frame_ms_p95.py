"""95th percentile of the host ms around the driver's call over every call
of the (untraced) window: System.track_stereo, which returns the pose as a
host array, or a multi-sequence step's process_stereo, whose latency is
each of its frames'."""

import numpy as np


def read(run):
    if not run.frame_ms:
        return None
    return float(np.percentile(np.asarray(run.frame_ms), 95))
