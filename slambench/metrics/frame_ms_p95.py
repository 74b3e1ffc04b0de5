"""95th percentile of the host ms around System.track_stereo over every
frame of the (untraced) window; the call returns the pose as a host array."""

import numpy as np


def read(run):
    if not run.frame_ms:
        return None
    return float(np.percentile(np.asarray(run.frame_ms), 95))
