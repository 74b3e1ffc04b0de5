"""Blocking CUDA runtime calls (synchronisations and memcpys that are not
Async) a traced frame that start inside one of the program's spans."""

from slambench import spans


def read(run):
    sw = spans.slam_window(run)
    if sw is None:
        return None
    return sum(n for chain, (n, _) in sw.syncs.items() if chain) / sw.frames
