"""Host ms a window frame spent in the local (or joint) BA calls: upload,
solve and the result fetched; on the tracking thread (stereo driver), or
on each sequence's mapping worker, off the step's path (multi-sequence
driver)."""


def read(run):
    if run.attempted == 0:
        return None
    return 1e3 * sum(run.spans["mapping"]) / run.attempted
