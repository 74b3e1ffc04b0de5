"""Host ms a window frame spent in the local (or joint) BA calls on the
tracking thread: upload, solve and the result fetched."""


def read(run):
    if run.attempted == 0:
        return None
    return 1e3 * sum(run.spans["mapping"]) / run.attempted
