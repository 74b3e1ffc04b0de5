"""Share (%) of the traced window in which no operation ran on the device:
1 - the union of the device operations' intervals over the window."""


def read(run):
    tr = run.trace
    return None if tr is None else 100.0 * (1.0 - tr.busy_s / tr.window_s)
