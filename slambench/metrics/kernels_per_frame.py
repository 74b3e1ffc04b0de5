"""Device kernels a traced frame."""


def read(run):
    tr = run.trace
    return None if tr is None else tr.kernels / tr.frames
