"""Seconds from the process's start to the start of the measured window:
imports, rendering, the kernel build or load and the warm-up pass."""


def read(run):
    return run.setup_s
