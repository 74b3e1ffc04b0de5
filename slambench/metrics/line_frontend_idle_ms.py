"""Device idle ms a traced frame inside the program's span
``line_frontend`` (build_line_features); nothing where the configuration
has no lines."""

from slambench import spans


def read(run):
    return spans.idle_ms(run, ("line_frontend",)) if run.lines else None
