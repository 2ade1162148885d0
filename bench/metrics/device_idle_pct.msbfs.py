"""Share of the traced window in which no kernel, copy or set ran on the
card (union of the profiler's device intervals)."""
from bench import readers


def read(ctx):
    return readers.idle_pct(ctx)
