"""Share of the traced window in which no kernel, copy or set ran on a
card (union of the profiler's device intervals), from the cards' mean
busy and traced seconds."""
from bench import readers


def read(ctx):
    return readers.idle_pct(ctx)
