"""Share of the traced turns of the open loop (each turn's submits and
tick, not the sleeps between turns) in which no kernel, copy or set ran
on the card (union of the profiler's device intervals)."""
from bench import readers


def read(ctx):
    return readers.idle_pct(ctx)
