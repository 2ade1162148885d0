"""Share of the traced calls' tile-sweeps that the engine ran in the
sparse (edge-parallel) form: ``ApspResult.direction_counts``."""
from bench import readers


def read(ctx):
    counts = readers.direction_counts(ctx)
    if counts is None:
        return None
    total = sum(sum(x) for x in counts)
    return 100.0 * sum(x[2] for x in counts) / total if total else None
