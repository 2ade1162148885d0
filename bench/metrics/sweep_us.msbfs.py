"""Wall time of the traced calls over the tile-sweeps they ran
(Σ ``ApspResult.direction_counts``), in microseconds."""
from bench import readers


def read(ctx):
    counts = readers.direction_counts(ctx)
    if counts is None:
        return None
    sweeps = sum(sum(x) for x in counts)
    wall = sum(c.wall_s for _, c in ctx.calls)
    return 1e6 * wall / sweeps if sweeps else None
