"""Wall time of the traced single-source calls over the sweeps a search
from each source needs (the reference's levels of the source, plus the
sweep that finds nothing), in microseconds."""


def read(ctx):
    levels = []
    for i, c in ctx.calls:
        for row in range(len(c.sources)):
            if (i, row) not in ctx.levels:
                return None
            levels.append(ctx.levels[(i, row)] + 1)
    if not levels:
        return None
    return 1e6 * sum(c.wall_s for _, c in ctx.calls) / sum(levels)
