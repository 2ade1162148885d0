"""Share of the queries submitted in the traced part of the window that
the serving tier answered from its row cache: the program's
``GraphService.cache_hits`` over its ``n_submitted``, both counted over
those turns of the loop (``ctx.service``), in percent."""


def read(ctx):
    c = getattr(ctx, "service", None)
    if not c or "cache_hits" not in c or not c.get("submitted"):
        return None
    return 100.0 * c["cache_hits"] / c["submitted"]
