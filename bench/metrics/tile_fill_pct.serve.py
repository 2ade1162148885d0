"""Share of the engine's tile rows that held a real source, over the
sweeps of the flushes in the traced part of the window: the program's
``dawn.tile_rows_real`` over ``dawn.tile_rows``, in percent."""


def read(ctx):
    try:
        from repro_torch import trace
    except ImportError:            # a program without the recorder
        return None
    c = trace.snapshot()["window"]["counters"]
    rows = c.get("dawn.tile_rows")
    return 100.0 * c.get("dawn.tile_rows_real", 0) / rows if rows else None
