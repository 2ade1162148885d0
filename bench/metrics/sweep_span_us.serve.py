"""Host time of the sweeps of the flushes in the traced part of the
window, measured inside the sweep loop (Σ the program's ``dawn.sweep``
spans) over the sweeps it counted (``dawn.sweeps``), in microseconds."""


def read(ctx):
    try:
        from repro_torch import trace
    except ImportError:            # a program without the recorder
        return None
    w = trace.snapshot()["window"]
    s, n = w["spans"].get("dawn.sweep"), w["counters"].get("dawn.sweeps")
    return 1e6 * s["s"] / n if s and n else None
