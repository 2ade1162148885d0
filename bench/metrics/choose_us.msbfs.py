"""Mean host time of the per-sweep form choice (the statistics, the argmin
and its read-back), the program's ``dawn.sweep.choose`` span over the
traced calls, in microseconds."""


def read(ctx):
    try:
        from repro_torch import trace
    except ImportError:            # a program without the recorder
        return None
    s = trace.snapshot()["window"]["spans"].get("dawn.sweep.choose")
    return 1e6 * s["s"] / s["n"] if s else None
