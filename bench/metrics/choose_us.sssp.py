"""Mean host time of the form choice, the program's ``dawn.sweep.choose``
span over the traced calls, in microseconds: on the card one span a tile,
which pins the tile to push by rule; where the per-sweep choice runs (the
statistics, the argmin and its read-back), one a sweep."""


def read(ctx):
    try:
        from repro_torch import trace
    except ImportError:            # a program without the recorder
        return None
    s = trace.snapshot()["window"]["spans"].get("dawn.sweep.choose")
    return 1e6 * s["s"] / s["n"] if s else None
