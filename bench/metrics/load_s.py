"""Set-up seconds of the graph loader: the program's ``dawn.from_edges``
spans (host dedup and sorts, the move to the card)."""


def read(ctx):
    try:
        from repro_torch import trace
    except ImportError:            # a program without the recorder
        return None
    s = trace.snapshot()["setup"]["spans"].get("dawn.from_edges")
    return s["s"] if s else None
