"""Host time of the traced calls' sweeps measured inside rank 0's sweep
loop (Σ the program's ``dawn.sweep`` spans, each holding the rank's K1,
its ⊕ combine over the mesh and Fact 1) over the sweeps it counted
(``dawn.sweeps``), in microseconds."""


def read(ctx):
    try:
        from repro_torch import trace
    except ImportError:            # a program without the recorder
        return None
    w = trace.snapshot()["window"]
    s, n = w["spans"].get("dawn.sweep"), w["counters"].get("dawn.sweeps")
    return 1e6 * s["s"] / n if s and n else None
