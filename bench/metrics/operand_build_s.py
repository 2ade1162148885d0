"""Set-up seconds of the lazily built operands and their indexes: the
program's ``dawn.operand.*`` spans, summed."""


def read(ctx):
    try:
        from repro_torch import trace
    except ImportError:            # a program without the recorder
        return None
    spans = trace.snapshot()["setup"]["spans"]
    built = [v["s"] for k, v in spans.items()
             if k.startswith("dawn.operand.")]
    return sum(built) if built else None
