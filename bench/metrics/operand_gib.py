"""Bytes held by the newest prepared graph's built operands (CSR
arrays, degrees, dense and packed operands, their indexes): the
program's ``dawn.operand_bytes`` gauge, in GiB."""


def read(ctx):
    try:
        from repro_torch import trace
    except ImportError:            # a program without the recorder
        return None
    b = trace.snapshot()["setup"]["gauges"].get("dawn.operand_bytes")
    return b / 2**30 if b is not None else None
