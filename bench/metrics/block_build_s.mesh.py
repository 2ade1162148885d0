"""Set-up seconds of this rank's K-row block of the sweep operand, built
from the CSR lanes by the sharded executor: the program's
``dawn.mesh.block`` span (the card synced inside), on rank 0."""


def read(ctx):
    try:
        from repro_torch import trace
    except ImportError:            # a program without the recorder
        return None
    s = trace.snapshot()["setup"]["spans"].get("dawn.mesh.block")
    return s["s"] if s else None
