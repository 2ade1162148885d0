"""Bytes a rank receives from the other ranks of the mesh in a sweep: the
program's ``dawn.mesh.gather_bytes`` counter (every all-gather's slices
from the other ranks, its own counting 0) over the sweeps it counted
(``dawn.sweeps``), in MiB, on rank 0."""


def read(ctx):
    try:
        from repro_torch import trace
    except ImportError:            # a program without the recorder
        return None
    c = trace.snapshot()["window"]["counters"]
    got, n = c.get("dawn.mesh.gather_bytes"), c.get("dawn.sweeps")
    return got / n / 2**20 if got is not None and n else None
