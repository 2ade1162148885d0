"""repro_torch — DAWN (matrix-operation shortest paths) in PyTorch with
hand-written CUDA kernels for Hopper.

The port of the ``repro`` JAX package.  The caller-facing surface is the
``dawn`` facade (``repro_torch.api``):

    import repro_torch as dawn

    h = dawn.prepare(graph)          # CSRGraph; operands on the card
    row = h.sssp(0)
    res = h.apsp(sources)

Everything runs on the card unless the caller passes ``device="cpu"``.
"""
from .api import DawnGraph, SEMIRING_NAMES, prepare
from .core.options import SweepOptions
from .graph.csr import CSRGraph

__version__ = "0.1.0"

__all__ = [
    "CSRGraph",
    "DawnGraph",
    "SEMIRING_NAMES",
    "SweepOptions",
    "prepare",
]
