"""repro_torch — DAWN (matrix-operation shortest paths) in PyTorch with
hand-written CUDA kernels for Hopper.

The port of the ``repro`` JAX package.  The caller-facing surface is the
``dawn`` facade (``repro_torch.api``):

    import repro_torch as dawn

    h = dawn.prepare(graph)          # CSRGraph or DynamicCSRGraph
    row = h.sssp(0)
    res = h.apsp(sources)
    inc = h.incremental(sources)     # DynamicCSRGraph: streaming repair

Everything runs on the card unless the caller passes ``device="cpu"``.
"""
from .api import DawnGraph, SEMIRING_NAMES, prepare
from .core.incremental import (IncrementalSSSP, IncrementalState,
                               RepairResult, repair, sssp_state)
from .core.options import SweepOptions
from .graph.csr import CSRGraph
from .graph.dynamic import DynamicCSRGraph

__version__ = "0.1.0"

__all__ = [
    "CSRGraph",
    "DawnGraph",
    "DynamicCSRGraph",
    "IncrementalSSSP",
    "IncrementalState",
    "RepairResult",
    "SEMIRING_NAMES",
    "SweepOptions",
    "prepare",
    "repair",
    "sssp_state",
]
