"""repro_torch — DAWN (matrix-operation shortest paths) in PyTorch with
hand-written CUDA kernels for Hopper.

The port of the ``repro`` JAX package.  The caller-facing surface is the
``dawn`` facade (``repro_torch.api``):

    import repro_torch as dawn

    h = dawn.prepare(graph)          # CSRGraph or DynamicCSRGraph
    row = h.sssp(0)
    res = h.apsp(sources)
    inc = h.incremental(sources)     # DynamicCSRGraph: streaming repair
    job = h.apsp(sources, checkpoint_dir="ckpt")   # resumable chunked job
    svc = h.serve(n_landmarks=16)    # tiered GraphService
    plan = h.tune(save="plan.json")  # roofline TuningPlan
    h = dawn.prepare(graph, tuning="plan.json")   # reproducible auto

The serving tier (``repro_torch.serve``: row cache, landmark oracle,
bucketed micro-batching) answers ``GraphQuery`` requests:

    svc.submit(GraphQuery(qid=0, source=3, target=7))
    svc.tick()                       # or svc.flush()
    done = svc.drain_completed()

Everything runs on the card unless the caller passes ``device="cpu"``.
``__all__`` is the JAX package's (``tests/test_torch_surface.py`` holds
it); the serving, job and plan types imported here are conveniences.
"""
from .api import DawnGraph, SEMIRING_NAMES, prepare
from .core.incremental import (IncrementalSSSP, IncrementalState,
                               RepairResult, repair, sssp_state)
from .core.autotune import TuningPlan
from .core.jobs import JobMismatchError, JobResult, run_sweep_job
from .core.options import SweepOptions
from .graph.csr import CSRGraph
from .graph.dynamic import DynamicCSRGraph
from .serve import DistanceOracle, GraphQuery, GraphService

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
