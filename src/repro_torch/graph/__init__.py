from .csr import CSRGraph, DegreeStats, resolve_device, symmetrize
from .dynamic import DynamicCSRGraph
from . import generators

__all__ = ["CSRGraph", "DegreeStats", "DynamicCSRGraph", "generators",
           "resolve_device", "symmetrize"]
