from .csr import CSRGraph, DegreeStats, resolve_device, symmetrize
from . import generators

__all__ = ["CSRGraph", "DegreeStats", "generators", "resolve_device",
           "symmetrize"]
