from .csr import (CSRGraph, DegreeStats, resolve_device, same_device,
                  symmetrize)
from .dynamic import DynamicCSRGraph
from .landmarks import (STRATEGIES, degree_landmarks, farthest_point_fill,
                        select_landmarks)
from . import generators, landmarks, partition, sampler, io

__all__ = ["CSRGraph", "DegreeStats", "DynamicCSRGraph", "generators",
           "io", "landmarks", "partition", "resolve_device", "same_device",
           "sampler", "symmetrize",
           "STRATEGIES", "degree_landmarks", "farthest_point_fill",
           "select_landmarks"]
