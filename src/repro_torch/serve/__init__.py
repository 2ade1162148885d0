"""Graph-query serving tier: tiered admission (row cache, landmark
oracle) and bucketed micro-batching over the port's engines."""
from .engine import GraphQuery, GraphService
from .oracle import (DistanceOracle, OracleAnswer, build_landmark_labels,
                     select_top_k)

__all__ = ["GraphQuery", "GraphService",
           "DistanceOracle", "OracleAnswer", "build_landmark_labels",
           "select_top_k"]
