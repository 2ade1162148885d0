"""DAWN's own workloads (the paper's experiment families, §4.1)."""
from ..graph import generators

GRAPH_SUITE = generators.SUITE
SOURCE_SET_SIZE = 500      # paper: 500-node random source set
REPEATS = 64               # paper: 64 repetitions per source
