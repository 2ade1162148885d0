"""The port's engine core: frontier packing, options, the sweep layer,
the batched boolean APSP engine, the single-source drivers and BFS
baselines, connected components, the counting engine with centrality,
the tropical (weighted) engine, incremental repair and resumable sweep
jobs, the roofline autotuner and the sharded executor."""
from .autotune import (BackendProfile, GraphStats, TuningPlan,
                       backend_profile, build_plan, device_fingerprint,
                       tune_tiles)
from .bfs import bfs_level_sync_torch, bfs_queue_numpy, bfs_scipy
from .bovm import DawnState, bovm_msbfs, bovm_sssp, bovm_sweep
from .centrality import (COUNTING_FORM_NAMES, MEASURES, CentralityConfig,
                         CentralityResult, CountingResult, betweenness,
                         brandes_dependencies, centrality, closeness,
                         counting_apsp, counting_apsp_blocks, eccentricity,
                         eccentricity_sample, harmonic,
                         measure_counting_costs)
from .distributed import (DENSE, MODEL_AXIS, SHARDED_FORM_NAMES, SPARSE,
                          ShardedApspResult, ShardedConfig, ShardedOperands,
                          dp_extent, prepare_sharded, sharded_apsp)
from .engine import (ApspResult, EngineConfig, PreparedGraph, SweepStats,
                     apsp_engine, apsp_engine_blocks, choose_direction,
                     frontier_stats, measure_sweep_costs, prepare_graph,
                     sweep_costs)
from .frontier import (UNREACHED, WORD, one_hot_frontier, pack_bits,
                       packed_width, popcount, unpack_bits)
from .incremental import (IncrementalSSSP, IncrementalState, RepairResult,
                          repair, sssp_state)
from .jobs import WORKLOADS, JobMismatchError, JobResult, run_sweep_job
from .options import SweepOptions
from .sovm import (SovmState, reconstruct_path, sovm_msbfs, sovm_sssp,
                   sovm_sweep)
from .sssp import SsspResult, apsp, apsp_dense, multi_source, sssp
from .sweep import (BOOLEAN, COUNTING, DIRECTION_NAMES, MIN_LABEL, PULL,
                    PUSH, SEMIRINGS, SPARSE, TROPICAL, Semiring, SweepState,
                    boolean_forms, counting_forms, derive_parents,
                    fused_form, make_state, minlabel_form,
                    minplus_candidates, resolve_fused_steps, sweep_loop,
                    time_sweep_forms, tropical_forms)
from .weighted import (WEIGHTED_FORM_NAMES, PreparedWeightedGraph,
                       WeightedApspResult, WeightedConfig, WeightedResult,
                       bucketed_sssp, dijkstra_oracle,
                       expand_integer_weights, measure_weighted_costs,
                       minplus_sssp, prepare_weighted, weighted_apsp)
from .wcc import WccResult, wcc, wcc_stats

__all__ = [
    "BackendProfile", "GraphStats", "TuningPlan", "backend_profile",
    "build_plan", "device_fingerprint", "tune_tiles",
    "bfs_level_sync_torch", "bfs_queue_numpy", "bfs_scipy", "DawnState",
    "bovm_msbfs", "bovm_sssp", "bovm_sweep", "COUNTING_FORM_NAMES",
    "MEASURES", "CentralityConfig", "CentralityResult", "CountingResult",
    "betweenness", "brandes_dependencies", "centrality", "closeness",
    "counting_apsp", "counting_apsp_blocks", "eccentricity",
    "eccentricity_sample", "harmonic", "measure_counting_costs", "DENSE",
    "MODEL_AXIS", "SHARDED_FORM_NAMES", "ShardedApspResult",
    "ShardedConfig", "ShardedOperands", "dp_extent", "prepare_sharded",
    "sharded_apsp", "ApspResult", "EngineConfig", "PreparedGraph",
    "SweepStats", "apsp_engine", "apsp_engine_blocks", "choose_direction",
    "frontier_stats", "measure_sweep_costs", "prepare_graph",
    "sweep_costs", "UNREACHED", "WORD", "one_hot_frontier", "pack_bits",
    "packed_width", "popcount", "unpack_bits", "IncrementalSSSP",
    "IncrementalState", "RepairResult", "repair", "sssp_state",
    "WORKLOADS", "JobMismatchError", "JobResult", "run_sweep_job",
    "SweepOptions", "SovmState", "reconstruct_path", "sovm_msbfs",
    "sovm_sssp", "sovm_sweep", "SsspResult", "apsp", "apsp_dense",
    "multi_source", "sssp", "BOOLEAN", "COUNTING", "DIRECTION_NAMES",
    "MIN_LABEL", "PULL", "PUSH", "SEMIRINGS", "SPARSE", "TROPICAL",
    "Semiring", "SweepState", "boolean_forms", "counting_forms",
    "derive_parents", "fused_form", "make_state", "minlabel_form",
    "minplus_candidates", "resolve_fused_steps", "sweep_loop",
    "time_sweep_forms", "tropical_forms", "WEIGHTED_FORM_NAMES",
    "PreparedWeightedGraph", "WeightedApspResult", "WeightedConfig",
    "WeightedResult", "bucketed_sssp", "dijkstra_oracle",
    "expand_integer_weights", "measure_weighted_costs", "minplus_sssp",
    "prepare_weighted", "weighted_apsp", "WccResult", "wcc", "wcc_stats",
]
