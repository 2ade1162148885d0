"""The port's engine core: frontier packing, options, the sweep layer,
the batched boolean APSP engine, the single-source drivers and the
counting engine with centrality."""
from .bovm import DawnState, bovm_msbfs, bovm_sssp, bovm_sweep
from .centrality import (MEASURES, CentralityConfig, CentralityResult,
                         CountingResult, betweenness, brandes_dependencies,
                         centrality, closeness, counting_apsp,
                         counting_apsp_blocks, eccentricity,
                         eccentricity_sample, harmonic,
                         measure_counting_costs)
from .engine import (ApspResult, EngineConfig, PreparedGraph, SweepStats,
                     apsp_engine, apsp_engine_blocks, choose_direction,
                     frontier_stats, measure_sweep_costs, prepare_graph,
                     sweep_costs)
from .frontier import (UNREACHED, WORD, one_hot_frontier, pack_bits,
                       packed_width, popcount, unpack_bits)
from .options import SweepOptions
from .sovm import (SovmState, reconstruct_path, sovm_msbfs, sovm_sssp,
                   sovm_sweep)
from .sssp import SsspResult, apsp, apsp_dense, multi_source, sssp
from .sweep import (BOOLEAN, COUNTING, DIRECTION_NAMES, PULL, PUSH, SPARSE,
                    Semiring, SweepState, boolean_forms, counting_forms,
                    derive_parents, fused_form, make_state,
                    resolve_fused_steps, sweep_loop, time_sweep_forms)
