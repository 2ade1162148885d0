"""The port's boolean engine core: frontier packing, options, the sweep
layer and the batched APSP engine."""
from .engine import (ApspResult, EngineConfig, PreparedGraph, SweepStats,
                     apsp_engine, apsp_engine_blocks, choose_direction,
                     frontier_stats, measure_sweep_costs, prepare_graph,
                     sweep_costs)
from .frontier import (UNREACHED, WORD, one_hot_frontier, pack_bits,
                       packed_width, popcount, unpack_bits)
from .options import SweepOptions
from .sweep import (BOOLEAN, DIRECTION_NAMES, PULL, PUSH, SPARSE, Semiring,
                    SweepState, boolean_forms, derive_parents, fused_form,
                    make_state, resolve_fused_steps, sweep_loop,
                    time_sweep_forms)
