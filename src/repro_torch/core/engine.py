"""Direction-optimizing batched APSP engine over the semiring sweep layer.

The port of ``repro/core/engine.py``.  The boolean semiring has three
equivalent sweep forms (``core/sweep.py::boolean_forms``):

  PUSH   — dense boolean product; on the card the bit-packed push kernel
           whose tile-skip tables make its cost proportional to the live
           (frontier x unreached) tile fraction.
  PULL   — bit-packed AND/OR over in-neighbour words (paper's CSC BOVM).
  SPARSE — edge-parallel gather/scatter over CSR lanes (paper Alg. 2).

This module tiles sources into batches, runs each tile through the
shared :func:`repro_torch.core.sweep.sweep_loop` driver, and picks the
form per sweep.  Two selection regimes, as in the JAX package:

  dynamic (kernel path) — at every sweep, the occupancy cost model in
    :func:`sweep_costs` chooses; its signals are the push kernel's own
    occupancy tables.

  calibrated (reference path) — one sweep of each form is *measured* on
    the prepared graph and the argmin direction is fixed for the batch
    (cached per graph).  Wall-clock, so not deterministic.

All three forms operate on identical padded state (frontier (S, n_pad)
int8, dist (S, n_pad) int32).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..graph.csr import CSRGraph, resolve_device
from . import sweep as S
from .frontier import UNREACHED, one_hot_frontier
from .options import SweepOptions
from .sweep import DIRECTION_NAMES, PULL, PUSH, SweepState


@dataclasses.dataclass(frozen=True)
class EngineConfig(SweepOptions):
    """Static boolean-engine parameters (a :class:`SweepOptions`
    subclass).

    Cost-model units:
      c_push   — per dense element in a live (i, j, k) push tile
      c_pull   — per packed word scanned by the pull sweep (one word
                 covers 32 nodes)
      c_sparse — per padded CSR edge lane (gather + scatter)
    """
    c_push: float = 1.0
    c_pull: float = 8.0
    c_sparse: float = 8.0
    pull_chunk: int = 512            # ref pull: nodes per chunk

    _mode_names = DIRECTION_NAMES    # push | pull | sparse


class SweepStats(NamedTuple):
    """Per-sweep occupancy signals (0-d float32 tensors)."""
    live_tile_frac: torch.Tensor   # fraction of (i,j,k) push tiles doing work
    o_occ_frac: torch.Tensor       # fraction of output tiles with unreached


class ApspResult(NamedTuple):
    dist: torch.Tensor              # (S, n) int32, -1 unreachable
    sweeps: int                     # max sweeps over batches
    direction_counts: torch.Tensor  # (3,) int32 — push/pull/sparse sweeps
    edges_touched: torch.Tensor     # 0-d float32 — Eq. 10 work counter


@dataclasses.dataclass
class PreparedGraph:
    """Device-resident operands shared by all three sweep forms.

    The dense push operand and the bit-packed pull operand are O(n_pad^2)
    and built lazily on first use: a run that never dispatches them only
    touches the O(m) CSR lanes.
    """
    graph: CSRGraph
    deg: torch.Tensor     # (n_pad,) float32 out-degrees (0 on pad)
    n_pad: int
    # per-graph sweep-cost measurements, keyed (s, bn, bk, pull_chunk, path)
    cost_cache: dict = dataclasses.field(default_factory=dict, repr=False)
    _adj: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                     repr=False)
    _adj_pull: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                          repr=False)

    @property
    def device(self) -> torch.device:
        return self.deg.device

    @property
    def adj(self) -> torch.Tensor:
        """(n_pad, n_pad) int8 dense adjacency (reference push operand)."""
        if self._adj is None:
            self._adj = self.graph.to_dense_padded(self.n_pad)
        return self._adj

    @property
    def adj_pull(self) -> torch.Tensor:
        """(n_pad, n_pad/32) packed in-neighbour words (kernel operand)."""
        if self._adj_pull is None:
            self._adj_pull = self.graph.to_pull_packed(self.n_pad)
        return self._adj_pull


def prepare_graph(g: CSRGraph, *, align: int = 128,
                  device=None) -> PreparedGraph:
    """Pad-size the graph and build the O(n) degree operand on ``device``
    (``None``: the card); the dense operands materialize lazily."""
    g = g.to(resolve_device(device))
    n_pad = g.n_padded(align)
    deg = torch.zeros(n_pad, dtype=torch.float32, device=g.device)
    deg[: g.n_nodes] = g.out_degrees().to(torch.float32)
    return PreparedGraph(graph=g, deg=deg, n_pad=n_pad)


# --------------------------------------------------------------------------
# heuristic: occupancy stats -> modelled sweep costs -> direction
# --------------------------------------------------------------------------

def frontier_stats(frontier: torch.Tensor, dist: torch.Tensor, *, bs: int,
                   bn: int, bk: int) -> SweepStats:
    """Tile-occupancy fractions — the same tables the push kernel builds.

    live(i, j, k) = f_occ[i, k] & o_occ[i, j]; its mean factorizes as
    E_i[ mean_k f_occ[i, :] * mean_j o_occ[i, :] ], taken in float32 in
    the JAX package's order.
    """
    s, n = frontier.shape
    gi, gj, gk = s // bs, n // bn, n // bk
    f_occ = (frontier.reshape(gi, bs, gk, bk) != 0).any(dim=3).any(dim=1)
    o_occ = (dist < 0).reshape(gi, bs, gj, bn).any(dim=3).any(dim=1)
    f_row = f_occ.to(torch.float32).mean(dim=1)           # (gi,)
    o_row = o_occ.to(torch.float32).mean(dim=1)           # (gi,)
    return SweepStats(live_tile_frac=(f_row * o_row).mean(),
                      o_occ_frac=o_row.mean())


def sweep_costs(stats: SweepStats, *, n_pad: int, s: int, m_pad: int,
                cfg: EngineConfig) -> torch.Tensor:
    """Modelled cost of one sweep in each form -> (3,) float32.  Each
    constant is a Python float rounded to float32 before it scales the
    float32 statistic, as JAX's weak typing does."""
    words = n_pad // 32
    dev = stats.live_tile_frac.device

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    push = f32(cfg.c_push * s * n_pad * n_pad) * stats.live_tile_frac
    pull = f32(cfg.c_pull * s * n_pad * words) * stats.o_occ_frac
    sparse = f32(cfg.c_sparse * s * m_pad)
    return torch.stack([push, pull, sparse])


def choose_direction(stats: SweepStats, *, n_pad: int, s: int, m_pad: int,
                     cfg: EngineConfig) -> int:
    """argmin of the modelled costs -> PUSH | PULL | SPARSE (first index
    on a tie)."""
    return int(torch.argmin(
        sweep_costs(stats, n_pad=n_pad, s=s, m_pad=m_pad, cfg=cfg)))


# --------------------------------------------------------------------------
# per-batch driver (state + loop live in core/sweep.py)
# --------------------------------------------------------------------------

def _run_batch(adj, adj_pull, src_idx, dst_idx, deg, sources: torch.Tensor,
               n_valid: int, *, cfg: EngineConfig, n_real: int, n_pad: int,
               max_steps: int, use_kernel: bool, forced_dir: Optional[int],
               fused_steps: int = 0) -> SweepState:
    s = sources.shape[0]
    m_pad = src_idx.shape[0]
    bs = min(s, 128)
    dev = deg.device

    f0 = one_hot_frontier(sources, n_pad, dtype=torch.int8)
    # padded source rows (>= n_valid) start with an empty frontier and a
    # fully-visited dist: they do no work and add nothing to the counters
    row_ok = (torch.arange(s, device=dev) < n_valid)[:, None]
    f0 = torch.where(row_ok, f0, torch.zeros_like(f0))
    dist0 = torch.where(f0 != 0, 0, UNREACHED).to(torch.int32)
    # pad columns are born "visited" so no sweep form ever discovers them
    col_ok = torch.arange(n_pad, device=dev)[None, :] < n_real
    dist0 = torch.where(row_ok & col_ok, dist0, 0).to(torch.int32)

    forms = S.boolean_forms(adj, adj_pull, src_idx, dst_idx, n_pad=n_pad,
                            s=s, bn=cfg.bn, bk=cfg.bk,
                            pull_chunk=cfg.pull_chunk, use_kernel=use_kernel)

    choose = None
    if forced_dir is None:
        def choose(st: SweepState) -> int:
            stats = frontier_stats(st.frontier, st.dist, bs=bs, bn=cfg.bn,
                                   bk=cfg.bk)
            return choose_direction(stats, n_pad=n_pad, s=s, m_pad=m_pad,
                                    cfg=cfg)

    fused = None
    if fused_steps:  # resolved upstream: kernel path, push pinned
        fused = S.fused_form("boolean", adj_pull, "push", bs=bs,
                             max_sweeps=fused_steps)

    st0 = S.make_state(f0, dist0, n_forms=3)
    return S.sweep_loop(forms, st0, max_steps=max_steps, deg=deg,
                        choose=choose,
                        forced_dir=0 if forced_dir is None else forced_dir,
                        fused=fused, fused_steps=fused_steps)


# --------------------------------------------------------------------------
# calibrated direction choice (reference path)
# --------------------------------------------------------------------------

def measure_sweep_costs(pg: PreparedGraph, s: int, cfg: EngineConfig, *,
                        use_kernel: bool = False
                        ) -> Tuple[float, float, float]:
    """Wall-clock one mid-BFS sweep in each form on this graph, through
    the same forms ``_run_batch`` dispatches.  Cached on the
    PreparedGraph per (batch size, tiles, path)."""
    key = (s, cfg.bn, cfg.bk, cfg.pull_chunk, use_kernel)
    if key in pg.cost_cache:
        return pg.cost_cache[key]
    n_pad = pg.n_pad
    # representative mid-BFS state: ~6% frontier, ~25% visited
    f = torch.zeros((s, n_pad), dtype=torch.int8, device=pg.device)
    f[:, ::17] = 1
    dist = torch.full((s, n_pad), UNREACHED, dtype=torch.int32,
                      device=pg.device)
    dist[:, ::4] = 1
    forms = S.boolean_forms(pg.adj, pg.adj_pull, pg.graph.src, pg.graph.dst,
                            n_pad=n_pad, s=s, bn=cfg.bn, bk=cfg.bk,
                            pull_chunk=cfg.pull_chunk, use_kernel=use_kernel)
    result = S.time_sweep_forms(forms, f, dist)
    pg.cost_cache[key] = result
    return result


# --------------------------------------------------------------------------
# public drivers
# --------------------------------------------------------------------------

def _resolve_kernel(pg: PreparedGraph, cfg: EngineConfig) -> bool:
    """``use_kernel=None`` means kernels iff the operands are on CUDA."""
    return pg.device.type == "cuda" if cfg.use_kernel is None \
        else cfg.use_kernel


def _resolve_direction(pg: PreparedGraph, s: int, cfg: EngineConfig,
                       use_kernel: bool) -> Optional[int]:
    """None -> per-sweep dynamic switch; int -> direction fixed per batch.
    An explicit ``mode=`` wins, then the dynamic switch, then wall-clock
    calibration."""
    if cfg.mode != "auto":
        return DIRECTION_NAMES.index(cfg.mode)
    dynamic = use_kernel if cfg.dynamic is None else cfg.dynamic
    if dynamic:
        return None
    costs = measure_sweep_costs(pg, s, cfg, use_kernel=use_kernel)
    return int(np.argmin(costs))


def apsp_engine_blocks(
        g: Union[CSRGraph, PreparedGraph],
        sources: Optional[Sequence[int]] = None, *,
        config: EngineConfig = EngineConfig(),
) -> Iterator[Tuple[np.ndarray, torch.Tensor, SweepState]]:
    """Stream (source_ids, dist_rows, raw_sweep_state) one source tile at
    a time — the non-materializing form for large n.  A bare CSRGraph is
    prepared on the device it lives on."""
    pg = g if isinstance(g, PreparedGraph) else \
        prepare_graph(g, device=g.device)
    graph = pg.graph
    n = graph.n_nodes
    srcs = np.arange(n, dtype=np.int32) if sources is None else \
        np.asarray(sources, np.int32).reshape(-1)
    if srcs.size == 0:
        raise ValueError("apsp_engine: empty source list")
    if srcs.min() < 0 or srcs.max() >= n:
        raise ValueError(
            f"apsp_engine: sources must be in [0, {n}), got "
            f"[{srcs.min()}, {srcs.max()}]")
    use_kernel = _resolve_kernel(pg, config)
    max_steps = config.max_steps or n
    B = config.source_batch
    forced_dir = _resolve_direction(pg, B, config, use_kernel)
    # fused multi-sweep blocks only exist on the kernel push path
    fused_steps = 0
    if config.fused_steps and forced_dir in (None, PUSH):
        fused_steps = S.resolve_fused_steps(
            "boolean", "push", fused_steps=config.fused_steps,
            max_steps=max_steps, use_kernel=use_kernel, n_pad=pg.n_pad,
            bs=min(B, 128)) or 0
        if fused_steps:
            forced_dir = PUSH   # fused blocks pin one direction
    # only materialize the O(n_pad^2) operands the resolved direction can
    # dispatch: the kernel path runs both dense directions (and the fused
    # block) off the packed operand; the dense int8 adjacency only feeds
    # the reference push
    adj = pg.adj if (forced_dir in (None, PUSH) and not use_kernel) else None
    adj_pull = pg.adj_pull if (
        forced_dir in (None, PULL)
        or (forced_dir in (None, PUSH) and use_kernel)) else None
    for lo in range(0, len(srcs), B):
        block = srcs[lo: lo + B]
        valid = len(block)
        padded = np.zeros(B, np.int64)
        padded[:valid] = block
        st = _run_batch(adj, adj_pull, graph.src, graph.dst, pg.deg,
                        torch.from_numpy(padded).to(pg.device), valid,
                        cfg=config, n_real=n, n_pad=pg.n_pad,
                        max_steps=max_steps, use_kernel=use_kernel,
                        forced_dir=forced_dir, fused_steps=fused_steps)
        yield block, st.dist[:valid, :n], st


def apsp_engine(g: Union[CSRGraph, PreparedGraph],
                sources: Optional[Sequence[int]] = None, *,
                config: EngineConfig = EngineConfig()) -> ApspResult:
    """Materialized batched APSP with per-sweep direction optimization.

    Returns distances for every requested source (default: all nodes),
    plus sweep/direction/work counters aggregated over source tiles
    (``edges_touched`` as a float32 running sum, like the JAX engine).
    """
    rows = []
    sweeps = 0
    counts = [0, 0, 0]
    touched = None
    for _, dist, st in apsp_engine_blocks(g, sources, config=config):
        rows.append(dist)
        sweeps = max(sweeps, st.step)
        counts = [a + b for a, b in zip(counts, st.dir_counts)]
        touched = st.edges_touched if touched is None \
            else touched + st.edges_touched
    return ApspResult(dist=torch.cat(rows, dim=0), sweeps=sweeps,
                      direction_counts=torch.tensor(counts,
                                                    dtype=torch.int32),
                      edges_touched=touched)
